"""Post-training int8 (w8a8) inference for the joint seg + landmark U-Net
(JAX counterpart: ``deepfluoro_tpu/infer/quantized.py``; no reference
counterpart, the reference infers in float32).

- Every convolution's weight is quantized per output channel to int8 and
  every convolution's input per tensor, with a static scale calibrated on
  a few batches; the convolution runs s8 x s8 -> s32
  (``ops/int8_conv.py``: ``torch._int_mm`` on the int8 tensor cores of a
  card, an exact float64 convolution on the CPU). Everything between the
  convolutions (ReLU, BatchNorm, residual adds, concatenations, pooling,
  the bilinear resize, softmax) stays in the member's float dtype.
- Symmetric quantization, no zero point: ``clip(round(x / scale), -127,
  127)``, round half to even, a true division (on a card the scale is a
  tensor there: torch divides by a CPU scalar as a multiply by its
  reciprocal).

``_Engine`` walks the port's own ``models/unet.py::UNet`` modules, in
one of three modes: ``float`` (a replay of ``UNet.forward`` in eval
mode, within float32 rounding: BatchNorm takes JAX's op order, so that
a card and the CPU compute the same bits), ``calibrate`` (the replay,
recording the absolute maximum of every convolution input) and
``quantized``. Quantization
points carry the JAX package's names (``down_{i}/x{d}``,
``downsample_{i}/x``, ``up_{j}/up_in``, ``up_{j}/conv_block/x{d}``,
``seg/x``, ``lands_block/x{d}``, ``lands_1x1_{i}/x``) and ``quantize_
weights`` keys its parameter paths (``compat/from_jax.py::_entries``),
so both compare key by key with the JAX package's.

A bfloat16 member runs its float pieces in bfloat16 by explicit casts,
as the JAX engine's ``self.dtype`` does (not under ``torch.autocast`` as
``UNet.forward`` does); the dequantized convolution output is float32
until the bias is added.

Typical use::

    scales = calibrate(model, calib_projs)      # a few prepared batches
    qweights = quantize_weights(model)
    seg, heats = quantized_apply(model, qweights, scales, projs)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepfluoro_tpu_torch.compat.from_jax import _entries
from deepfluoro_tpu_torch.infer.ensemble import ensemble_forward
from deepfluoro_tpu_torch.models.unet import UNet, crop_to
from deepfluoro_tpu_torch.ops.int8_conv import gemm_weight, int8_conv2d, int8_conv_transpose2x2
from deepfluoro_tpu_torch.parallel.halo import band_op

_QMAX = 127.0


def _over_qmax(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division on any device."""
    return x / torch.full_like(x, _QMAX)


def _quant_tensor(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric quantization to int8, round half to even, saturating;
    ``x ~ q * scale``. ``x`` is taken to float32 first, as JAX promotes a
    bfloat16 tensor divided by a float32 scale."""
    return torch.clamp(torch.round(x.float() / scale), -_QMAX, _QMAX).to(torch.int8)


def quantize_weight(weight: torch.Tensor, axis: int = 0):
    """Per-output-channel symmetric int8 quantization of a convolution
    weight: ``axis`` 0 for a ``Conv2d`` weight (O, I, kh, kw), 1 for a
    ``ConvTranspose2d`` weight (I, O, kh, kw). Returns (int8 weight of the
    same layout, float32 scale (O,))."""
    dims = tuple(d for d in range(weight.ndim) if d != axis)
    absmax = weight.detach().abs().amax(dim=dims).float()
    scale = _over_qmax(torch.clamp(absmax, min=1e-12))
    shape = [1] * weight.ndim
    shape[axis] = -1
    return _quant_tensor(weight.detach(), scale.view(shape)), scale


def _param_paths(model) -> dict:
    """id(module) -> the JAX package's parameter path of every convolution
    the flax model has (the deepest ``downsample_convs`` conv, which
    forward never uses, has none)."""
    dead = model.downsample_convs[-1] if model.downsample_convs is not None else None
    return {
        id(mod): "/".join(path)
        for _, path, mod in _entries(model)
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)) and mod is not dead
    }


class _Engine:
    """One traversal of ``model`` in ``mode``. A tensor consumed by two
    convolutions (a block input feeding conv_0 and the residual 1x1) is
    quantized once. ``int8_points`` (key -> bool, None for all) selects
    the points that run int8; a point that opts out passes the float
    tensor on and its convolution takes the float path. ``packed`` caches
    the GEMM-ready weights of a card across forwards."""

    def __init__(self, model, mode, scales=None, qweights=None, int8_points=None, packed=None):
        assert mode in ("float", "calibrate", "quantized")
        self.model = model
        self.mode = mode
        self.scales = scales or {}
        self.qweights = qweights or {}
        self.int8_points = int8_points
        self.packed = {} if packed is None else packed
        self.stats: dict[str, torch.Tensor] = {}
        self.dtype = model.dtype
        self.paths = _param_paths(model)

    def qpoint(self, key, x):
        """Mark ``x`` as a convolution input: the float tensor itself, or
        (int8 tensor, scale) in quantized mode."""
        if self.mode == "calibrate":
            self.stats[key] = x.abs().amax().float()
            return x
        if self.mode == "quantized" and (self.int8_points is None or self.int8_points(key)):
            scale = self.scales[key]
            return _quant_tensor(x, scale), scale
        return x

    def _wmat(self, path, wq, transpose):
        if wq.device.type != "cuda":
            return None
        if path not in self.packed:
            self.packed[path] = gemm_weight(wq, transpose)
        return self.packed[path]

    def _int8(self, mod, xrep, conv_fn, transpose):
        """``conv_fn`` (s8 x s8 -> s32) of the int8 input with ``mod``'s
        int8 weight, dequantized as ``y * (xscale * wscale)`` in float32,
        then the bias, then the member's dtype (JAX's order)."""
        xq, xscale = xrep
        path = self.paths[id(mod)]
        wq, wscale = self.qweights[path]
        y = conv_fn(xq, wq, self._wmat(path, wq, transpose)).float() * (xscale * wscale).view(1, -1, 1, 1)
        if mod.bias is not None:
            y = y + mod.bias.float().view(1, -1, 1, 1)
        return y.to(self.dtype)

    def conv(self, mod: nn.Conv2d, xrep, plan=None):
        """``mod``'s convolution (stride, padding and padding mode read from
        it) on the int8 path for an (int8, scale) input, else in float. On
        a band of rows (a ``Conv3x3``'s own plan, or ``plan``: a stride-2
        downsampling's) it convolves its window unpadded in rows
        (``parallel/halo.py::band_op``); the window's rows travel as int8
        where the input is quantized (one scale per tensor)."""
        plan = getattr(mod, "rows", None) or plan
        ph, pw = mod.padding
        padding = (ph, pw) if getattr(mod, "rows", None) is None else (0, pw)
        k = mod.kernel_size[0]
        if isinstance(xrep, tuple):
            return self._int8(mod, xrep, lambda xq, wq, wmat: band_op(lambda w: int8_conv2d(
                w, wq, mod.stride, padding, mod.padding_mode, wmat), xq, plan, k), False)
        b = None if mod.bias is None else mod.bias.to(self.dtype)

        def fn(x):
            p = padding
            if mod.padding_mode == "circular":
                x = F.pad(x, (p[1], p[1], p[0], p[0]), mode="circular")
                p = 0
            return F.conv2d(x, mod.weight.to(self.dtype), b, mod.stride, p)

        return band_op(fn, xrep.to(self.dtype), plan, k)

    def conv_transpose(self, mod: nn.ConvTranspose2d, xrep, plan=None):
        if isinstance(xrep, tuple):
            return self._int8(mod, xrep, lambda xq, wq, wmat: band_op(
                lambda w: int8_conv_transpose2x2(w, wq, wmat), xq, plan), True)
        return band_op(lambda x: F.conv_transpose2d(x, mod.weight.to(self.dtype), mod.bias.to(self.dtype),
                                                    mod.stride), xrep.to(self.dtype), plan)

    def batch_norm(self, bn: nn.BatchNorm2d, x):
        """Inference-mode BatchNorm on the running statistics in JAX's op
        order, each op rounded to the member's dtype: ``mul = rsqrt(var +
        eps) * scale``, then ``(x - mean) * mul + bias``, each a separate
        elementwise pass. A card and the CPU then compute the same bits: a
        fused ``F.batch_norm`` rounds otherwise on each, and so does a
        float32 reciprocal square root (the card's differed by one ulp in
        a channel), so it is taken in float64, where both devices round
        correctly, and rounded once. An activation one ulp apart can
        quantize to the next integer, which the following layers spread:
        with ``F.batch_norm`` a third of the 8x net's last int8 inputs
        differed between card and CPU."""
        dt = self.dtype
        inv = (1.0 / torch.sqrt((bn.running_var.to(dt) + bn.eps).double())).to(dt)
        mul = (inv * bn.weight.to(dt)).view(1, -1, 1, 1)
        return (x - bn.running_mean.to(dt).view(1, -1, 1, 1)) * mul + bn.bias.to(dt).view(1, -1, 1, 1)

    def conv_block(self, name, blk, x):
        out, in_rep, d = x, None, 0
        for layer in blk.block:
            if isinstance(layer, nn.Conv2d):
                rep = self.qpoint("{}/x{}".format(name, d), out)
                if d == 0:
                    in_rep = rep  # the residual 1x1 consumes the same tensor
                out = self.conv(layer, rep)
                d += 1
            elif isinstance(layer, nn.ReLU):
                out = F.relu(out)
            else:
                out = self.batch_norm(layer, out)
        if blk.res_conv1x1 is not None:
            out = out + crop_to(self.conv(blk.res_conv1x1, in_rep), blk.res_rows, out.shape[-2:])
        return out

    def up_block(self, name, up, x, bridge):
        if isinstance(up.up, nn.ConvTranspose2d):
            rep = self.qpoint("{}/up_in".format(name), x)
            y = self.conv_transpose(up.up, rep, up.up_rows)
        else:
            y = band_op(up.up[0], x.to(self.dtype), up.up_rows)
            y = self.conv(up.up[1], self.qpoint("{}/up_in".format(name), y))
        cat = torch.cat([y, crop_to(bridge, up.bridge_rows, y.shape[-2:])], dim=1)
        return self.conv_block("{}/conv_block".format(name), up.conv_block, cat)

    def forward(self, x):
        m = self.model
        x = x.to(self.dtype)
        blocks = []
        depth = len(m.down_path)
        for i, down in enumerate(m.down_path):
            x = self.conv_block("down_{}".format(i), down, x)
            if i != depth - 1:
                blocks.append(x)
                if m.max_pool:
                    x = band_op(lambda t: F.max_pool2d(t, 2), x, m.pool_rows[i], 2)
                else:
                    x = self.conv(m.downsample_convs[i], self.qpoint("downsample_{}/x".format(i), x), m.pool_rows[i])
        for j, up in enumerate(m.up_path):
            x = self.up_block("up_{}".format(j), up, x, blocks[-j - 1])

        seg_logits = self.conv(m.seg_conv, self.qpoint("seg/x", x))
        seg = torch.softmax(seg_logits.float(), dim=1) if m.do_soft_max else seg_logits.float()
        if m.num_lands <= 0:
            return seg

        feat = x
        for d, conv in enumerate(m.lands_block):
            feat = self.conv(conv, self.qpoint("lands_block/x{}".format(d), feat))
        h = torch.cat([feat, crop_to(seg_logits, m.lands_rows, feat.shape[-2:]).to(self.dtype)], dim=1)
        for i, conv in enumerate(m.lands_1x1):
            h = self.conv(conv, self.qpoint("lands_1x1_{}/x".format(i), h))
        return seg, h.float()


def make_level_filter(float_levels: int, depth: int):
    """The ``int8_points`` predicate that keeps the finest ``float_levels``
    U-Net levels in float (the hybrid mode): ``down_i`` and
    ``downsample_i`` run at level i, ``up_j`` at level depth - 2 - j, the
    seg and landmark heads at level 0. None (every point int8) for
    ``float_levels <= 0``."""
    if float_levels <= 0:
        return None

    def level_of(key: str) -> int:
        head = key.split("/", 1)[0]
        for prefix in ("downsample_", "down_"):
            if head.startswith(prefix):
                return int(head[len(prefix):])
        if head.startswith("up_"):
            return depth - 2 - int(head[len("up_"):])
        return 0

    return lambda key: level_of(key) >= float_levels


@torch.no_grad()
def float_apply(model, x):
    """The float replay of the traversal: ``model(x)`` in eval mode within
    float32 rounding for a float32 member, so the int8 graph's structure
    is pinned to the module."""
    return _Engine(model, "float").forward(x)


@torch.no_grad()
def calibration_stats(model, x):
    """One calibration forward: (outputs, {point: absmax float32})."""
    eng = _Engine(model, "calibrate")
    return eng.forward(x), eng.stats


def calibrate(model, batches) -> dict:
    """Static per-tensor activation scales {point: float32 0-dim tensor on
    the model's device}: the absolute maximum over ``batches`` (prepared
    (B, 1, H, W) inputs, what the float forward consumes) over 127."""
    agg: dict[str, torch.Tensor] = {}
    for x in batches:
        for k, v in calibration_stats(model, x)[1].items():
            agg[k] = torch.maximum(agg[k], v) if k in agg else v
    return {k: _over_qmax(torch.clamp(v, min=1e-12)) for k, v in agg.items()}


@torch.no_grad()
def quantize_weights(model) -> dict:
    """{JAX parameter path: (int8 weight in the module's layout, float32
    scale per output channel)} for every convolution; biases and
    BatchNorm stay float and are read from the module."""
    paths = _param_paths(model)
    return {
        paths[id(mod)]: quantize_weight(mod.weight, axis=1 if isinstance(mod, nn.ConvTranspose2d) else 0)
        for _, _, mod in _entries(model)
        if id(mod) in paths
    }


@torch.no_grad()
def quantized_apply(model, qweights, scales, x, int8_points=None, packed=None):
    """The int8 forward. ``scales`` from ``calibrate``, ``qweights`` from
    ``quantize_weights``, both on ``x``'s device; ``int8_points`` from
    ``make_level_filter``; ``packed`` an optional dict in which a card's
    GEMM-ready weights are kept between calls."""
    return _Engine(model, "quantized", scales, qweights, int8_points, packed).forward(x)


class QuantizedMember(NamedTuple):
    """One ensemble member's int8 state: the module (its biases and
    BatchNorm), int8 weights, activation scales, and the card's
    GEMM-ready weights, filled at the first forward."""

    model: nn.Module
    qweights: dict
    scales: dict
    packed: dict


def prepare_quantized_ensemble(models, calib_inputs) -> list:
    """Calibrate and weight-quantize every member on the prepared inputs
    ``calib_inputs`` ((B, 1, H, W), as the float ensemble consumes them).
    Returns one ``QuantizedMember`` per member: the port runs K eager
    forwards, so nothing is stacked."""
    calib_inputs = list(calib_inputs)
    return [QuantizedMember(m.eval(), quantize_weights(m), calibrate(m, calib_inputs), {}) for m in models]


def member_forwards(members, int8_points=None) -> list:
    """One callable per member: ``x -> its int8 forward``, what
    ``infer/ensemble.py``'s member mean calls in place of a module."""
    return [
        functools.partial(quantized_apply, m.model, m.qweights, m.scales, int8_points=int8_points, packed=m.packed)
        for m in members
    ]


def int8_forwards(models, calib_inputs, float_levels: int = 0) -> list:
    """``member_forwards`` of ``models`` calibrated and weight-quantized on
    ``calib_inputs``, the finest ``float_levels`` levels in float: what
    the ensemble and full-res loops run in place of the modules."""
    if not all(isinstance(m, UNet) for m in models):
        raise ValueError("int8 inference quantizes U-Net members only; {} runs in float32".format(
            next(type(m).__name__ for m in models if not isinstance(m, UNet))))
    int8_points = make_level_filter(float_levels, len(models[0].down_path))
    return member_forwards(prepare_quantized_ensemble(models, calib_inputs), int8_points)


def quantized_ensemble_forward(members, proj: torch.Tensor, orig_hw, num_lands: int, int8_points=None):
    """The int8 twin of ``infer/ensemble.py::ensemble_forward``: (mean seg,
    mean per-image min-max heats or None, uint8 argmax labels) of the
    members' int8 forwards of ``proj``, averaged as the float ensemble."""
    return ensemble_forward(member_forwards(members, int8_points), proj, orig_hw, num_lands)
