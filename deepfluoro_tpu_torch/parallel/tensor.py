"""Tensor parallelism over a 'model' axis (JAX counterpart: ``deepfluoro_
tpu/parallel/sharding.py::_tp_leaf_sharding``, ``tp_state_shardings`` and
``make_tp_train_step``, where GSPMD partitions a channel-sharded state).

The shard rule, leaf for leaf as JAX's: a parameter or buffer is cut along
its output-channel dimension over the T ranks of the axis when T divides
that dimension (and it holds at least T channels); otherwise every rank
holds all of it. The output-channel dimension is dim 0 of a ``Conv2d``
weight and dim 1 of a ``ConvTranspose2d`` weight (flax's trailing
``cout``), dim 0 of biases and of BatchNorm's weight, bias and running
statistics; the optimizer's per-parameter buffers (momentum) follow their
parameter; scalars (``num_batches_tracked``, Adam's step) stay whole. So
the recipe's 7-class head and the 21-channel first landmark 1x1 stay
whole at T = 2 and 4, and its 14-channel last landmark 1x1 is cut at T =
2 but not at 4. ``channel_dims`` gives the rule, ``shard_channels`` cuts a
model's leaves to this rank's shares, ``slice_state`` and
``slice_optimizer_state`` cut whole state dicts (a resume, a sharded
restore) and ``gather_state`` puts a rank's back together (a checkpoint).

The forward (``models/unet.py``): a channel-sharded convolution computes
its rank's output channels from its whole input; ReLU and BatchNorm run
on the shard (statistics over 'data' as without the axis); the activation
is gathered over 'model' (``gather_channels``) before the next layer that
needs every channel: the next convolution, a skip concatenation, a whole
head. A sharded convolution takes its input through ``enter``, an
identity whose backward sums the ranks' partial input gradients, so the
gradient of every whole activation is the same on every rank (whole
heads give whole gradients, sharded convolutions partial ones);
``gather_channels``' backward then keeps this rank's channels. Whole
leaves get the same gradient on every rank and need no reduction over
'model'; the gradient average spans 'data' only. Every collective is an
``all_reduce`` (a gather fills a zero buffer), as in
``parallel/sharding.py``, so gloo ranks can share one card.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn as nn

from deepfluoro_tpu_torch.parallel.mesh import Axis


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        c = x.shape[1]
        ctx.rows = slice(axis.index * c, (axis.index + 1) * c)
        buf = x.new_zeros((x.shape[0], c * axis.size) + tuple(x.shape[2:]))
        buf[:, ctx.rows] = x
        dist.all_reduce(buf, group=axis.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.rows], None


def enter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, the whole input of a channel-sharded convolution over
    ``axis``: its backward sums the ranks' partial gradients."""
    return x if axis.size == 1 else _Enter.apply(x, axis.group)


def gather_channels(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's channels of ``x`` (B, C/T, ...) over ``axis``, in rank
    order: (B, C, ...); its backward keeps this rank's channels."""
    return x if axis.size == 1 else _Gather.apply(x, axis)


def channel_dims(model: nn.Module) -> dict:
    """{state_dict key: (output-channel dim or None, output channels)} of
    every parameter and buffer of ``model``'s convolutions and
    BatchNorms, taken while the model is whole."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.ConvTranspose2d):
            dims, c = {"weight": 1, "bias": 0}, mod.out_channels
        elif isinstance(mod, nn.Conv2d):
            dims, c = {"weight": 0, "bias": 0}, mod.out_channels
        elif isinstance(mod, nn.BatchNorm2d):
            dims, c = dict.fromkeys(("weight", "bias", "running_mean", "running_var"), 0), mod.num_features
        else:
            continue
        for k, _ in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            out[prefix + "." + k if prefix else k] = (dims.get(k), c)
    return out


def is_cut(rule, size: int) -> bool:
    """Whether a leaf of ``rule`` (dim, channels) is cut over ``size``
    ranks."""
    dim, c = rule
    return size > 1 and dim is not None and c >= size and c % size == 0


def _cut(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n).clone()


def shard_channels(model: nn.Module, axis: Axis) -> dict:
    """Cut ``model``'s leaves to this rank's shares over ``axis`` by the
    rule, in place, and mark each cut convolution with ``channels =
    axis``; call it before the optimizer is built. Returns
    the rule (``channel_dims`` of the whole model), which ``slice_state``
    and ``gather_state`` take; the model keeps it and the axis
    (``channel_rule``, ``channel_axis``: ``train/sharded_checkpoint.py``
    reads them). A size-1 axis cuts nothing."""
    dims = channel_dims(model)
    model.channel_rule, model.channel_axis = dims, axis
    if axis.size == 1:
        return dims
    for prefix, mod in model.named_modules():
        if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d)):
            continue
        key = (prefix + ".") if prefix else ""
        if not is_cut(dims[key + "weight"], axis.size):
            continue
        for k, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, k, nn.Parameter(_cut(p.data, dims[key + k][0], axis), requires_grad=p.requires_grad))
        for k, b in list(mod.named_buffers(recurse=False)):
            if dims[key + k][0] is not None:
                setattr(mod, k, _cut(b, 0, axis))
        if isinstance(mod, nn.BatchNorm2d):
            mod.num_features //= axis.size
        else:
            mod.channels = axis
            mod.out_channels //= axis.size
    return dims


def slice_state(state: dict, dims: dict, axis: Axis) -> dict:
    """A whole model state dict cut to this rank's shares over ``axis``."""
    return {k: _cut(v, dims[k][0], axis) if k in dims and is_cut(dims[k], axis.size) else v for k, v in state.items()}


def _param_rules(model_keys, dims):
    return [dims.get(k, (None, 0)) for k in model_keys]


def slice_optimizer_state(state: dict, param_keys, dims: dict, axis: Axis) -> dict:
    """A whole optimizer state dict (``torch.optim``'s: per-parameter
    entries keyed by the parameter's position, ``param_keys`` the state
    dict keys of the parameters in order) cut like its parameters."""
    out = copy.copy(state)
    rules = _param_rules(param_keys, dims)
    out["state"] = {}
    for i, entry in state.get("state", {}).items():
        rule = rules[int(i)]
        out["state"][i] = {k: _cut(v, rule[0], axis) if torch.is_tensor(v) and v.ndim and is_cut(rule, axis.size)
                           else v for k, v in entry.items()}
    return out


def _gather_all(parts, axis: Axis):
    """Whole tensors of (local tensor, dim) pairs, one ``all_reduce`` per
    dtype of zero buffers filled with each rank's share."""
    out = [None] * len(parts)
    by_dtype = {}
    for j, (t, dim) in enumerate(parts):
        by_dtype.setdefault(t.dtype, []).append(j)
    for dtype, js in by_dtype.items():
        fulls = []
        for j in js:
            t, dim = parts[j]
            shape = list(t.shape)
            shape[dim] *= axis.size
            full = t.new_zeros(shape)
            full.narrow(dim, axis.index * t.shape[dim], t.shape[dim]).copy_(t)
            fulls.append(full)
        flat = torch.cat([f.reshape(-1) for f in fulls])
        dist.all_reduce(flat, group=axis.group)
        offset = 0
        for j, f in zip(js, fulls):
            out[j] = flat[offset : offset + f.numel()].view_as(f)
            offset += f.numel()
    return out


def gather_state(model_state: dict, dims: dict, axis: Axis, optimizer_state: dict | None = None, param_keys=()):
    """The whole model state dict (and optimizer state dict) of which
    this rank holds ``model_state`` (and ``optimizer_state``) cut over
    ``axis``: every rank calls it; one ``all_reduce`` per dtype. Returns
    (model state, optimizer state or None)."""
    if axis.size == 1:
        return model_state, optimizer_state
    parts, where = [], []
    for k, v in model_state.items():
        if k in dims and is_cut(dims[k], axis.size):
            parts.append((v.detach(), dims[k][0]))
            where.append(("model", k, None))
    rules = _param_rules(param_keys, dims)
    if optimizer_state is not None:
        for i, entry in optimizer_state.get("state", {}).items():
            rule = rules[int(i)]
            for k, v in entry.items():
                if torch.is_tensor(v) and v.ndim and is_cut(rule, axis.size):
                    parts.append((v, rule[0]))
                    where.append(("opt", i, k))
    fulls = _gather_all(parts, axis)
    model_out = dict(model_state)
    opt_out = None
    if optimizer_state is not None:
        opt_out = copy.copy(optimizer_state)
        opt_out["state"] = {i: dict(e) for i, e in optimizer_state.get("state", {}).items()}
    for (kind, a, b), full in zip(where, fulls):
        if kind == "model":
            model_out[a] = full
        else:
            opt_out["state"][a][b] = full
    return model_out, opt_out
