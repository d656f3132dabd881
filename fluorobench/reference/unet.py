"""The joint segmentation and landmark-heatmap U-Net as plain functions of
a state dict (reference train_test_code/unet.py:40-260; SURVEY.md §2).

Keys are the reference's module names (``down_path.{i}.block.{j}``,
``downsample_convs.{i}``, ``up_path.{k}.up``, ``up_path.{k}.conv_block``,
``seg_conv``, ``lands_1x1.{j}``), the layout of its ``.pt`` checkpoints.
Per level: [3x3 'same' convolution -> ReLU -> BatchNorm] x 2 plus a 1x1
residual shortcut; learned 2x2 stride-2 downsampling between levels (the
deepest downsampling convolution exists and is unused); 2x2 stride-2
transposed convolutions up, each concatenated with the center-cropped skip
as [up, skip]; a 1x1 class head with softmax; the landmark head takes
[features, class logits] through two 1x1 convolutions with no bias.

BatchNorm in training mode normalizes by the batch's mean and biased
variance (eps 1e-5); in eval mode by the running statistics.

``Numerics`` says how the arithmetic runs: a dtype (float64 for the judge,
float32 for calibration) and ``tf32``, the control's precision: on a card
cuDNN's and cuBLAS's TF32 switch is on; on the CPU each convolution's
operands are rounded to TF32's 10-bit mantissa first (in the forward
only: a stand-in for the tests, which have no card).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Numerics:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    @contextlib.contextmanager
    def scope(self):
        """TF32 on the card for the block, and off again after it."""
        old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10 explicit mantissa
    bits (the low 13 of float32's 23 cleared); gradients pass through."""
    x = x.float()
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def _conv(num: Numerics, x, w, b=None, stride=1, padding=0, transposed=False):
    if num.tf32 and x.device.type == "cpu":
        x, w = round_tf32(x), round_tf32(w)
        b = None if b is None else b.float()
    if transposed:
        return F.conv_transpose2d(x, w, b, stride=stride)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def center_crop(t: torch.Tensor, hw) -> torch.Tensor:
    """Trailing two dims cut to ``hw`` from offset floor((src - dst) / 2)
    (reference util.py:92-114)."""
    r0 = (t.shape[-2] - hw[0]) // 2
    c0 = (t.shape[-1] - hw[1]) // 2
    return t[..., r0 : r0 + hw[0], c0 : c0 + hw[1]]


def _batch_norm(p, key, x, train: bool, stats: dict | None, eps=1e-5):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[key] = (mean.detach(), var.detach())
    else:
        mean, var = p[key + ".running_mean"], p[key + ".running_var"]
    inv = torch.rsqrt(var + eps)
    return (x - mean[:, None, None]) * (inv * p[key + ".weight"])[:, None, None] + p[key + ".bias"][:, None, None]


def _block(p, key, x, num, train, stats, block_depth):
    out = x
    for d in range(block_depth):
        conv = "{}.block.{}".format(key, 3 * d)
        out = torch.relu(_conv(num, out, p[conv + ".weight"], p[conv + ".bias"], padding=1))
        out = _batch_norm(p, "{}.block.{}".format(key, 3 * d + 2), out, train, stats)
    res = key + ".res_conv1x1"
    if res + ".weight" in p:
        out = out + center_crop(_conv(num, x, p[res + ".weight"], p[res + ".bias"]), out.shape[-2:])
    return out


def forward(p: dict, x: torch.Tensor, cfg: dict, num: Numerics, train: bool = False, stats: dict | None = None):
    """(class probabilities (B, C, H', W'), heatmaps (B, L, H', W')) of
    ``x`` (B, 1, H, W) under the state dict ``p`` (tensors in
    ``num.dtype``). With ``train`` BatchNorm takes batch statistics, which
    ``stats`` collects per layer key as (mean, biased variance)."""
    depth, nb = cfg["depth"], cfg["block_depth"]
    skips = []
    for i in range(depth):
        x = _block(p, "down_path.{}".format(i), x, num, train, stats, nb)
        if i != depth - 1:
            skips.append(x)
            key = "downsample_convs.{}".format(i)
            x = _conv(num, x, p[key + ".weight"], p[key + ".bias"], stride=2)
    for k in range(depth - 1):
        key = "up_path.{}".format(k)
        up = _conv(num, x, p[key + ".up.weight"], p[key + ".up.bias"], stride=2, transposed=True)
        x = torch.cat([up, center_crop(skips[-k - 1], up.shape[-2:])], dim=1)
        x = _block(p, key + ".conv_block", x, num, train, stats, nb)
    logits = _conv(num, x, p["seg_conv.weight"])
    seg = torch.softmax(logits, dim=1)
    h = torch.cat([x, logits], dim=1)
    j = 0
    while "lands_1x1.{}.weight".format(j) in p:
        h = _conv(num, h, p["lands_1x1.{}.weight".format(j)])
        j += 1
    return seg, h
