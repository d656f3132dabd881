"""Weights made from the seed, on the device, in a few large calls.

Every convolution weight and bias is uniform in +-1/sqrt(fan_in) (fan_in =
input channels x kernel area: torch's default initialization of a
convolution), BatchNorm scales 1 and shifts 0, running means 0 and
variances 1. One ``torch.rand`` over all parameters at once, on a
``torch.Generator`` of the device. The benchmark hands the same state dict
to the program and to the reference.

``calibrate`` sets each BatchNorm's running statistics to the batch mean
and biased variance of a few frames through the reference's training-mode
forward, so that an eval-mode member gives labels and heatmaps that are
not degenerate.
"""

from __future__ import annotations

import math

import torch

from fluorobench.reference import unet


def make_state(shapes: dict, seed: int, device, dtype=torch.float32) -> dict:
    """A state dict with the given ``shapes`` (name -> shape, the
    reference's module names)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    conv = [k for k in shapes if k.endswith((".weight", ".bias")) and not _is_bn(k, shapes)]
    sizes = [math.prod(shapes[k]) for k in conv]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=dtype) * 2.0 - 1.0
    state, off = {}, 0
    for k, n in zip(conv, sizes):
        w = shapes[k.rsplit(".", 1)[0] + ".weight"]
        fan_in = math.prod(w[1:])
        state[k] = (flat[off : off + n] / math.sqrt(fan_in)).reshape(shapes[k])
        off += n
    for k, shape in shapes.items():
        if k in state:
            continue
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith((".weight", ".running_var")):
            state[k] = torch.ones(shape, dtype=dtype, device=device)
        else:
            state[k] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def _is_bn(key: str, shapes: dict) -> bool:
    return key.rsplit(".", 1)[0] + ".running_mean" in shapes


@torch.no_grad()
def calibrate(state: dict, x: torch.Tensor, cfg: dict) -> dict:
    """``state`` with every BatchNorm's running statistics taken from the
    float32 training-mode forward of ``x`` (B, 1, H, W)."""
    stats = {}
    unet.forward(state, x.float(), cfg, unet.Numerics(torch.float32), train=True, stats=stats)
    out = dict(state)
    for key, (mean, var) in stats.items():
        out[key + ".running_mean"] = mean.clone()
        out[key + ".running_var"] = var.clone()
    return out
