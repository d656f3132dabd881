"""Row halos of a row-sharded frame (JAX counterpart: ``deepfluoro_tpu/
parallel/halo.py``, where ``shard_map`` and ``ppermute`` trade the rows).

A frame cut into bands of rows over the 'spatial' axis (``parallel/
mesh.py::RowShard``), one band per process, convolves band by band once
each band carries ``halo`` rows of its neighbours above and below. The
bands at the frame's top and bottom fill their outer halo by ``mode``:

  'reflect'  the band's own edge rows mirrored (JAX's ``sharded_conv2d``,
             a reflect-padded convolution);
  'zeros'    zeros (the U-Net's zero-padded convolutions, the recipe);
  'circular' the rows of the band at the frame's other end (the first and
             last bands trade with each other).

``halo_exchange`` is an autograd function: its backward sends each halo
row's gradient back to the band that owns the row (and adds a reflected
halo's to the rows it mirrors). The rows travel by point-to-point sends
and receives, posted together with ``batch_isend_irecv``: on NCCL as they
are, on gloo through host copies (gloo sends host memory only). They
travel in their own dtype: under bfloat16 autocast, the dtype of the
activation that owns them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepfluoro_tpu_torch.parallel.mesh import Axis

MODES = ("reflect", "zeros", "circular")


def _neighbours(axis: Axis, mode: str):
    """(global rank above, global rank below), None at a frame edge that
    exchanges nothing."""
    i, n = axis.index, axis.size
    up = i - 1 if i > 0 else (n - 1 if mode == "circular" else None)
    down = i + 1 if i < n - 1 else (0 if mode == "circular" else None)
    return (None if up is None else axis.ranks[up]), (None if down is None else axis.ranks[down])


def _trade(axis: Axis, mode: str, to_up: torch.Tensor, to_down: torch.Tensor):
    """Send ``to_up`` to the band above and ``to_down`` to the band below;
    return (what the band above sent down, what the band below sent up),
    None at an edge without a neighbour. With two bands in a circle both
    neighbours are one process: sends and receives are posted in an order
    that pairs them (up-send with the peer's down-receive)."""
    up, down = _neighbours(axis, mode)
    backend = dist.get_backend(axis.group)
    stage = backend != "nccl" and to_up.is_cuda
    dev = to_up.device

    def wire(t):
        t = t.contiguous()
        return t.cpu() if stage else t

    ops, got = [], {}
    if up is not None:
        ops.append(dist.P2POp(dist.isend, wire(to_up), up, axis.group))
    if down is not None:
        ops.append(dist.P2POp(dist.isend, wire(to_down), down, axis.group))
    if down is not None:
        got["down"] = torch.empty(to_up.shape, dtype=to_up.dtype, device="cpu" if stage else dev)
        ops.append(dist.P2POp(dist.irecv, got["down"], down, axis.group))
    if up is not None:
        got["up"] = torch.empty(to_down.shape, dtype=to_down.dtype, device="cpu" if stage else dev)
        ops.append(dist.P2POp(dist.irecv, got["up"], up, axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    back = lambda k: None if k not in got else got[k].to(dev)  # noqa: E731
    return back("up"), back("down")


def _single(mode: str, top: torch.Tensor, bot: torch.Tensor):
    """One band in a circle is its own neighbour."""
    return (bot, top) if mode == "circular" else (None, None)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, axis, mode):
        ctx.halo, ctx.axis, ctx.mode = halo, axis, mode
        top, bot = x[:, :, :halo], x[:, :, -halo:]
        if axis.size > 1:
            above, below = _trade(axis, mode, top, bot)
        else:
            above, below = _single(mode, top, bot)
        if above is None:
            above = x[:, :, 1 : halo + 1].flip(2) if mode == "reflect" else torch.zeros_like(top)
        if below is None:
            below = x[:, :, -halo - 1 : -1].flip(2) if mode == "reflect" else torch.zeros_like(bot)
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, grad):
        h, axis, mode = ctx.halo, ctx.axis, ctx.mode
        g_top, g_bot = grad[:, :, :h], grad[:, :, -h:]
        g = grad[:, :, h:-h].clone()
        if axis.size > 1:
            # a top halo row came from the band above: its gradient goes back up
            from_above, from_below = _trade(axis, mode, g_top, g_bot)
        else:
            from_above, from_below = _single(mode, g_top, g_bot)
        # at the frame's edges a reflected halo's gradient goes to the rows
        # it mirrors, a zero halo's nowhere
        if from_above is not None:
            g[:, :, :h] += from_above
        elif mode == "reflect":
            g[:, :, 1 : h + 1] += g_top.flip(2)
        if from_below is not None:
            g[:, :, -h:] += from_below
        elif mode == "reflect":
            g[:, :, -h - 1 : -1] += g_bot.flip(2)
        return g, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, axis: Axis, mode: str = "reflect") -> torch.Tensor:
    """This band ``x`` (B, C, H_band, W) with ``halo`` rows of the bands
    above and below it over ``axis`` (the frame's edges filled by
    ``mode``): (B, C, H_band + 2 halo, W). Every band of the axis calls it
    together, with the same ``halo`` and ``mode``; each holds at least
    ``halo`` rows (``halo + 1`` to reflect)."""
    if mode not in MODES:
        raise ValueError("halo mode must be one of {}, got {!r}".format(MODES, mode))
    if x.shape[2] < halo + (mode == "reflect"):
        raise ValueError("a band of {} rows cannot give a {}-row {} halo".format(x.shape[2], halo, mode))
    return _HaloExchange.apply(x, halo, axis, mode)


def sharded_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, axis: Axis,
                   mode: str = "reflect") -> torch.Tensor:
    """A stride-1 'same' convolution of the row-sharded frame whose band
    this rank holds, padded by ``mode`` at the frame's borders: the band's
    rows of the convolution of the whole frame. ``weight`` (out, in, kh,
    kw) with odd kh and kw: a (kh // 2)-row halo, the columns padded
    here, then an unpadded ``F.conv2d``."""
    kh, kw = weight.shape[-2:]
    assert kh % 2 == 1 and kw % 2 == 1, "odd kernels only"
    x = halo_exchange(x, kh // 2, axis, mode) if kh > 1 else x
    if kw > 1:
        pad = (kw // 2, kw // 2, 0, 0)
        x = F.pad(x, pad, mode="constant") if mode == "zeros" else F.pad(x, pad, mode=mode)
    return F.conv2d(x, weight, bias)
