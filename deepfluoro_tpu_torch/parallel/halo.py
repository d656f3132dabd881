"""Row exchanges of a row-sharded frame (JAX counterpart: ``deepfluoro_tpu/
parallel/halo.py``, where ``shard_map`` and ``ppermute`` trade halo rows;
GSPMD partitions the rest of a row-sharded U-Net itself).

A frame cut into bands of rows over the 'spatial' axis (``parallel/
mesh.py::RowShard``), one band per process, runs a network band by band.
Every feature map of the network is cut too. ``RowMap`` places a map's
rows in frame coordinates: row r sits at ``offset + stride * r`` of the
padded input frame. A band holds the rows of each map that sit in its
frame rows (``Bands.owned``), so a band keeps the same part of the image
at every level, whatever the levels' heights (odd heights, valid
convolutions, center crops). A layer that maps rows (a 3x3 convolution,
'same' or valid; a stride-2 downsampling; a 2x transposed convolution or
bilinear upsampling; a center crop) needs a window of its input's rows on
each band, which the host works out from the layer's geometry
(``Bands.conv``, ``down``, ``up``, ``crop``). ``Bands.fetch`` plans how
each band gets its window from the bands that hold those rows
(``Fetch``), once per layer, on every process alike. ``fetch_rows`` runs
a plan: a window of the band's own rows is a view; otherwise the rows
travel by point-to-point sends and receives, posted together with
``batch_isend_irecv`` (on NCCL as they are, on gloo through host copies,
since gloo sends host memory only), and its backward sends each row's
gradient home. Rows travel in their tensor's dtype: an activation's under
bfloat16 autocast, int8 for a quantized one. Rows outside the frame fill
by the layer's padding mode:

  'zeros'    zeros (the U-Net's zero-padded convolutions, the recipe);
  'reflect'  the frame's rows mirrored at its edge (JAX's
             ``sharded_conv2d``, a reflect-padded convolution);
  'circular' the rows at the frame's other end.

The bilinear x2 upsampling (half-pixel centres) replicates the frame's
edge rows; its window is clipped to the frame, where the resize's own
clamp replicates them, as on the whole frame.

A band whose window of a layer's output is empty (a band beside the
frame's edge at a deep level of a valid U-Net) still runs the layer, on
zero rows padded to the layer's smallest input and keeping none
(``band_op``): every band posts the same collectives in the same order,
forward and backward, and every parameter gets its (zero) gradient there.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepfluoro_tpu_torch.parallel.mesh import Axis

MODES = ("reflect", "zeros", "circular")


@dataclasses.dataclass(frozen=True)
class RowMap:
    """A feature map's ``rows`` rows in frame coordinates: row r at
    ``offset + stride * r`` of the padded input frame."""

    offset: Fraction
    stride: Fraction
    rows: int

    def conv(self, k: int, pad: int) -> "RowMap":
        """A stride-1 convolution with a k-row kernel and ``pad`` rows of
        padding a side."""
        return RowMap(self.offset + self.stride * (k // 2 - pad), self.stride, self.rows + 2 * pad - k + 1)

    def down(self) -> "RowMap":
        """A 2x2 stride-2 convolution or max-pool (the last row of an odd
        height dropped)."""
        return RowMap(self.offset + self.stride / 2, 2 * self.stride, self.rows // 2)

    def up(self) -> "RowMap":
        """A 2x2 stride-2 transposed convolution or a bilinear x2 resize."""
        return RowMap(self.offset - self.stride / 4, self.stride / 2, 2 * self.rows)

    def crop(self, rows: int) -> "RowMap":
        """``ops/image.py::center_crop`` to ``rows`` rows."""
        return RowMap(self.offset + self.stride * ((self.rows - rows) // 2), self.stride, rows)


def frame_map(rows: int) -> RowMap:
    return RowMap(Fraction(0), Fraction(1), rows)


class Fetch:
    """One band's plan of a row exchange: the ``rows`` rows of its window,
    of which ``main`` (x_lo, x_hi, at) is a run of its own rows, ``extra``
    other own rows ((x_row, at) pairs: mirrored or wrapped), ``zeros``
    positions that are zero, ``sends`` the rows it sends each peer ((global
    rank, x_rows), in the peer's window order) and ``recvs`` the positions
    of the rows it gets from each peer. ``keep`` (start, stop) cuts the
    layer's output to the band's rows (None: all of it); ``n_out`` is how
    many there are."""

    def __init__(self, axis: Axis, rows: int, main, extra, zeros, sends, recvs, keep=None, n_out=None):
        self.axis, self.rows, self.main, self.extra, self.zeros = axis, rows, main, tuple(extra), tuple(zeros)
        self.sends, self.recvs, self.keep = tuple(sends), tuple(recvs), keep
        self.n_out = rows if n_out is None else n_out
        self.view = not (self.extra or self.zeros or self.sends or self.recvs) and (main is None or main[2] == 0)
        self._index = {}

    def index(self, rows, device) -> torch.Tensor:
        key = (rows, str(device))
        if key not in self._index:
            self._index[key] = torch.tensor(rows, dtype=torch.long, device=device)
        return self._index[key]


def _exchange(axis: Axis, sends, recvs, like: torch.Tensor):
    """Post every send (global rank, tensor) and receive (global rank,
    rows) together; return the received tensors in ``recvs``' order, on
    ``like``'s device."""
    if not sends and not recvs:
        return []
    stage = like.is_cuda and dist.get_backend(axis.group) != "nccl"
    dev = like.device
    ops = [dist.P2POp(dist.isend, (t.cpu() if stage else t.contiguous()), peer, axis.group) for peer, t in sends]
    got = []
    for peer, n in recvs:
        buf = torch.empty(like.shape[:2] + (n, like.shape[3]), dtype=like.dtype, device="cpu" if stage else dev)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(dev) for t in got]


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.x_rows = plan, x.shape[2]
        dev = x.device
        out = x.new_empty(x.shape[:2] + (plan.rows, x.shape[3]))
        if plan.main is not None:
            lo, hi, at = plan.main
            out[:, :, at : at + hi - lo] = x[:, :, lo:hi]
        if plan.zeros:
            out.index_fill_(2, plan.index(plan.zeros, dev), 0)
        if plan.extra:
            src, at = zip(*plan.extra)
            out.index_copy_(2, plan.index(at, dev), x.index_select(2, plan.index(src, dev)))
        got = _exchange(plan.axis, [(p, x.index_select(2, plan.index(r, dev))) for p, r in plan.sends],
                        [(p, len(at)) for p, at in plan.recvs], x)
        for (_, at), t in zip(plan.recvs, got):
            out.index_copy_(2, plan.index(at, dev), t)
        return out

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        dev = grad.device
        shape = grad.shape[:2] + (ctx.x_rows, grad.shape[3])
        if plan.main is not None and plan.main[:2] == (0, ctx.x_rows):
            gx = grad[:, :, plan.main[2] : plan.main[2] + ctx.x_rows].clone()
        else:
            gx = grad.new_zeros(shape)
            if plan.main is not None:
                lo, hi, at = plan.main
                gx[:, :, lo:hi] = grad[:, :, at : at + hi - lo]
        if plan.extra:
            src, at = zip(*plan.extra)
            gx.index_add_(2, plan.index(src, dev), grad.index_select(2, plan.index(at, dev)))
        # each received row's gradient goes back to the band that sent it
        got = _exchange(plan.axis, [(p, grad.index_select(2, plan.index(at, dev))) for p, at in plan.recvs],
                        [(p, len(r)) for p, r in plan.sends], grad)
        for (_, rows), t in zip(plan.sends, got):
            gx.index_add_(2, plan.index(rows, dev), t)
        return gx, None


def fetch_rows(x: torch.Tensor, plan: Fetch) -> torch.Tensor:
    """This band's window (B, C, plan.rows, W) of the map whose band ``x``
    (B, C, rows held, W) is; every band of the axis calls it with its own
    plan of one ``Bands.fetch``."""
    if plan.view:
        if plan.main is None:
            return x[:, :, :0]
        lo, hi, _ = plan.main
        return x if (lo, hi) == (0, x.shape[2]) else x[:, :, lo:hi]
    return _Fetch.apply(x, plan)


def band_op(fn, x: torch.Tensor, plan: Fetch | None, min_rows: int = 1) -> torch.Tensor:
    """``fn`` (a layer that maps rows) on this band: its window of ``x``
    fetched by ``plan``, the output cut to the band's rows; ``plan`` None
    for a row-local layer. A band with no output rows runs ``fn`` on
    ``min_rows`` zero rows after its (empty) window and keeps none."""
    w = x if plan is None else fetch_rows(x, plan)
    if (w.shape[2] if plan is None else plan.n_out) == 0:
        pad = w.new_zeros(w.shape[:2] + (max(min_rows - w.shape[2], 0), w.shape[3]))
        return fn(torch.cat([w, pad], dim=2))[:, :, :0]
    y = fn(w)
    if plan is None or plan.keep is None or plan.keep == (0, y.shape[2]):
        return y
    return y[:, :, plan.keep[0] : plan.keep[1]]


def pad_cols(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """``pad`` columns a side by ``mode`` (a band's rows come padded by its
    window)."""
    if not pad:
        return x
    return F.pad(x, (pad, pad, 0, 0), mode="constant" if mode == "zeros" else mode)


def band_conv2d(x, weight, bias, plan: Fetch, pad: int, mode: str) -> torch.Tensor:
    """A stride-1 convolution of this band's rows: the window fetched by
    ``plan`` (its padding rows filled by ``mode``), ``pad`` columns padded
    here, then an unpadded ``F.conv2d``."""
    return band_op(lambda w: F.conv2d(pad_cols(w, pad, mode), weight, bias), x, plan, weight.shape[2])


class Bands:
    """The bands of a frame over the 'spatial' ``axis``: band k holds frame
    rows ``[bounds[k], bounds[k + 1])``. ``joint`` is 'data' x 'spatial'
    (BatchNorm's group) and ``spatial_of`` the band of each of its ranks,
    in group order. The planners return (this band's ``Fetch``, the
    layer's output ``RowMap``); every process builds the same plans."""

    def __init__(self, axis: Axis, bounds, joint: Axis = Axis(), spatial_of=()):
        self.axis, self.bounds, self.joint, self.spatial_of = axis, tuple(bounds), joint, tuple(spatial_of)

    def owned(self, m: RowMap) -> tuple:
        """(lo, hi) of each band: the rows of ``m`` that sit in its frame
        rows (a row at position p belongs to frame row round(p), halves up;
        the first and last bands take any row beyond the frame)."""
        n = len(self.bounds) - 1

        def cut(k):
            if k == 0:
                return 0
            if k == n:
                return m.rows
            return min(max(math.ceil((self.bounds[k] - Fraction(1, 2) - m.offset) / m.stride), 0), m.rows)

        return tuple((cut(k), cut(k + 1)) for k in range(n))

    def counts(self, m: RowMap) -> tuple:
        """The rows of ``m`` on each rank of ``joint``, in group order."""
        owned = self.owned(m)
        return tuple(owned[s][1] - owned[s][0] for s in self.spatial_of)

    def fetch(self, m: RowMap, want, mode: str = "zeros", keep=None, n_out=None) -> Fetch:
        """This band's plan to get rows ``[lo, hi)`` of ``m`` (``want``:
        one (lo, hi) per band, rows outside the frame filled by ``mode``)
        from the bands that hold them."""
        if mode not in MODES:
            raise ValueError("halo mode must be one of {}, got {!r}".format(MODES, mode))
        owned = self.owned(m)
        owner = [k for k, (lo, hi) in enumerate(owned) for _ in range(lo, hi)]
        h = m.rows

        def source(e):
            if 0 <= e < h:
                return e
            if mode == "zeros":
                return None
            if mode == "circular":
                return e % h
            r = -e if e < 0 else 2 * (h - 1) - e
            if not 0 <= r < h:
                raise ValueError("a {}-row map cannot reflect row {}".format(h, e))
            return r

        me = self.axis.index
        mine = [source(e) for e in range(*want[me])]
        # the longest run of own rows in order is the window's main block
        runs, run = [], None
        for j, s in enumerate(mine):
            local = s is not None and owner[s] == me
            if run is not None and local and s == run[1] and j == run[2] + run[1] - run[0]:
                run[1] += 1
            else:
                if run is not None:
                    runs.append(tuple(run))
                run = [s, s + 1, j] if local else None
        if run is not None:
            runs.append(tuple(run))
        # x holds this band's own rows: its indices count from the first
        base = owned[me][0]
        main = max(runs, key=lambda r: r[1] - r[0], default=None)
        in_main = set() if main is None else set(range(main[2], main[2] + main[1] - main[0]))
        if main is not None:
            main = (main[0] - base, main[1] - base, main[2])
        extra = [(s - base, j) for j, s in enumerate(mine) if s is not None and owner[s] == me and j not in in_main]
        zeros = [j for j, s in enumerate(mine) if s is None]
        sends, recvs = [], []
        for q in range(len(owned)):
            if q == me:
                continue
            rows = tuple(s - base for s in (source(e) for e in range(*want[q])) if s is not None and owner[s] == me)
            if rows:
                sends.append((self.axis.ranks[q], rows))
            at = tuple(j for j, s in enumerate(mine) if s is not None and owner[s] == q)
            if at:
                recvs.append((self.axis.ranks[q], at))
        return Fetch(self.axis, len(mine), main, extra, tuple(zeros), sends, recvs, keep, n_out)

    def conv(self, m: RowMap, k: int, pad: int, mode: str):
        """A stride-1 k-row convolution with ``pad`` rows of ``mode``
        padding a side: each band's rows of the output from k - 1 more
        rows of the input."""
        out = m.conv(k, pad)
        want = [(c - pad, d - pad + k - 1) if d > c else (c, c) for c, d in self.owned(out)]
        return self.fetch(m, want, mode, n_out=self._n(out)), out

    def down(self, m: RowMap):
        """A 2x2 stride-2 downsampling: output rows [c, d) from input rows
        [2c, 2d)."""
        out = m.down()
        return self.fetch(m, [(2 * c, 2 * d) for c, d in self.owned(out)], n_out=self._n(out)), out

    def up(self, m: RowMap, bilinear: bool):
        """A 2x upsampling. Transposed: output row q from input row q // 2.
        Bilinear (half-pixel centres): from rows (q - 1) // 2 and the next,
        clipped to the frame (the resize's clamp replicates its edge
        rows)."""
        out = m.up()
        owned = self.owned(out)
        c, d = owned[self.axis.index]
        want = []
        for c_, d_ in owned:
            if d_ == c_:
                want.append((c_ // 2, c_ // 2))
            elif bilinear:
                want.append((max((c_ - 1) // 2, 0), min(d_ // 2 + 1, m.rows)))
            else:
                want.append((c_ // 2, (d_ + 1) // 2))
        lo = want[self.axis.index][0]
        return self.fetch(m, want, keep=(c - 2 * lo, d - 2 * lo), n_out=d - c), out

    def crop(self, m: RowMap, like: RowMap):
        """The center crop of ``m`` to ``like``'s rows, row r of ``like``
        beside row r of the crop (a skip connection, a residual shortcut, a
        head's input): each band's rows of ``like`` taken from ``m``."""
        off = (m.rows - like.rows) // 2
        return self.fetch(m, [(c + off, d + off) for c, d in self.owned(like)]), like

    def _n(self, out: RowMap) -> int:
        c, d = self.owned(out)[self.axis.index]
        return d - c


def _band_layout(x: torch.Tensor, axis: Axis) -> tuple:
    """The frame bounds of the bands, from every band's row count (one
    ``all_reduce``)."""
    n = torch.zeros(axis.size, dtype=torch.int64, device="cpu" if dist.get_backend(axis.group) != "nccl" else x.device)
    n[axis.index] = x.shape[2]
    dist.all_reduce(n, group=axis.group)
    bounds = [0]
    for v in n.tolist():
        bounds.append(bounds[-1] + int(v))
    return tuple(bounds)


def halo_exchange(x: torch.Tensor, halo: int, axis: Axis, mode: str = "reflect") -> torch.Tensor:
    """This band ``x`` (B, C, H_band, W) with ``halo`` rows of the bands
    above and below it over ``axis`` (the frame's edges filled by
    ``mode``): (B, C, H_band + 2 halo, W). Every band of the axis calls it
    together; the bands' sizes are gathered first."""
    if mode not in MODES:
        raise ValueError("halo mode must be one of {}, got {!r}".format(MODES, mode))
    if axis.size == 1:
        bounds = (0, x.shape[2])
    else:
        bounds = _band_layout(x, axis)
    bands = Bands(axis, bounds)
    m = frame_map(bounds[-1])
    want = [(c - halo, d + halo) for c, d in bands.owned(m)]
    return fetch_rows(x, bands.fetch(m, want, mode))


def sharded_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, axis: Axis,
                   mode: str = "reflect") -> torch.Tensor:
    """A stride-1 'same' convolution of the row-sharded frame whose band
    this rank holds, padded by ``mode`` at the frame's borders: the band's
    rows of the convolution of the whole frame. ``weight`` (out, in, kh,
    kw) with odd kh and kw."""
    kh, kw = weight.shape[-2:]
    assert kh % 2 == 1 and kw % 2 == 1, "odd kernels only"
    return F.conv2d(pad_cols(halo_exchange(x, kh // 2, axis, mode), kw // 2, mode), weight, bias)
