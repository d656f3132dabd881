"""A grid of processes with a process group per axis (JAX counterpart:
``deepfluoro_tpu/parallel/mesh.py``).

Axis conventions, as in the JAX package:
  'data'     -- batch-axis data parallelism: each process takes a
                contiguous slice of every global batch;
  'ensemble' -- the fold axis of fold training and the member axis of
                ensemble inference: each process owns K / size of them;
  'spatial'  -- image-row sharding of large frames (the 2x and 1x rungs):
                each process holds a band of rows of every frame of its
                data slice, and the U-Net's convolutions trade edge rows
                with the neighbouring bands (``parallel/halo.py``). It is
                laid out after 'data', as the JAX package's meshes are
                ({'data': D, 'spatial': S}: rank d * S + s).

The port runs one process per card, so a mesh is laid over the ranks of
the default process group, row-major in the order the axes are given,
as the JAX package lays devices. ``Mesh.axis(name)`` hands out what an
axis's users need: its size, this rank's index along it, and the process
group of the ranks that differ from this one only along it (None where
the axis has size 1: nothing to reduce). ``Mesh.joint(names)`` is the
same for several axes at once (BatchNorm's statistics and the gradient
sum span 'data' x 'spatial'). ``row_layout`` and ``RowShard`` cut frames
into the 'spatial' axis's bands.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch.distributed as dist

from deepfluoro_tpu_torch.parallel.multihost import process_count, process_index


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis (or several, ``Mesh.joint``) as this rank sees it;
    ``Axis()`` is an absent axis. ``ranks`` are the global ranks of the
    group in group-rank order (sorted, as ``torch.distributed.new_group``
    orders them); ``index`` is this rank's position among them."""

    size: int = 1
    index: int = 0
    group: object = None  # torch.distributed ProcessGroup, None for size 1
    ranks: tuple = ()

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rows (``n`` divisible by
        the size)."""
        assert n % self.size == 0, "{} rows do not split over {} ranks".format(n, self.size)
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)


class Mesh:
    """Ranks ``0..world-1`` laid row-major over ``axes`` ({name: size})."""

    def __init__(self, axes: dict[str, int], rank: int, groups: dict):
        self.axes = dict(axes)
        self.rank = rank
        self._groups = groups
        self._axes = {name: self._axis((name,)) for name in axes}

    def coords(self, rank: int) -> dict[str, int]:
        """{axis name: coordinate} of global ``rank``."""
        if not self.axes:
            return {}
        return {n: int(c) for n, c in zip(self.axes, np.unravel_index(rank, tuple(self.axes.values())))}

    def _members(self, names) -> tuple:
        """The global ranks that differ from this one only along ``names``,
        sorted."""
        mine = self.coords(self.rank)
        sizes = tuple(self.axes.values())
        out = []
        for r in range(int(np.prod(sizes))):
            c = self.coords(r)
            if all(c[n] == mine[n] for n in self.axes if n not in names):
                out.append(r)
        return tuple(out)

    def _axis(self, names) -> Axis:
        ranks = self._members(names)
        return Axis(len(ranks), ranks.index(self.rank), self._groups.get(tuple(names)) if len(ranks) > 1 else None,
                    ranks)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    def axis(self, name: str) -> Axis:
        """The named axis, or a size-1 ``Axis`` when the mesh has none."""
        return self._axes.get(name, Axis())

    def joint(self, *names: str) -> Axis:
        """The ranks that differ from this one only along ``names`` (those
        the mesh has), as one axis: its group exists where ``make_mesh``
        made it (a single axis, and 'data' x 'spatial')."""
        names = tuple(n for n in self.axes if n in names and self.axes[n] > 1)
        if len(names) <= 1:
            return self.axis(names[0]) if names else Axis()
        return self._axis(names)

    def __repr__(self) -> str:
        return "Mesh({}, rank={})".format(self.axes, self.rank)


def make_mesh(axes: dict[str, int] | None = None) -> Mesh:
    """Build a Mesh from {axis_name: size} over the processes of the
    default group (one process when none is initialized). Defaults to a 1-D
    'data' mesh over all of them. Sizes must multiply to the process count;
    e.g. {'ensemble': 2, 'data': 2} on 4 processes. Every process calls
    this with the same axes: it creates the axes' process groups, which
    all processes take part in."""
    world = process_count()
    if axes is None:
        axes = {"data": world}
    sizes = tuple(axes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError("mesh axes {} must cover {} devices".format(axes, world))
    groups = {}
    if world > 1:
        rank = process_index()
        grid = np.arange(world).reshape(sizes)
        names = list(axes)
        # every single axis; and 'data' x 'spatial' jointly (BatchNorm and
        # the gradient sum of a row-sharded step span both)
        sets = [(a,) for a in range(len(names)) if sizes[a] > 1]
        if "spatial" in axes and "data" in axes and axes["spatial"] > 1 and axes["data"] > 1:
            sets.append(tuple(sorted((names.index("data"), names.index("spatial")))))
        for free in sets:
            others = [range(s) if i not in free else [None] for i, s in enumerate(sizes)]
            for coord in itertools.product(*others):
                index = tuple(slice(None) if c is None else c for c in coord)
                ranks = sorted(int(r) for r in grid[index].reshape(-1))
                # every process creates every group, in the same order
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(names[a] for a in free)] = group
    return Mesh(axes, process_index(), groups)


def row_layout(rows: int, parts: int, multiple: int) -> tuple[int, ...]:
    """The rows of each of ``parts`` bands of a frame of ``rows`` rows, in
    order: whole blocks of ``multiple`` rows, shared as evenly as they go,
    the larger bands first. With ``multiple = 2**(depth - 1)`` every band
    starts and ends on a block of the U-Net's coarsest level, so each 2x2
    stride-2 downsampling and each 2x2 transposed upsampling stays inside
    a band. 1440 = 45 x 32 over 2 -> (736, 704); 736 = 23 x 32 over 2 ->
    (384, 352). Raises ValueError where the frame cannot be cut so:
    nothing is padded."""
    if rows % multiple:
        raise ValueError("{} rows cannot be cut into bands of whole {}-row blocks (the U-Net's coarsest level): "
                         "row sharding needs a multiple of {}".format(rows, multiple, multiple))
    blocks = rows // multiple
    if blocks < parts:
        raise ValueError("{} rows hold {} blocks of {} rows: too few for {} bands".format(rows, blocks, multiple, parts))
    base, extra = divmod(blocks, parts)
    return tuple((base + (i < extra)) * multiple for i in range(parts))


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's band of a row-sharded frame: rows ``[start, stop)`` of
    ``total``, over the 'spatial' ``axis``; ``joint`` is 'data' x
    'spatial' (the group BatchNorm and the gradient sum span) and
    ``counts`` the rows of each of ``joint``'s ranks, in group order."""

    axis: Axis
    joint: Axis
    start: int
    stop: int
    total: int
    counts: tuple

    def window(self, n: int) -> tuple[slice, slice]:
        """A center crop of the frame to ``n`` rows (``ops/image.py::
        center_crop``'s offset), as this band sees it: (the slice of this
        band's rows inside the crop, the slice of the crop's rows this band
        holds). Either may be empty."""
        off = (self.total - n) // 2
        lo, hi = max(self.start, off), min(self.stop, off + n)
        hi = max(hi, lo)
        return slice(lo - self.start, hi - self.start), slice(lo - off, hi - off)

    def crop(self, t, crop_hw):
        """This band's rows of a network output (B, C, rows, W), cut to
        the band's part of the frame's center crop to ``crop_hw``."""
        rows, _ = self.window(crop_hw[0])
        c0 = (t.shape[-1] - crop_hw[1]) // 2
        return t[:, :, rows, c0 : c0 + crop_hw[1]]


def row_shard(mesh: Mesh, rows: int, multiple: int) -> RowShard:
    """This rank's ``RowShard`` of a ``rows``-row frame on ``mesh``'s
    'spatial' axis (``row_layout``)."""
    axis, joint = mesh.axis("spatial"), mesh.joint("data", "spatial")
    layout = row_layout(rows, axis.size, multiple)
    start = sum(layout[: axis.index])
    counts = tuple(layout[mesh.coords(r).get("spatial", 0)] for r in joint.ranks) if joint.size > 1 else ()
    return RowShard(axis, joint, start, start + layout[axis.index], rows, counts)
