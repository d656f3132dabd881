"""A grid of processes with a process group per axis (JAX counterpart:
``deepfluoro_tpu/parallel/mesh.py``).

Axis conventions, as in the JAX package:
  'data'     -- batch-axis data parallelism: each process takes a
                contiguous slice of every global batch;
  'ensemble' -- the fold axis of fold training and the member axis of
                ensemble inference: each process owns K / size of them.

The port runs one process per card, so a mesh is laid over the ranks of
the default process group, row-major in the order the axes are given,
as the JAX package lays devices. ``Mesh.axis(name)`` hands out what an
axis's users need: its size, this rank's index along it, and the process
group of the ranks that differ from this one only along it (None where
the axis has size 1: nothing to reduce).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch.distributed as dist

from deepfluoro_tpu_torch.parallel.multihost import process_count, process_index


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it; ``Axis()`` is an absent axis."""

    size: int = 1
    index: int = 0
    group: object = None  # torch.distributed ProcessGroup, None for size 1

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rows (``n`` divisible by
        the size)."""
        assert n % self.size == 0, "{} rows do not split over {} ranks".format(n, self.size)
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)


class Mesh:
    """Ranks ``0..world-1`` laid row-major over ``axes`` ({name: size})."""

    def __init__(self, axes: dict[str, int], rank: int, groups: dict[str, object]):
        self.axes = dict(axes)
        self.rank = rank
        coords = np.unravel_index(rank, tuple(axes.values())) if axes else ()
        self._axes = {
            name: Axis(size, int(c), groups.get(name)) for (name, size), c in zip(axes.items(), coords)
        }

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    def axis(self, name: str) -> Axis:
        """The named axis, or a size-1 ``Axis`` when the mesh has none."""
        return self._axes.get(name, Axis())

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
        for a, name in enumerate(axes):
            if sizes[a] == 1:
                continue
            others = [range(s) for i, s in enumerate(sizes) if i != a]
            for coord in itertools.product(*others):
                index = list(coord)
                index.insert(a, slice(None))
                ranks = [int(r) for r in grid[tuple(index)]]
                # every process creates every group, in the same order
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = group
    return Mesh(axes, process_index(), groups)
