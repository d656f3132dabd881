"""Inference cells of large batches: ``runners/fullres.py`` (raw frames
through ``fullres_batches``, K members, the float64 check) as it is,
with a CPU test cut that also cuts the batch to 2, so that the cut pool
of four frames splits into whole batches."""

import dataclasses

from fluorobench.runners import fullres
from fluorobench.runners.fullres import CONTROL, check, faults, main  # noqa: F401


def test_size(cell):
    cut, seconds = fullres.test_size(cell)
    return dataclasses.replace(cut, traffic=dict(cut.traffic, batch_size=2)), seconds
