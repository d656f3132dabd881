"""Median time of one batch's readback: the program's
``fullres.readback`` span (labels and heats to host memory), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("fullres.readback")
