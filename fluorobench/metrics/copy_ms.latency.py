"""Median over batches of a batch's copies: the program's
``fullres.copy_up`` (raw frames and flags to the card) and
``fullres.readback`` (labels and heats to the host) spans of the same
batch, summed, in ms."""

from fluorobench.program_spans import median_per_id_ms


def read(run):
    return median_per_id_ms("fullres.copy_up", "fullres.readback")
