"""Median host wait for the card after a batch's dispatch: the
program's ``fullres.sync`` span, in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("fullres.sync")
