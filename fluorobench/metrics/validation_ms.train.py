"""Median time of one epoch's validation: the program's
``fit.validation`` span around ``evaluate``, in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("fit.validation")
