"""Median host wait for one step's loss on the host: the program's
``fit.loss_readback`` span around ``float(loss)``, in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("fit.loss_readback")
