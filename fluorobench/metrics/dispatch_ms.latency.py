"""Median host time of one batch's dispatch: the program's
``fullres.forward`` span (prep, the K member forwards, mean and argmax
enqueued), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("fullres.forward")
