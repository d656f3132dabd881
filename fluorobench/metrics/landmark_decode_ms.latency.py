"""Median time of one landmark decode: the program's
``landmarks.detect`` span (the decode on the card, rows and columns back
on the host), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("landmarks.detect")
