"""Median host time of one forward's Swin transformer: the program's
``swinunetr.swin`` span (the patch embedding, the four stages with their
merges, and ``proj_out``; their launches, enqueued: nothing waits for the
card inside it), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("swinunetr.swin")
