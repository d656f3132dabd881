"""Median host time of one forward's twelve transformer blocks and final
LayerNorm: the program's ``transunet.transformer`` span (the blocks'
launches, enqueued; nothing waits for the card inside it), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("transunet.transformer")
