"""Median host time of one forward's image encoder: the program's
``samed.encoder`` span (the patch embedding, the 12 blocks with their
relative-position masks, and the neck; their launches, enqueued: nothing
waits for the card inside it), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("samed.encoder")
