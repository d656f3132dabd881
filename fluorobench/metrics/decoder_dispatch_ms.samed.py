"""Median host time of one forward's prompt-free decoding: the program's
``samed.decoder`` span (the dense embedding and positional encoding, the
two-way transformer, the upscaling, the hypernetworks, the resize to the
input, the softmax and the landmark head; enqueued), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("samed.decoder")
