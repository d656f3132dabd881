"""Blocking reads of the device per training step: the program's
``host_syncs`` counter over its recorded ``fit.step`` spans (the loss read
of each step, the validation read of each epoch)."""

from fluorobench.program_spans import recorded


def read(run):
    spans, counts = recorded()
    steps = sum(s.name == "fit.step" for s in spans)
    return counts["host_syncs"] / steps if steps and "host_syncs" in counts else None
