"""Median wall time of one batch in the window as ``fullres_batches``'
``times`` gives it (the copy to the card, prep, forwards, mean and argmax,
up to a synchronise; the readback outside), in ms."""

import statistics


def read(run):
    s = run.values.get("batch_s")
    return 1e3 * statistics.median(s) * run.traffic["batch_size"] if s else None
