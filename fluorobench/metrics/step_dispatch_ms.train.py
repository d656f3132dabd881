"""Median host time of one training step's dispatch: the program's
``fit.step`` span, from the call of ``train_step`` to its return of the
loss tensor (augmentation, forward, backward and SGD enqueued), in ms."""

from fluorobench.program_spans import median_ms


def read(run):
    return median_ms("fit.step")
