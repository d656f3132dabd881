"""The window's checkpoint time per epoch: the program's
``fit.checkpoint`` spans (each save or copy on the main thread) and its
``fit.checkpoint_wait`` (the wait for the writer thread on exit), summed
over the window and divided by its epochs, in ms; comparable with
``epoch_overhead_ms.train``."""

from fluorobench.program_spans import durations_ms


def read(run):
    d, epochs = durations_ms("fit.checkpoint", "fit.checkpoint_wait"), run.values.get("epochs")
    return sum(d) / epochs if d and epochs else None
