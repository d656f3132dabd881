"""NCCL's kernels' device time per training step on rank 0's card: every
all-reduce of the window (the gradients', BatchNorm's statistics', fit's
agreement at each epoch's end), from the profiler's trace, over the
window's steps, in ms. A collective's kernel runs from its launch until
the slowest rank has joined, so its time holds that wait."""


def read(run):
    t, steps = run.trace_summary, run.values.get("step_seconds")
    if t is None or not steps:
        return None
    seconds = sum(s for name, s in t.kernel_s.items() if "nccl" in name.lower())
    return 1e3 * seconds / len(steps) if seconds > 0 else None
