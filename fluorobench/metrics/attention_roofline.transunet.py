"""The attention kernels' share of their roofline: one call's least time
(``counts_transunet.attention_bound_s`` of the cell's batch and tokens)
times the program's ``attention_calls`` in the window, over the device
time of the kernels ``F.scaled_dot_product_attention`` launches, matched
by name (``fmha`` for the memory-efficient kernel on float32 inputs,
``flash`` and ``cudnn`` attention kernels besides), in %."""

from fluorobench.program_spans import recorded

NAMES = ("fmha", "flash_fwd", "attention")


def read(run):
    t = run.trace_summary
    calls = recorded()[1].get("attention_calls")
    if t is None or not calls or "attention_bound_s" not in run.values:
        return None
    seconds = sum(s for k, s in t.kernel_s.items() if any(n in k.lower() for n in NAMES))
    if seconds <= 0:
        return None
    return 100.0 * run.values["attention_bound_s"] * calls / seconds
