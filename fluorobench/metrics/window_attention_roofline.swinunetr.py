"""The window attention's share of its roofline: one forward's least time
in it (``counts_swinunetr.window_attention_bound_s`` of the cell's batch
and size, summed over the blocks) times the forwards in the window (the
program's ``window_attention_calls``, one a block, over the blocks a
forward), over the device time of the kernels
``F.scaled_dot_product_attention`` launches, matched by name (``fmha``
for the memory-efficient kernel on float32 inputs, ``flash`` and
``cudnn`` attention kernels besides), in %."""

from fluorobench.program_spans import recorded

NAMES = ("fmha", "flash_fwd", "attention")


def read(run):
    t = run.trace_summary
    calls = recorded()[1].get("window_attention_calls")
    if t is None or not calls or "window_attention_bound_s" not in run.values:
        return None
    seconds = sum(s for k, s in t.kernel_s.items() if any(n in k.lower() for n in NAMES))
    if seconds <= 0:
        return None
    return 100.0 * run.values["window_attention_bound_s"] * calls / sum(run.cfg["swin_depths"]) / seconds
