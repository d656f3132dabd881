"""The augmentation warp kernel's share of its roofline: its least time
per launch (``counts.warp_pair_bytes`` of the cell's batch at 3.35 TB/s)
times its launches, over its device time in the trace, in %."""


def read(run):
    t = run.trace_summary
    if t is None or "warp_bound_s" not in run.values:
        return None
    names = [k for k in t.kernel_s if "affine_warp" in k]
    calls = sum(t.kernel_calls[k] for k in names)
    seconds = sum(t.kernel_s[k] for k in names)
    if not calls or seconds <= 0:
        return None
    return 100.0 * run.values["warp_bound_s"] * calls / seconds
