"""The encoder attention's share of its roofline: one forward's least time
in it (``counts_samed.rel_pos_attention_bound_s`` of the cell's batch and
size, summed over the blocks: the two attention products and the two
decomposed relative-position terms, the n^2 mask not counted) times the
forwards in the window (the program's ``rel_pos_attention_calls``, one a
block, over the blocks a forward), over the device time of everything the
program's ``samed.rel_pos_attention`` spans launched (its
``device_seconds``: the kernels, copies and sets whose launching op began
inside one; the two decomposed products, the mask's broadcast sum and the
SDPA kernel, whatever their names), in %. The decoder's seven SDPA calls
a forward lie outside those spans. A program without the span's device
time gives None."""

from fluorobench.program_spans import recorded


def read(run):
    try:
        from deepfluoro_tpu_torch.utils.profiling import device_seconds
    except ImportError:
        return None
    calls = recorded()[1].get("rel_pos_attention_calls")
    seconds = device_seconds().get("samed.rel_pos_attention", 0.0)
    if run.trace_summary is None or not calls or seconds <= 0 or "rel_pos_attention_bound_s" not in run.values:
        return None
    return 100.0 * run.values["rel_pos_attention_bound_s"] * calls / run.cfg["num_layers"] / seconds
