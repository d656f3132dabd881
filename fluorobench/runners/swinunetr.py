"""Full-res inference cells of Swin UNETR members: raw full-resolution
frames through ``deepfluoro_tpu_torch.infer.fullres.fullres_batches`` (the
prep, K member forwards of a ``build_model``-built Swin UNETR, the
ensemble, labels and heatmaps read back to the host), as
``runners/transunet.py`` runs TransUNet members, with no landmark decode.

Set-up makes the pool of raw 1536^2 frames (``traffic/fullres_frames.py``)
and K members' weights from the seed (``make_state``; Swin UNETR has no
BatchNorm, so nothing is calibrated), and serves ``warmup_items``
batches. The window goes on with the same generator: one client, closed
loop.

``correct``: a sample of the frames served in the window, drawn from the
seed, is worked out again by the float64 reference
(``reference/swinunetr.py``) from the raw frames and the same weights,
frame by frame; the program's labels are judged by how far the
reference's probability of each label lies below its best, its heats by
their largest difference. A program without ``models/swinunetr.py``
cannot run the cell, and the run stops at once with a message.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import re
import statistics
import sys
import time

import numpy as np
import torch

from fluorobench import counts, counts_swinunetr, weights
from fluorobench.harness import Trace, card_power_limit
from fluorobench.reference import infer as ref_infer
from fluorobench.reference import swinunetr as ref
from fluorobench.reference.unet import Numerics
from fluorobench.runners.fullres import Reservoir, member_seed
from fluorobench.runners.train import model_shapes, train_config
from fluorobench.traffic.fullres_frames import make_raw_frames

REFERENCE = Numerics(torch.float64)
CONTROL = Numerics(torch.float32, tf32=True)
BIAS_TABLE_SCALE = 0.02
NORM = re.compile(r"\.(norm1|norm2|norm)\.(weight|bias)$")


def faults(cell) -> list[str]:
    """The planted faults of the cell (``faults.py``): ``altered``
    patches ``fullres.ensemble_forward``, which this path runs."""
    return ["altered"]


def test_size(cell):
    """The cell cut to what the CPU runs in seconds: feature size 12 (the
    heads kept, of width 4); raw frames of 212^2 at the 2x factor (56^2
    padded to 64: stage grids of 32, 16, 8 and 4, so the windows pad, the
    shift masks run, and the last grid clamps the window); a pool of four
    frames. Returns it and its window's seconds."""
    cut = dataclasses.replace(cell, config=dict(cell.config, feature_size=12, raw_frame=212, proj_unet_dim=64,
                                                ds_factor=2),
                              traffic=dict(cell.traffic, pool_frames=4, warmup_items=1, check_frames=3))
    return cut, 0.5


def make_state(shapes: dict, seed: int, device, window: int) -> dict:
    """A Swin UNETR state dict: ``weights.make_state``'s rule for the
    convolutions and linear layers; LayerNorm scales 1 and shifts 0; the
    relative-position bias tables uniform in +-``BIAS_TABLE_SCALE`` from a
    generator of their own; the relative-position index as published."""
    own = {k for k in shapes if NORM.search(k) or k.endswith(("relative_position_bias_table",
                                                              "relative_position_index"))}
    state = weights.make_state({k: v for k, v in shapes.items() if k not in own}, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    index = ref.relative_position_index(window).to(device)
    for k in sorted(own):
        if k.endswith("relative_position_bias_table"):
            state[k] = (torch.rand(shapes[k], generator=gen, device=device) * 2 - 1) * BIAS_TABLE_SCALE
        elif k.endswith("relative_position_index"):
            state[k] = index.clone()
        else:
            state[k] = (torch.ones if k.endswith(".weight") else torch.zeros)(shapes[k], device=device)
    return state


def make_members(run):
    """(K eval-mode program members on the device, their state dicts)."""
    from deepfluoro_tpu_torch.models.swinunetr import SwinUNETR
    from deepfluoro_tpu_torch.train.config import build_model

    cfg = run.cfg
    tcfg = train_config(cfg, run.seed)
    shapes, _ = model_shapes(tcfg)
    models, states = [], []
    for k in range(run.traffic["members"]):
        state = make_state(shapes, member_seed(run.seed, k), run.device, cfg["window_size"])
        with torch.device("meta"):
            model = build_model(tcfg)
        if not isinstance(model, SwinUNETR):
            raise SystemExit("the program built a {} for arch {!r}".format(type(model).__name__, cfg["arch"]))
        model = model.to_empty(device=run.device)
        model.load_state_dict(state)
        models.append(model.eval())
        states.append(state)
    return models, states


def main(run) -> None:
    try:
        from deepfluoro_tpu_torch.models import swinunetr  # noqa: F401
    except ImportError as e:
        raise SystemExit("the program cannot build a Swin UNETR: {}".format(e))
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches

    cfg, tr = run.cfg, run.traffic
    if tr["landmarks"]:
        raise ValueError("the Swin UNETR cells decode no landmarks")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    dev, raw = run.device, cfg["raw_frame"]
    with run.spans("setup.data"):
        frames, rots = make_raw_frames(run.seed, tr["pool_frames"], raw, dev)
    with run.spans("setup.weights"):
        models, states = make_members(run)
    pool, batch = tr["pool_frames"], tr["batch_size"]
    if pool % batch:
        raise ValueError("the pool of {} frames does not split into batches of {}".format(pool, batch))
    handed_in = {}

    def read_batch(i0, i1):
        handed_in[i0] = time.perf_counter()
        j0 = i0 % pool
        return frames[j0 : j0 + i1 - i0], rots[j0 : j0 + i1 - i0]

    times = []
    gen = fullres_batches(read_batch, 1 << 40, (raw, raw), models, cfg["ds_factor"], cfg["num_lands"], times, batch,
                          cfg["proj_unet_dim"])

    def serve():
        with run.spans("fullres_batches"):
            i0, labels, heats = next(gen)
        return i0, labels, heats, time.perf_counter() - handed_in.pop(i0)

    try:
        with run.spans("setup.warmup"):
            for _ in range(tr["warmup_items"]):
                serve()
        times.clear()
        run.spans.times.pop("fullres_batches", None)
        sample = Reservoir(tr["check_frames"], run.seed)
        latencies = []
        run.open_window()
        with Trace(run.trace, run.spans) as trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < run.seconds:
                i0, labels, heats, lat = serve()
                latencies.append(lat)
                for j in range(labels.shape[0]):
                    sample.offer((i0 + j, labels[j], heats[j]))
            run.window_s = time.perf_counter() - t0
        run.trace_summary = trace.summary
        run.values["card"] = card_power_limit()
    finally:
        gen.close()
    served = len(latencies) * batch
    run.attempted = served
    run.end_to_end["infer_frames_per_s"] = served / run.window_s
    print("{} batches of {} frames: latency mean {:.4f} ms, median {:.4f}, max {:.4f}".format(
        len(latencies), batch, 1e3 * statistics.fmean(latencies), 1e3 * statistics.median(latencies),
        1e3 * max(latencies)), file=sys.stderr)
    size = counts.pad_size(cfg, ref_infer.crop_size(raw, cfg["ds_factor"]))
    run.values.update(frames=served, batch_s=list(times), members=len(models),
                      flops_per_frame=len(models) * counts_swinunetr.swinunetr_forward_flops(cfg, size),
                      window_attention_bound_s=counts_swinunetr.window_attention_bound_s(cfg, batch, size))
    run.read_peak()
    del models
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.check_inputs = dict(states=states, frames=frames, rots=rots, items=sample.items)
    check(run)


def readings(run, num: Numerics | None = None) -> dict:
    """The compared numbers over the sampled frames: the program's (or
    with ``num`` the control's: the reference at that precision in the
    program's place) against the float64 reference."""
    cfg, dev, pool = run.cfg, run.device, run.traffic["pool_frames"]
    states, frames, rots, items = (run.check_inputs[k] for k in ("states", "frames", "rots", "items"))
    members = [{k: v.to(torch.float64) if v.is_floating_point() else v for k, v in s.items()} for s in states]
    low = None if num is None else [{k: v.to(num.dtype) if v.is_floating_point() else v for k, v in s.items()}
                                    for s in states]
    label_gap = heat_gap = 0.0
    for i, labels, heats in items:
        f = torch.from_numpy(frames[i % pool][None]).to(dev)
        r = torch.from_numpy(rots[i % pool : i % pool + 1]).to(dev)
        prob, ref_heat, _ = ref.ensemble(members, f, r, cfg, REFERENCE)
        if num is not None:
            _, heats_t, labels_t = ref.ensemble(low, f, r, cfg, num)
            labels, heats = labels_t[0].cpu().numpy(), heats_t[0].float().cpu().numpy()
        lab = torch.from_numpy(labels.astype(np.int64)).to(dev)
        best = prob[0].amax(dim=0)
        got = prob[0].gather(0, lab[None])[0]
        label_gap = max(label_gap, float((best - got).max()))
        heat_gap = max(heat_gap, float((torch.from_numpy(heats).to(dev).double() - ref_heat[0]).abs().max()))
    return {"label_gap": label_gap, "heat_gap": heat_gap}


def check(run, num: Numerics | None = None) -> None:
    """Hold the program's numbers (with ``num`` the control's) to the
    cell's limits."""
    if not run.check_inputs["items"]:
        print("no frame was served in the window", file=sys.stderr)
        run.check("label_gap", math.inf)
        return
    t0 = time.perf_counter()
    for name, v in readings(run, num).items():
        run.check(name, v)
    run.values["check_s"] = time.perf_counter() - t0
