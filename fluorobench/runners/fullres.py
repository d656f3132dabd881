"""Inference cells: raw full-resolution frames through
``deepfluoro_tpu_torch.infer.fullres.fullres_batches`` (the prep, K member
forwards, the ensemble, labels and heatmaps read back to the host), and
with ``landmarks`` on, each frame's labels and heats through
``eval/landmarks.py::detect_landmarks`` on the card.

Set-up makes a pool of raw 1536^2 frames in host memory
(``traffic/fullres_frames.py``) and K members' weights from the seed, each
member's BatchNorm statistics set from a few of the pool's frames
(``weights.calibrate``), and serves ``warmup_items`` items. The window
goes on with the same generator: one client, closed loop: the next batch
of frames is handed in only when the previous one's results are on the
host. A frame's latency runs from the moment its raw host frame is handed
in (the generator's read of it) to its results on the host.

``correct``: a sample of the frames served in the window, drawn from the
seed (reservoir sampling over the window), is worked out again by the
reference in float64 from the raw frames and the same weights; the
program's labels are judged by how far the reference's probability of
each label lies below its best, its heats by their largest difference,
and its landmarks by the reference's decode of the program's own labels
and heats.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from fluorobench import counts, weights
from fluorobench.runners.train import model_shapes, train_config
from fluorobench.harness import card_power_limit, Trace
from fluorobench.reference import infer as ref_infer
from fluorobench.reference.unet import Numerics
from fluorobench.traffic.fullres_frames import make_raw_frames

REFERENCE = Numerics(torch.float64)
CONTROL = Numerics(torch.float32, tf32=True)
CALIBRATION_FRAMES = 4


def faults(cell) -> list[str]:
    """The planted faults an inference cell can have (``faults.py``)."""
    return ["altered"]


def test_size(cell):
    """The cell cut to what the CPU runs in seconds (depth 2, wf 2; raw
    frames of 148^2 at the 2x factor, 24^2 padded to 28, a pool of four),
    and its window's seconds."""
    cut = dataclasses.replace(
        cell, config=dict(cell.config, depth=2, init_feats_exp=2, raw_frame=148, proj_unet_dim=28, ds_factor=2),
        traffic=dict(cell.traffic, pool_frames=4, warmup_items=1, check_frames=3))
    return cut, 0.5


def member_seed(seed: int, k: int) -> int:
    return seed * 7 + 1_000_003 * (k + 1)


def make_members(run, frames, rots):
    """(K eval-mode program members on the device, their state dicts)."""
    from deepfluoro_tpu_torch.train.config import build_model

    cfg = run.cfg
    tcfg = train_config(cfg, run.seed)
    shapes, _ = model_shapes(tcfg)
    x = ref_infer.prep(torch.from_numpy(frames[:CALIBRATION_FRAMES]).to(run.device),
                       torch.from_numpy(rots[:CALIBRATION_FRAMES]).to(run.device), cfg["ds_factor"],
                       cfg["proj_unet_dim"], Numerics(torch.float32))
    models, states = [], []
    for k in range(run.traffic["members"]):
        state = weights.calibrate(weights.make_state(shapes, member_seed(run.seed, k), run.device), x, cfg)
        with torch.device("meta"):
            model = build_model(tcfg)
        model = model.to_empty(device=run.device)
        model.load_state_dict(state)
        models.append(model.eval())
        states.append(state)
    return models, states


class Reservoir:
    """A uniform sample of ``size`` of the served frames, drawn from the
    seed as they come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.items = []

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def main(run) -> None:
    from deepfluoro_tpu_torch.eval.landmarks import detect_landmarks
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches

    cfg, tr = run.cfg, run.traffic
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    dev = run.device
    raw = cfg["raw_frame"]
    with run.spans("setup.data"):
        frames, rots = make_raw_frames(run.seed, tr["pool_frames"], raw, dev)
    with run.spans("setup.weights"):
        models, states = make_members(run, frames, rots)
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
    land_names = cfg["land_names"]

    def serve():
        with run.spans("fullres_batches"):
            i0, labels, heats = next(gen)
        found = None
        if tr["landmarks"]:
            with run.spans("landmarks"):
                found = detect_landmarks(torch.from_numpy(heats).to(dev), land_names, torch.from_numpy(labels).to(dev))
        return i0, labels, heats, found, time.perf_counter() - handed_in.pop(i0)

    try:
        with run.spans("setup.warmup"):
            for _ in range(tr["warmup_items"]):
                serve()
        times.clear()
        for k in ("fullres_batches", "landmarks"):
            run.spans.times.pop(k, None)
        sample = Reservoir(tr["check_frames"], run.seed)
        latencies = []
        run.open_window()
        with Trace(run.trace, run.spans) as trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < run.seconds:
                i0, labels, heats, found, lat = serve()
                latencies.append(lat)
                for j in range(labels.shape[0]):
                    sample.offer((i0 + j, labels[j], heats[j],
                                  None if found is None else (found[0][j], found[1][j])))
            run.window_s = time.perf_counter() - t0
        run.trace_summary = trace.summary
        run.values["card"] = card_power_limit()
    finally:
        gen.close()
    served = len(latencies) * batch
    run.attempted = served
    run.end_to_end["infer_frames_per_s"] = served / run.window_s
    run.end_to_end["frame_latency_mean_ms"] = 1e3 * statistics.fmean(latencies)
    p95_ms = 1e3 * float(np.percentile(latencies, 95, method="linear"))
    print("{} items of {} frames: latency mean {:.4f} ms, median {:.4f}, p5 {:.4f}, p95 {:.4f}, max {:.4f}".format(
        len(latencies), batch, run.end_to_end["frame_latency_mean_ms"], 1e3 * statistics.median(latencies),
        1e3 * float(np.percentile(latencies, 5)), p95_ms, 1e3 * max(latencies)), file=sys.stderr)
    run.values.update(frames=served, batch_s=list(times), members=len(models), latency_p95_ms=p95_ms,
                      flops_per_frame=len(models) * counts.unet_forward_flops(
                          cfg, counts.pad_size(cfg, ref_infer.crop_size(raw, cfg["ds_factor"]))))
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
    mismatches = 0
    for i, labels, heats, found in items:
        f = torch.from_numpy(frames[i % pool][None]).to(dev)
        r = torch.from_numpy(rots[i % pool : i % pool + 1]).to(dev)
        prob, ref_heat, _ = ref_infer.ensemble(members, f, r, cfg, REFERENCE)
        if num is not None:
            _, heats_t, labels_t = ref_infer.ensemble(low, f, r, cfg, num)
            labels, heats, found = labels_t[0].cpu().numpy(), heats_t[0].float().cpu().numpy(), None
        lab = torch.from_numpy(labels.astype(np.int64)).to(dev)
        best = prob[0].amax(dim=0)
        got = prob[0].gather(0, lab[None])[0]
        label_gap = max(label_gap, float((best - got).max()))
        heat_gap = max(heat_gap, float((torch.from_numpy(heats).to(dev).double() - ref_heat[0]).abs().max()))
        if found is not None:
            rows, cols, nccs = ref_infer.landmarks(heats, labels, cfg["land_names"])
            near = np.abs(nccs - ref_infer.NCC_THRESH) < 1e-4
            differ = (rows != found[0]) | (cols != found[1])
            mismatches += int((differ & ~near).sum())
    out = {"label_gap": label_gap, "heat_gap": heat_gap}
    if run.traffic["landmarks"]:
        out["landmark_mismatches"] = mismatches
    return out


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
