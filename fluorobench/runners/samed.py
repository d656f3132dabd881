"""Full-res inference cells of SAMed members: raw full-resolution frames
through ``deepfluoro_tpu_torch.infer.fullres.fullres_batches`` (the prep,
K member forwards of a ``build_model``-built SAMed, the ensemble, labels
and heatmaps read back to the host), as ``runners/swinunetr.py`` runs
Swin UNETR members, with no landmark decode.

Set-up makes the pool of raw 1536^2 frames (``traffic/fullres_frames.py``)
and K members' weights from the seed (``make_state``; SAMed has no
BatchNorm, so nothing is calibrated), and serves ``warmup_items``
batches. The window goes on with the same generator: one client, closed
loop.

``correct``: a sample of the frames served in the window, drawn from the
seed, is worked out again by the float64 reference
(``reference/samed.py``) from the raw frames and the same weights, frame
by frame; the program's labels are judged by how far the reference's
probability of each label lies below its best, its heats by their largest
difference. A program without ``models/samed.py`` cannot run the cell,
and the run stops at once with a message.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import re
import statistics
import sys
import time

import numpy as np
import torch

from fluorobench import counts, counts_samed, weights
from fluorobench.harness import Trace, card_power_limit
from fluorobench.reference import infer as ref_infer
from fluorobench.reference import samed as ref
from fluorobench.reference.unet import Numerics
from fluorobench.runners.fullres import Reservoir, member_seed
from fluorobench.runners.train import model_shapes, train_config
from fluorobench.traffic.fullres_frames import make_raw_frames

REFERENCE = Numerics(torch.float64)
CONTROL = Numerics(torch.float32, tf32=True)
REL_POS_SCALE = 0.1
POS_EMBED_SCALE = 0.02
NORMAL = re.compile(r"(positional_encoding_gaussian_matrix|_embed\.weight|_embeddings\.\d+\.weight|_tokens?\.weight)$")


def faults(cell) -> list[str]:
    """The planted faults of the cell (``faults.py``): ``altered``
    patches ``fullres.ensemble_forward``, which this path runs."""
    return ["altered"]


def test_size(cell):
    """The cell cut to what the CPU runs in seconds: width 48 in 4 heads,
    MLP 192, depth 4 with global blocks 1 and 3, windows of 4, a decoder of width
    32 (4 heads, MLP 64); raw frames of 212^2 at the 2x factor (56^2
    padded to 80: a 5x5 grid, which the windowed blocks pad to 8x8); a
    pool of four frames. Returns it and its window's seconds."""
    cut = dataclasses.replace(cell, config=dict(cell.config, hidden_size=48, num_heads=4, num_layers=4, mlp_dim=192,
                                                sam_global_attn_indexes=[1, 3], sam_window_size=4, sam_prompt_dim=32,
                                                sam_decoder_heads=4, sam_decoder_mlp_dim=64, raw_frame=212,
                                                proj_unet_dim=80, ds_factor=2),
                              traffic=dict(cell.traffic, pool_frames=4, warmup_items=1, check_frames=3))
    return cut, 0.5


def make_state(shapes: dict, seed: int, device) -> dict:
    """A SAMed state dict: ``weights.make_state``'s rule for the
    convolutions and linear layers, LoRA's included (its ``linear_b`` not
    zero); LayerNorm scales 1 and shifts 0; from a generator of their own,
    the relative-position tables uniform in +-``REL_POS_SCALE``,
    ``pos_embed`` uniform in +-``POS_EMBED_SCALE``, and the Gaussian PE
    matrix and the embeddings and tokens standard normal, as SAM draws
    them."""
    norm = {k for k in shapes if k.endswith((".weight", ".bias")) and len(shapes[k.rsplit(".", 1)[0] + ".weight"]) == 1}
    own = norm | {k for k in shapes if k.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")) or NORMAL.search(k)}
    state = weights.make_state({k: v for k, v in shapes.items() if k not in own}, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    for k in sorted(own):
        if k in norm:
            state[k] = (torch.ones if k.endswith(".weight") else torch.zeros)(shapes[k], device=device)
        elif NORMAL.search(k):
            state[k] = torch.randn(shapes[k], generator=gen, device=device)
        else:
            scale = POS_EMBED_SCALE if k.endswith("pos_embed") else REL_POS_SCALE
            state[k] = (torch.rand(shapes[k], generator=gen, device=device) * 2 - 1) * scale
    return state


def make_members(run):
    """(K eval-mode program members on the device, their state dicts)."""
    from deepfluoro_tpu_torch.models.samed import SAMed
    from deepfluoro_tpu_torch.train.config import build_model

    cfg = run.cfg
    tcfg = train_config(cfg, run.seed)
    shapes, _ = model_shapes(tcfg)
    models, states = [], []
    for k in range(run.traffic["members"]):
        state = make_state(shapes, member_seed(run.seed, k), run.device)
        with torch.device("meta"):
            model = build_model(tcfg)
        if not isinstance(model, SAMed):
            raise SystemExit("the program built a {} for arch {!r}".format(type(model).__name__, cfg["arch"]))
        model = model.to_empty(device=run.device)
        model.load_state_dict(state)
        models.append(model.eval())
        states.append(state)
    return models, states


def main(run) -> None:
    try:
        importlib.import_module("deepfluoro_tpu_torch.models.samed")
    except ImportError as e:
        raise SystemExit("the program cannot build a SAMed: {}".format(e))
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches

    cfg, tr = run.cfg, run.traffic
    if tr["landmarks"]:
        raise ValueError("the SAMed cells decode no landmarks")
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
                      flops_per_frame=len(models) * counts_samed.samed_forward_flops(cfg, size),
                      rel_pos_attention_bound_s=counts_samed.rel_pos_attention_bound_s(cfg, batch, size))
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
