#!/usr/bin/env python3
"""cuDNN's algorithm choice for the port's full-res forward on one CUDA
card, in three modes: ``heuristic`` (``torch.backends.cudnn.benchmark``
off: cuDNN's heuristics), ``benchmark`` (on: each convolution shape timed
once, then the fastest algorithm kept) and ``program`` (a heuristic
forward at the batch's shape first, as a BatchNorm calibration before
full-res inference makes one, then the forward inside ``infer/batches.py::
measured_algorithms``, the scope ``fullres_batches`` runs its forwards in).

    python3 scripts/port_fullres_cudnn.py [--rung 2x|1x] [--seed N]

For the rung, raw 1536^2 frames made from the seed go through the fused
full-res prep into one seeded member of ``chip_smoke.py``'s full-width
net (BatchNorm statistics calibrated as there), float32 with TF32 off.
Each mode runs in a fresh process, because torch keeps the plan it chose
for a shape for the life of the process (its cache key holds
``deterministic`` and TF32 but not ``benchmark``). Prints the card's name
and power limit, then per mode the forward's frames/s (5 timed forwards
after 2 warm-ups, synchronised), its peak memory less its baseline, and
the six slowest convolutions by CUDA events; ``program`` also prints the
median batch time of ``fullres_batches`` over the same frames (copy up,
prep, forward, argmax, synchronise; readback outside). Run from the
repository root.
"""

import argparse
import contextlib
import os
import statistics
import subprocess
import sys
import time
import types

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data  # noqa: E402
from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep  # noqa: E402
from deepfluoro_tpu_torch.infer.batches import measured_algorithms  # noqa: E402
from deepfluoro_tpu_torch.infer.fullres import fullres_batches  # noqa: E402

RUNGS = {name: (factor, pad, batch) for name, factor, pad, _, batch in cs.FULLRES_RUNGS}


def run_mode(rung, seed, mode):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = mode == "benchmark"
    factor, pad, batch = RUNGS[rung]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=batch, img_dim=cs.FULLRES_DIM, seed=seed + 5)[0]
    cfg = cs._recipe_cfg(types.SimpleNamespace(num_lands=spec["lands"].shape[-1]), seed, proj_unet_dim=pad)
    full_hw = spec["projs"].shape[1:]
    prep, _ = make_fullres_prep(factor, pad, full_hw)
    x = prep(torch.from_numpy(spec["projs"]).cuda(), torch.from_numpy(spec["rots"]).cuda())
    model = cs._seeded_member(cfg, seed * 1000 + pad, x).eval()
    scope = contextlib.nullcontext
    if mode == "program":
        with torch.no_grad():
            model(x)  # heuristic plans for every shape, cached first
        scope = measured_algorithms
    with torch.no_grad(), scope():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(5):
            model(x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
    print("{} rung, batch {}, {}: {:.2f} frames/s ({:.3f} ms per forward); peak device memory less its baseline {} "
          "bytes".format(rung, batch, mode, batch / dt, dt * 1e3, torch.cuda.max_memory_allocated() - base),
          flush=True)
    if mode == "program":
        times = []
        frames = lambda i0, i1: (spec["projs"][: i1 - i0], spec["rots"][: i1 - i0])  # noqa: E731
        for _ in fullres_batches(frames, 7 * batch, full_hw, [model], factor, cfg.num_lands, times, batch, pad):
            pass
        per_batch = statistics.median(times) * batch
        print("  fullres_batches: median batch {:.3f} ms ({:.2f} frames/s, readback outside)".format(
            per_batch * 1e3, batch / per_batch), flush=True)

    events = {}

    def before(name):
        def hook(module, args):
            events[name] = [torch.cuda.Event(enable_timing=True)]
            events[name][0].record()
        return hook

    def after(name):
        def hook(module, args, out):
            events[name].append(torch.cuda.Event(enable_timing=True))
            events[name][1].record()
        return hook

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_pre_hook(before(name))
            m.register_forward_hook(after(name))
    with torch.no_grad(), scope():
        model(x)
    torch.cuda.synchronize()
    for ms, name in sorted(((a.elapsed_time(b), n) for n, (a, b) in events.items()), reverse=True)[:6]:
        print("  {:9.3f} ms  {}".format(ms, name))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rung", choices=sorted(RUNGS), default="2x")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mode", choices=["heuristic", "benchmark", "program"], help="run one mode in this process")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_fullres_cudnn: no CUDA card", file=sys.stderr)
        return 1
    if args.mode:
        run_mode(args.rung, args.seed, args.mode)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for mode in ("heuristic", "benchmark", "program", "program", "benchmark", "heuristic"):
        subprocess.run([sys.executable, __file__, "--rung", args.rung, "--seed", str(args.seed), "--mode", mode],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
