#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepfluoro_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with one NVIDIA H100, ``nvcc``
(CUDA toolkit under /usr/local/cuda or on PATH) and PyTorch built for CUDA.
It needs no JAX and no h5py. Phases, each with its wall time:

  1. environment: card name and power limit, torch/CUDA/nvcc versions, and
     the TF32 switches, set explicitly (both off: the recipe is float32);
  2. build: ``nvcc`` compiles ``deepfluoro_tpu_torch/csrc/affine_warp.cu``
     into ``build/deepfluoro_tpu_torch/``;
  3. kernel against its plain version on the card: the 8x training warps,
     a matrix far outside the augmentation box, and two wide geometries;
     bilinear within max |diff| <= 1e-4, nearest with < 0.1 % of pixels
     different; then the times of one training step's two warps;
  4. training: ``fit`` on the full-width 8x paper recipe (depth 6, wf 5,
     192^2 input from 180^2 frames, batch 5, Nesterov SGD, plateau LR,
     data augmentation) for 2 epochs of an in-memory synthetic dataset made
     from ``--seed``, with checkpoints in a temporary directory; then the
     trained net's forward on the card against the same net on the CPU.

Any failed check raises, and the script exits non-zero without the final
line. On success the line before the last is a JSON object describing the
kernel, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense), the bound's denominators
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

WARP_SOURCE = "deepfluoro_tpu_torch/csrc/affine_warp.cu"
WARP_REPLACES = "deepfluoro_tpu/ops/pallas/warp.py:59"


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _median_ms(fn, repeats, warmup=5):
    """Median of CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_environment():
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi)
    print("torch {} (CUDA {}), python {}".format(torch.__version__, torch.version.cuda, sys.version.split()[0]))
    from deepfluoro_tpu_torch.ops._build import find_nvcc

    print("nvcc: {}".format(_run([find_nvcc(), "--version"]).splitlines()[-1]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch.backends.cuda.matmul.allow_tf32 = {}".format(torch.backends.cuda.matmul.allow_tf32))
    print("torch.backends.cudnn.allow_tf32 = {}".format(torch.backends.cudnn.allow_tf32))
    print("device: {} x {}".format(torch.cuda.device_count(), torch.cuda.get_device_name(0)))


def phase_build():
    from deepfluoro_tpu_torch.ops._build import build_logs, library_path, load_library

    t0 = time.perf_counter()
    load_library("affine_warp")
    print("built {} in {:.2f} s".format(library_path("affine_warp"), time.perf_counter() - t0))
    for line in build_logs.get("affine_warp", "").splitlines():
        if "ptxas info" in line:
            print("  " + line.strip())


def _aug_matrices(gen, b, dim):
    """Inverse matrices of the training augmentation's draws for a batch."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, draw_augmentation
    from deepfluoro_tpu_torch.ops.image import inverse_affine_matrix

    d = draw_augmentation(gen, b, dim, dim, AugmentConfig())
    return inverse_affine_matrix(
        (dim * 0.5, dim * 0.5), d["rot"], (d["trans"][:, 0], d["trans"][:, 1]), d["scale"],
        (d["shear"][:, 0], d["shear"][:, 1]),
    )


def phase_kernel_check(seed):
    from deepfluoro_tpu_torch.ops import image, warp
    from deepfluoro_tpu_torch.ops.image import inverse_affine_matrix

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b, dim, out_dim = 5, 180, 192
    extra = (out_dim - dim) // 2

    def fixed(dim_, angle, trans, scale, shear, n):
        m = inverse_affine_matrix((dim_ / 2.0, dim_ / 2.0), angle, trans, scale, shear)
        return m.expand(n, 2, 3).contiguous().to(dev)

    proj = torch.rand((b, dim, dim), generator=gen, device=dev)
    labels = torch.randint(0, 7, (b, dim, dim), generator=gen, device=dev).float()
    aug_m = _aug_matrices(gen, b, dim).to(dev)
    far_m = fixed(dim, 30.0, (60.0, -60.0), 0.6, (0.0, 0.0), b)
    cases = [
        ("8x projection 180->192 bilinear", proj, aug_m, 1, (out_dim, out_dim), (-extra, -extra)),
        ("8x labels 180->180 nearest", labels, aug_m, 0, None, (0.0, 0.0)),
        ("far matrix 180->192 bilinear", proj, far_m, 1, (out_dim, out_dim), (-extra, -extra)),
        ("far matrix 180->180 nearest", labels, far_m, 0, None, (0.0, 0.0)),
    ]
    for orig, od in ((360, 360), (300, 320)):
        e = (od - orig) // 2 if od > orig else 0
        img = torch.rand((2, orig, orig), generator=gen, device=dev)
        m = fixed(orig, -5.0, (-20.0, 20.0), 0.9, (-1.0, 1.0), 2)
        cases.append(("{}->{} bilinear".format(orig, od), img, m, 1, (od, od), (-e, -e)))

    max_abs = 0.0
    for name, img, m, order, oshape, off in cases:
        got = warp.affine_warp(img, m, order=order, out_shape=oshape, out_offset_xy=off)
        want = image.affine_warp(img, m, order=order, out_shape=oshape, out_offset_xy=off)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_abs = max(max_abs, err)
        if order == 1:
            ok = err <= 1e-4
            print("  {}: max |diff| {:.3e} (<= 1e-4) {}".format(name, err, "ok" if ok else "FAIL"))
        else:
            share = float((got != want).float().mean())
            ok = share < 1e-3
            print("  {}: {:.4%} of pixels differ (< 0.1 %) {}".format(name, share, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("kernel disagrees with its plain version: " + name)

    # one training step's two warps, as the augmentation issues them
    def step_warps(fn):
        def run():
            fn(proj, aug_m, order=1, out_shape=(out_dim, out_dim), out_offset_xy=(-extra, -extra))
            fn(labels, aug_m, order=0)
        return run

    ms = _median_ms(step_warps(warp.affine_warp), repeats=200)
    plain_ms = _median_ms(step_warps(image.affine_warp), repeats=50)
    nbytes = 4 * (2 * b * dim * dim + b * out_dim * out_dim + b * dim * dim + 2 * b * 6)
    # per output pixel: coordinates 10, weights 4, four taps 3 each (bilinear);
    # coordinates 10 and rounding 2 (nearest)
    nops = 26 * b * out_dim * out_dim + 12 * b * dim * dim
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_FLOPS_PER_S * 1e3
    print("  one step's warps: kernel {:.4f} ms, plain {:.4f} ms, bound {:.6f} ms ({} bytes, {} operations); "
          "no single PyTorch call computes a mirror warp, so there is no library time".format(
              ms, plain_ms, max(bytes_ms, ops_ms), nbytes, nops))
    return {
        "name": "affine_warp",
        "route": "cuda",
        "source": WARP_SOURCE,
        "replaces": WARP_REPLACES,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def phase_training(seed, workdir):
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import TrainConfig, fit, load_checkpoint

    data = make_synthetic_data(num_specimens=6, num_projs=7, img_dim=180, seed=seed)
    cfg = TrainConfig(
        num_classes=7, batch_size=5, proj_unet_dim=192, optim_type="sgd", init_lr=0.1, nesterov=True,
        momentum=0.9, wgt_decay=1e-4, lr_sched_meth="plateau", depth=6, init_feats_exp=5, batch_norm=True,
        padding=True, no_max_pool=True, data_aug=True, num_lands=data.num_lands, heat_coeff=0.5,
        train_valid_split=0.85, checkpoint_freq=1, max_num_epochs=2, seed=seed,
    )
    ck_path = os.path.join(workdir, "check_net.pt")
    torch.cuda.reset_peak_memory_stats()
    warp.warp_launches = 0
    t0 = time.perf_counter()
    out = fit(
        data, [2, 3, 4, 5, 6], cfg,
        checkpoint_filename=ck_path,
        best_valid_filename=os.path.join(workdir, "best_net.pt"),
        train_loss_txt=os.path.join(workdir, "train_iter_loss.txt"),
        valid_loss_txt=os.path.join(workdir, "valid_loss.txt"),
        device="cuda",
    )
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = warp.warp_launches

    model = out["model"]
    losses = out["train_losses"] + out["valid_losses"]
    n_steps = len(out["train_losses"])
    print("  fit: {} train steps in {:.1f} s; losses {}".format(n_steps, fit_s, ["%.4f" % l for l in losses]))
    if n_steps < 8:
        raise AssertionError("only {} train steps".format(n_steps))
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError("non-finite loss")
    if not all(p.device.type == "cuda" for p in model.parameters()):
        raise AssertionError("a parameter is off the card")
    if launches != 2 * n_steps:
        raise AssertionError("warp launches {} != 2 x {} steps".format(launches, n_steps))
    print("  warp kernel launches during fit: {} (2 per step)".format(launches))

    ck = load_checkpoint(ck_path)
    for key in ("model-state-dict", "optimizer-state-dict", "scheduler-state-dict", "epoch", "loss",
                "best-valid-loss", "train-idx", "valid-idx", "num-classes", "depth", "init-feats-exp",
                "batch-norm", "no-max-pool", "pad-img-size", "num-lands", "init-lr"):
        if key not in ck:
            raise AssertionError("checkpoint lacks key " + key)
    sd = model.state_dict()
    if ck["epoch"] != 2 or list(ck["model-state-dict"]) != list(sd):
        raise AssertionError("checkpoint does not hold the trained model")
    for k in ("down_path.5.block.3.weight", "up_path.4.conv_block.block.5.running_var", "lands_1x1.1.weight"):
        if not torch.equal(ck["model-state-dict"][k], sd[k].cpu()):
            raise AssertionError("checkpoint tensor {} differs from the model".format(k))
    print("  checkpoint {} holds epoch {} and {} tensors".format(os.path.basename(ck_path), ck["epoch"], len(sd)))

    sec = out["step_seconds"][1:]
    print("  train steps/s over the batch loops after the first step: {:.3f} "
          "(first step {:.3f} s, then median {:.4f} s/step)".format(
        len(sec) / sum(sec), out["step_seconds"][0], float(np.median(sec))))
    print("  peak device memory (max_memory_allocated): {} bytes".format(torch.cuda.max_memory_allocated()))

    # the trained net on the card against the same net on the CPU, one frame
    valid = data.select_pats([2, 3, 4, 5, 6]).subset(out["valid_idx"][:1])
    x = prepare_batch(AugmentConfig(proj_pad_dim=192, prob_of_aug=0.0), None, torch.from_numpy(valid.projs))["proj"]
    model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        seg_d, heat_d = model(x.cuda())
        seg_c, heat_c = cpu_model(x)
    seg_err = float((seg_d.cpu() - seg_c).abs().max())
    heat_err = float((heat_d.cpu() - heat_c).abs().max())
    heat_scale = float(heat_c.abs().max())
    print("  trained forward, card vs CPU: seg {:.2e}, heats {:.2e} (heats max {:.3f})".format(seg_err, heat_err, heat_scale))
    if tuple(seg_d.shape) != (1, 7, 192, 192) or tuple(heat_d.shape) != (1, 14, 192, 192):
        raise AssertionError("forward shapes {} {}".format(tuple(seg_d.shape), tuple(heat_d.shape)))
    if not (torch.isfinite(seg_d).all() and torch.isfinite(heat_d).all()):
        raise AssertionError("non-finite forward output")
    if seg_err > 1e-3 or heat_err > 1e-3 * max(1.0, heat_scale):
        raise AssertionError("card and CPU forwards disagree")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the synthetic data, weights and draws")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1

    t_all = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phases = [
            ("1 environment", phase_environment),
            ("2 build", phase_build),
            ("3 kernel vs plain", lambda: phase_kernel_check(args.seed)),
            ("4 training", lambda: phase_training(args.seed, workdir)),
        ]
        results = {}
        for name, fn in phases:
            print("== phase {}".format(name), flush=True)
            t0 = time.perf_counter()
            results[name] = fn()
            print("== phase {} done in {:.1f} s".format(name, time.perf_counter() - t0), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernel = dict(results["3 kernel vs plain"])
    kernel["launches"] = results["4 training"]
    print("total {:.1f} s".format(time.perf_counter() - t_all))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
