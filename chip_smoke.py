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
  3. kernel against its plain version on the card, bilinear within max
     |diff| <= 1e-4, nearest with < 0.1 % of pixels different: one
     training step's pair (projection and labels, one launch) under the
     augmentation's matrices at 8x (180 -> 192 and 179 -> 193), 2x
     (718 -> 736) and 1x (1436 -> 1440); two matrices outside the
     augmentation's box whose tiles take the global path; single warps at
     two more geometries. At each of the four geometries the pair's device
     time (a CUDA graph of 50 launches), host dispatch per call, profiler
     time, bound, plain time and ``grid_sample_warp`` time;
  4. training: ``fit`` on the full-width 8x paper recipe (depth 6, wf 5,
     192^2 input from 180^2 frames, batch 5, Nesterov SGD, plateau LR,
     data augmentation) for 2 epochs of an in-memory synthetic dataset made
     from ``--seed``, with checkpoints in a temporary directory; one warp
     launch per step; ``fit``'s peak memory less what was allocated before
     it; then the trained net's forward on the card against the same net
     on the CPU, and the BatchNorm running variances after one train-mode
     forward on each;
  5. inference: a K = 6 ensemble of the 8x model (phase 4's checkpoint and
     five members drawn from seeded generators, each saved and reloaded
     through ``load_net_from_checkpoint``) over synthetic 180^2 frames and
     a batch of 179^2 frames (padded to 193^2), driven through
     ``ensemble_batches``, the device half of ``cli/test_ensemble.py``;
     the card against the CPU on the same members and frames (member-mean
     seg and heats within 1e-3, labels differing on < 0.1 % of pixels and
     only at near-ties, ``detect_landmarks`` and ``hard_dice`` equal); the
     per-image latency at batch 1, frames/s at batch 64 for K = 6 and
     K = 1, the phase's peak memory less its baseline and the landmark
     detection time per frame;
  6. resume and stream: ``fit`` on phase 4's recipe and data for 1 epoch,
     then resumed to 2 from its checkpoint (the split reused, the loss logs
     appended, the restored weights and optimizer state on the card); a run
     that receives SIGTERM at its second step, which stops after that
     epoch with a checkpoint and writes a light best net (< 0.75 of the
     checkpoint's size); ``stream_data=True`` against the resident feed,
     augmentation off and ``cudnn.deterministic`` on, per-step losses
     within 1e-4 relative; one warp launch per augmented step;
  7. folds: ``fit_multifold`` over specimens 1-6 (K = 6) at the same width,
     2 epochs, then resumed to a third; one warp launch per lockstep step
     (K*B = 30 frames); lockstep steps/s, fold-steps/s and the phase's
     peak memory less its baseline; the warp pair at 30 frames of
     180^2 -> 192^2 against its plain version (phase 3's tolerances) and
     timed; the six best nets loaded through ``load_net_from_checkpoint``;
     one lockstep step on the card against the CPU from the same weights
     and batch, augmentation off, every fold's loss within 1e-3 relative;
  8. ladder: (a) raw 1536^2 frames made from ``--seed`` through the fused
     full-res prep and the ensemble (``infer/fullres.py::fullres_batches``,
     the device half of ``cli/seg_fullres.py``) at 8x (phase 5's K = 6
     members, 1436 -> 179 padded to 193), 2x (a seeded member, 718 -> 736)
     and 1x (a seeded member, 1436 -> 1440, batch 2); card against CPU on
     two frames per rung (prep within 1e-5, heats within 1e-3, labels
     differing on < 0.1 % of pixels and only at near-ties), frames/s by the
     --times contract and each rung's peak memory less its baseline; no
     warp launch. (b) ``fit`` at full width at 2x (718 -> 736, batch 5) and
     1x (1436 -> 1440, batch 2) with bf16 compute, remat and the streamed
     feed, augmentation on, 2 epochs each: one warp launch per step,
     steps/s and peak memory less baseline; then at 2x, from the trained
     weights and one batch, augmentation off and cuDNN deterministic: remat
     against no remat in float32 (loss within 1e-6 relative, gradients
     within 1e-5 of each tensor's largest, BatchNorm buffers equal, both
     peaks), bf16 against float32 (loss within 2e-2 relative), and the bf16
     checkpoint reloaded through ``load_net_from_checkpoint`` running in
     bf16;
  9. int8: (a) ``ops/int8_conv.py``'s card route (int8 im2col and
     ``torch._int_mm``) bit-equal (int32) to its plain float64 version for
     every distinct convolution of the 8x net (depth 6, wf 5, 192^2) at 2
     frames, and each timed at batch 64 beside its GEMM alone and cuDNN's
     float32 and bf16 convolutions; activation and weight quantization
     equal on card and CPU; (b) phase 5's K = 6 members int8: card
     against CPU on the same scales and input (mean seg and heats within
     1e-3, labels differing on < 0.1 % of pixels and only at near-ties),
     labels against the float ensemble's, ``ensemble_batches(quantized=
     True)`` equal to the direct int8 forward; frames/s at batch 64 for
     K = 6 and K = 1 by the --times contract, float and int8 in turns
     (float, int8, int8, float), each run's peak less its baseline, and
     K = 6 with the finest level in float; (c) the 8x full-res rung (K =
     6, batch 8) int8, checked the same way and timed in turns; (d) one
     int8 GEMM per convolution of every timed int8 forward, no warp
     launch;
 10. distributed (``torch.distributed``; one card, so this shows
     correctness and per-rank launches, not scaling; deterministic cuDNN
     in every process): (a) NCCL with one rank: ``fit`` on a {'data': 1}
     mesh, phase 4's recipe for 2 epochs, against the one-process ``fit``
     from the same seed, per-step and validation losses within 1e-5
     relative, one warp launch per step; (b) gloo with two ranks on
     ``cuda:0`` (NCCL refuses two ranks on one card): data-parallel
     ``fit`` at global batch 10 (5 per rank), augmentation on, 2 epochs,
     against one process at batch 10: the first epoch's losses within
     1e-4 relative, both epochs' within 1e-3 (the recipe's trajectory
     amplifies a change in the order of sums: one process against itself
     with cuDNN's non-deterministic algorithms differed by 4.5e-5 to
     1.4e-4 on an H100; the per-step differences are printed),
     BatchNorm buffers equal across ranks, one warp launch per step per
     rank, and each
     rank's warp pair at 5 frames against its plain version (phase 3's
     tolerances); then the same for 1 epoch at bf16 compute with remat
     against one process with those modes, losses within 5e-3 relative
     (the CPU tests' bf16 tolerance), BatchNorm buffers equal across ranks,
     one warp launch per step per rank; (c) gloo, two ranks: ``fit_multifold`` with K = 6
     split 3 + 3 for 1 epoch, augmentation on (each rank draws one
     process's augmentation and keeps its folds' rows), every fold's
     losses within 1e-3 relative of one process, one warp launch per
     lockstep step per rank; (d) gloo, two ranks: phase 5's K = 6
     members split 3 + 3, and the rows of each batch split 2 + 2, float
     and int8 (on phase 9's scales), against one process: mean seg and
     heats within 1e-5, labels equal except where the one-process top two
     are closer than twice the seg difference, ``ensemble_batches``'
     heats within 1e-5 and labels differing on < 0.1 %. Steps/s per rank
     are of two ranks sharing one card; each run's peak less baseline per
     rank. The ranks start while this process runs the one-process
     references, and wait for a go file;
 11. JAX checkpoints and the spatial axis: (a) the committed fixture
     ``tests/fixtures/torch_port/jax_fit_d6_wf1.msgpack`` (a checkpoint
     the JAX package's ``fit`` wrote at depth 6, wf 1, 192^2, with
     momentum and plateau state; ``scripts/write_jax_ckpt_fixture.py``)
     decoded by the ``msgpack`` package (where installed) and by
     ``compat/msgpack_lite.py`` into identical trees;
     ``torch_checkpoint_from_jax`` bit-equal to the JAX exporter's state
     dict and momentum buffers (the ``.npz`` beside it); the member's
     forward on the card within 1e-4 of JAX's outputs; ``fit`` resumed
     from the msgpack file for one epoch (deterministic cuDNN,
     augmentation off) within 1e-3 relative of the JAX fit's per-step and
     validation losses; the same resume with augmentation on (from a copy
     of the conversion with the flag set), one warp launch per step;
     ``cli/export_torch_net`` run with no JAX imported. (b)-(d): two gloo
     ranks on ``cuda:0`` on a {'spatial': 2} mesh, deterministic cuDNN,
     against one process: (b) one step of phase 4's 8x recipe at full
     width (depth 6, wf 5, 192^2 from 180^2, batch 5, bands 96 + 96) from
     ``fit``'s initial weights, augmentation off: the loss within 1e-6
     relative of one process's, every gradient within twice one
     process's own float32 error of its float64 step, or of 1e-5 of the
     tensor's largest value (the row sharding is as exact as float32
     allows), BatchNorm buffers within 1e-6; then
     ``fit(shard_spatial=True)`` for 2 epochs, augmentation on, against
     phase 10(a)'s one-process run: losses within 2e-3 relative over the
     first epoch and 5e-2 over both, printed step by step beside the same
     one-process run with cuDNN's benchmark algorithms (its own float32
     spread: the recipe at LR 0.1 amplifies any reordering of sums, and
     one process against itself moved 2.25e-3 in two epochs on an NVIDIA
     H100 80GB HBM3 at 700 W),
     BatchNorm buffers equal across ranks, one warp launch per step per
     rank, steps/s and peak less baseline per rank; (c) the 2x rung
     (718 -> 736, bands 384 + 352) with bf16, remat and the streamed feed
     for one epoch, losses within 5e-3 relative of one process with the
     same modes, one warp launch per step per rank; (d) phase 8's 1x member
     over two raw 1536^2 frames (1440 rows, bands 736 + 704) through
     ``fullres_batches(mesh=...)``: labels differing from one process on
     < 0.1 % of pixels and only where its top two are within 1e-4, heats
     within 1e-4, frames/s of both. The ranks start while this process
     runs (a) and the one-process references;
 12. profiler: ``torch.profiler``'s device time of the pair at each
     geometry, the cross-check of phase 3's graph timing (last, because a
     CUDA trace slows the launches that follow it).

Any failed check raises, and the script exits non-zero without the final
line; a rank that fails makes its phase raise. On success a line ``int8
summary: {...}`` carries phase 9's rates, peaks and GEMM launches and a
line ``distributed summary: {...}`` phase 10's and a line ``spatial
summary: {...}`` phase 11's; the line before the last is a JSON object
describing the kernel (with its times at every geometry and its launches
on each path: training, resume and stream, folds, 2x and 1x ladder
training, data-parallel training in float32 and in bf16 with remat,
fold-sharded training, the augmented resume from the JAX checkpoint, and
row-sharded training at 8x and at 2x, the parallel ones counted by the
ranks), and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense), the bound's denominators
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

WARP_SOURCE = "deepfluoro_tpu_torch/csrc/affine_warp.cu"
WARP_REPLACES = "deepfluoro_tpu/ops/pallas/warp.py:59"

# (rung, batch, frame, padded frame): one training step's warps take the
# projection from frame^2 into (frame + 2 calc_pad_amount(padded, frame))^2
# and the labels within frame^2; the 8x smoke data, the archive's real 8x
# frame (179 -> 193: the odd delta rounds up, reference dataset.py:287-290)
# and the ladder's 2x and 1x rungs (scripts/e2e_ladder.sh:26-30)
GEOMETRIES = [
    ("8x", 5, 180, 192),
    ("8x", 5, 179, 192),
    ("2x", 5, 718, 736),
    ("1x", 2, 1436, 1440),
]
GRAPH_SETS = 50  # launch sets in the CUDA graph that times the device
HOST_CALLS = 200  # calls timed on the host clock for the dispatch time

# the inference phase: K members of the 8x model over synthetic frames of
# the smoke data's size (180 -> 192) and the real 8x archive's (179 -> 193)
ENSEMBLE_K = 6
INFER_FRAME = 180
INFER_FRAME_ODD = 179
CHECK_FRAMES = 6  # 180^2 frames held card against CPU (batches of 4 and 2)
CHECK_FRAMES_ODD = 3
LATENCY_FRAMES = 32  # timed at batch 1, the reference's granularity
THROUGHPUT_BATCH = 64
THROUGHPUT_FRAMES = 256
BN_CALIBRATION_FORWARDS = 20  # train-mode forwards that set a seeded member's BatchNorm statistics
DEVICE = "cuda"

# the training phases' recipe and data (the 8x paper recipe at full width)
TRAIN_FRAME = 180
TRAIN_PAD = 192
TRAIN_DEPTH = 6
TRAIN_WF = 5
FOLD_PATS = [1, 2, 3, 4, 5, 6]  # K = 6 leave-one-specimen-out folds

# the downsample ladder (scripts/e2e_ladder.sh): raw frames of the full-res
# archive, and per rung (name, factor, padded input, members, batch) for
# full-res inference: the 8x rung runs phase 5's ensemble, 2x and 1x one
# seeded member each
FULLRES_DIM = 1536
FULLRES_FRAMES = 8
FULLRES_CHECK_FRAMES = 2  # held card against CPU at each rung
FULLRES_RUNGS = [("8x", 8, TRAIN_PAD, ENSEMBLE_K, 8), ("2x", 2, 736, 1, 4), ("1x", 1, 1440, 1, 2)]
# training rungs (name, frame, padded input, batch, frames made): 13 frames
# split 12 + 1 give 3 steps of 5 per epoch, 7 frames 3 steps of 2
LADDER = [("2x", 718, 736, 5, 13), ("1x", 1436, 1440, 2, 7)]
LADDER_EPOCHS = 2

# the int8 phase: every distinct convolution of the 8x net held bit-equal
# to its plain version at INT8_CHECK_BATCH frames and timed at the
# ensemble's batch; the int8 ensemble checked on INT8_CHECK_FRAMES frames
INT8_CHECK_BATCH = 2
INT8_TIMED_ITERS = 10
INT8_CHECK_FRAMES = 2


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


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
    return smi


def phase_build():
    from deepfluoro_tpu_torch.ops._build import build_logs, library_path, load_library

    t0 = time.perf_counter()
    load_library("affine_warp")
    print("built {} in {:.2f} s".format(library_path("affine_warp"), time.perf_counter() - t0))
    for line in build_logs.get("affine_warp", "").splitlines():
        if "ptxas info" in line or "spill" in line:
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


def _graph_ms(fn, sets=GRAPH_SETS, replays=5):
    """Device time of one call of ``fn``: CUDA events around the replay of
    a CUDA graph that holds ``sets`` calls, divided by ``sets``; the median
    of ``replays`` replays, back to back (inputs as the previous call left
    them in L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(sets):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / sets)
    del graph
    return float(np.median(times))


def _host_ms(fn, calls=HOST_CALLS):
    """Host dispatch of one call: the host clock over ``calls`` calls, which
    only enqueue work, then a synchronise outside the clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / calls


def _profiled_ms(fn, kernel_name, calls=20):
    """torch.profiler's device time of ``kernel_name`` per call of ``fn``;
    None where the profiler reports no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages() if kernel_name in e.key)
    return total_us / 1e3 / calls if total_us > 0 else None


def _warp_bound(b, dim, out_dim):
    """Least time of one step's pair: the projection and the labels read
    once, both outputs written once, the matrices read once; or the float
    operations (bilinear: coordinates 10, weights 4, four taps 3 each;
    nearest: coordinates 10, rounding 2) at the float32 peak."""
    nbytes = 4 * (b * dim * dim + b * out_dim * out_dim + 2 * b * dim * dim + 6 * b)
    nops = 26 * b * out_dim * out_dim + 12 * b * dim * dim
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), nbytes, nops


def _compare(name, got, want, order):
    """Max |diff| (bilinear) or the share of differing pixels (nearest);
    raises when over its limit."""
    err = float((got - want).abs().max())
    if order == 1:
        ok = err <= 1e-4
        print("  {}: max |diff| {:.3e} (<= 1e-4) {}".format(name, err, "ok" if ok else "FAIL"))
    else:
        share = float((got != want).float().mean())
        ok = share < 1e-3
        print("  {}: {:.4%} of pixels differ (< 0.1 %) {}".format(name, share, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("kernel disagrees with its plain version: " + name)
    return err if order == 1 else 0.0


def _routes(m, out_hw, off):
    from deepfluoro_tpu_torch.ops.warp import tile_windows

    shared = tile_windows(m.cpu(), out_hw, off)["shared"]
    return int(shared.sum()), int((~shared).sum())


def phase_kernel_check(seed):
    from deepfluoro_tpu_torch.ops import image, warp
    from deepfluoro_tpu_torch.ops.image import calc_pad_amount, inverse_affine_matrix

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def fixed(dim_, angle, trans, scale, shear, n):
        m = inverse_affine_matrix((dim_ / 2.0, dim_ / 2.0), angle, trans, scale, shear)
        return m.expand(n, 2, 3).contiguous().to(dev)

    max_abs = 0.0
    geometries, pairs = [], []
    for name, b, dim, pad_dim in GEOMETRIES:
        extra = calc_pad_amount(pad_dim, dim)
        out_dim = dim + 2 * extra
        oshape, off = (out_dim, out_dim), (-extra, -extra)
        proj = torch.rand((b, dim, dim), generator=gen, device=dev)
        labels = torch.randint(0, 7, (b, dim, dim), generator=gen, device=dev).float()
        aug_m = _aug_matrices(gen, b, dim).to(dev)
        label = "{} {}->{} (batch {})".format(name, dim, out_dim, b)
        print("  {}: tiles staged in shared memory / sampled from global: projection {} / {}, labels {} / {}".format(
            label, *_routes(aug_m, oshape, off), *_routes(aug_m, (dim, dim), (0.0, 0.0))))

        # each function binds this geometry's tensors: the profiler phase calls kernel_pair again
        def kernel_pair(proj=proj, labels=labels, aug_m=aug_m, oshape=oshape, off=off):
            return warp.affine_warp_pair(proj, labels, aug_m, oshape, off)

        def plain_pair(proj=proj, labels=labels, aug_m=aug_m, oshape=oshape, off=off):
            return (image.affine_warp(proj, aug_m, 1, oshape, off), image.affine_warp(labels, aug_m, 0))

        def library_pair(proj=proj, labels=labels, aug_m=aug_m, oshape=oshape, off=off):
            return (warp.grid_sample_warp(proj, aug_m, 1, oshape, off), warp.grid_sample_warp(labels, aug_m, 0))

        got, want = kernel_pair(), plain_pair()
        torch.cuda.synchronize()
        max_abs = max(max_abs, _compare(label + " projection bilinear", got[0], want[0], 1))
        _compare(label + " labels nearest", got[1], want[1], 0)
        lib = library_pair()
        print("  {}: grid_sample_warp against the plain version: projection max |diff| {:.3e}, "
              "labels {:.4%} of pixels differ".format(label, float((lib[0] - want[0]).abs().max()),
                                                       float((lib[1] != want[1]).float().mean())))

        bound_ms, bound_by, nbytes, nops = _warp_bound(b, dim, out_dim)
        row = {
            "geometry": label,
            "device_ms": _graph_ms(kernel_pair),
            "host_ms": _host_ms(kernel_pair),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "plain_ms": _graph_ms(plain_pair),
            "library_ms": _graph_ms(library_pair),
        }
        print("  {}: one step's warps: kernel device {:.5f} ms (graph of {}), host dispatch {:.5f} ms per call, "
              "bound {:.5f} ms by {} ({} bytes, {} operations), plain {:.5f} ms, grid_sample_warp {:.5f} ms".format(
                  label, row["device_ms"], GRAPH_SETS, row["host_ms"], bound_ms, bound_by, nbytes, nops,
                  row["plain_ms"], row["library_ms"]))
        geometries.append(row)
        pairs.append(kernel_pair)

    # matrices outside the augmentation's box: the far one that needed the
    # TPU kernel's fallback, and a zoom-out whose windows exceed the budget
    b, dim, out_dim = 5, 180, 192
    extra = (out_dim - dim) // 2
    proj = torch.rand((b, dim, dim), generator=gen, device=dev)
    labels = torch.randint(0, 7, (b, dim, dim), generator=gen, device=dev).float()
    for name, m in (("far matrix", fixed(dim, 30.0, (60.0, -60.0), 0.6, (0.0, 0.0), b)),
                    ("scale 0.1", fixed(dim, 3.0, (5.0, -5.0), 0.1, (0.5, 0.5), b))):
        oshape, off = (out_dim, out_dim), (-extra, -extra)
        n_shared, n_global = _routes(m, oshape, off)
        print("  {} {}->{}: tiles staged in shared memory / sampled from global: {} / {}".format(
            name, dim, out_dim, n_shared, n_global))
        if n_global == 0:
            raise AssertionError(name + " takes no tile through the global path")
        got = warp.affine_warp_pair(proj, labels, m, oshape, off)
        torch.cuda.synchronize()
        max_abs = max(max_abs, _compare(name + " projection bilinear", got[0], image.affine_warp(proj, m, 1, oshape, off), 1))
        _compare(name + " labels nearest", got[1], image.affine_warp(labels, m, 0), 0)
        got = warp.affine_warp(labels, m, 0, oshape, off)
        _compare("{} single warp nearest {}->{}".format(name, dim, out_dim), got, image.affine_warp(labels, m, 0, oshape, off), 0)
    for orig, od in ((360, 360), (300, 320)):
        e = (od - orig) // 2
        img = torch.rand((2, orig, orig), generator=gen, device=dev)
        m = fixed(orig, -5.0, (-20.0, 20.0), 0.9, (-1.0, 1.0), 2)
        got = warp.affine_warp(img, m, 1, (od, od), (-e, -e))
        max_abs = max(max_abs, _compare("single warp {}->{} bilinear".format(orig, od), got,
                                        image.affine_warp(img, m, 1, (od, od), (-e, -e)), 1))

    main = geometries[0]  # the smoke training's geometry
    return pairs, {
        "name": "affine_warp",
        "route": "cuda",
        "source": WARP_SOURCE,
        "replaces": WARP_REPLACES,
        "max_abs_err": max_abs,
        "ms": main["device_ms"],
        "host_ms": main["host_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "geometries": geometries,
    }


def phase_profiler(pairs, kernel):
    """torch.profiler's device time of the pair at each geometry, beside
    the graph-timed device time of phase 3, and the kernels one train-mode
    forward of the 8x U-Net launches, of which the BatchNorm correction's
    are the multi-tensor ones. It runs last: after a CUDA trace the process
    launches kernels more slowly, which would bias phase 4."""
    from torch.profiler import ProfilerActivity, profile

    from deepfluoro_tpu_torch.models import UNet

    for fn, row in zip(pairs, kernel["geometries"]):
        row["profiler_ms"] = _profiled_ms(fn, "affine_warp")
        print("  {}: profiler {} per pair, graph {:.5f} ms".format(
            row["geometry"], "reports no device time" if row["profiler_ms"] is None else "{:.5f} ms".format(row["profiler_ms"]),
            row["device_ms"]))

    model = UNet(n_classes=7, depth=6, wf=5, padding=True, batch_norm=True, max_pool=False, num_lands=14).cuda().train()
    x = torch.randn((5, 1, 192, 192), device="cuda")
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    foreach = [k for k in kernels if "multi_tensor_apply" in k]
    print("  one train-mode forward of the 8x U-Net: {} kernels on the card, {} of them multi-tensor "
          "(the BatchNorm running-variance correction): {}".format(len(kernels), len(foreach),
                                                                   [k[:100] for k in foreach]))


def _smoke_data(seed):
    """The in-memory synthetic archive of the training phases: 6 specimens
    of 7 frames of TRAIN_FRAME^2."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data

    return make_synthetic_data(num_specimens=6, num_projs=7, img_dim=TRAIN_FRAME, seed=seed)


def _recipe_cfg(data, seed, **kw):
    """The 8x paper recipe (reference train_test_code/Readme.md:14-17) at
    full width: depth 6, wf 5, TRAIN_PAD^2 input, batch 5, Nesterov SGD,
    plateau LR, augmentation, a 0.85 train/valid split."""
    from deepfluoro_tpu_torch.train import TrainConfig

    base = dict(
        num_classes=7, batch_size=5, proj_unet_dim=TRAIN_PAD, optim_type="sgd", init_lr=0.1, nesterov=True,
        momentum=0.9, wgt_decay=1e-4, lr_sched_meth="plateau", depth=TRAIN_DEPTH, init_feats_exp=TRAIN_WF,
        batch_norm=True, padding=True, no_max_pool=True, data_aug=True, num_lands=data.num_lands, heat_coeff=0.5,
        train_valid_split=0.85, checkpoint_freq=1, seed=seed,
    )
    base.update(kw)
    return TrainConfig(**base)


def phase_training(seed, workdir, card):
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import fit, load_checkpoint

    data = _smoke_data(seed)
    cfg = _recipe_cfg(data, seed, max_num_epochs=2)
    ck_path = os.path.join(workdir, "check_net.pt")
    torch.cuda.reset_peak_memory_stats()
    before_fit = torch.cuda.memory_allocated()
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
    if launches != n_steps:
        raise AssertionError("warp launches {} != 1 x {} steps".format(launches, n_steps))
    print("  warp kernel launches during fit: {} (1 per step)".format(launches))

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
    per_epoch = n_steps // cfg.max_num_epochs
    first_epoch, second_epoch = out["step_seconds"][1:per_epoch], out["step_seconds"][per_epoch:]
    print("  [{}] train steps/s over the batch loops after the first step: {:.3f} "
          "(first step {:.3f} s, then median {:.4f} s/step); epoch 1 after its first step {:.3f}, epoch 2 "
          "(while epoch 1's checkpoint is written) {:.3f}".format(
        card, len(sec) / sum(sec), out["step_seconds"][0], float(np.median(sec)),
        len(first_epoch) / sum(first_epoch), len(second_epoch) / sum(second_epoch)))
    peak = torch.cuda.max_memory_allocated()
    print("  [{}] fit's peak device memory less its baseline: {} bytes (max_memory_allocated {} bytes, "
          "of which {} were allocated before fit: phase 3's inputs, kept for the profiler phase)".format(
        card, peak - before_fit, peak, before_fit))

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

    # BatchNorm running statistics (flax's update): one train-mode forward
    # of the trained weights on one batch, on the card and on the CPU
    train = data.select_pats([2, 3, 4, 5, 6]).subset(out["train_idx"][: cfg.batch_size])
    x = prepare_batch(AugmentConfig(proj_pad_dim=192, prob_of_aug=0.0), None, torch.from_numpy(train.projs))["proj"]
    card_model = copy.deepcopy(model).train()
    cpu_model = copy.deepcopy(model).cpu().train()
    with torch.no_grad():
        card_model(x.cuda())
        cpu_model(x)
    card_sd, cpu_sd = card_model.state_dict(), cpu_model.state_dict()
    keys = [k for k in cpu_sd if k.endswith("running_var")]
    rel = max(float(((card_sd[k].cpu() - cpu_sd[k]).abs() / cpu_sd[k].abs().clamp_min(1e-30)).max()) for k in keys)
    print("  train-mode forward, card vs CPU: {} running variances agree to {:.2e} relative (<= 1e-4)".format(len(keys), rel))
    if not keys or rel > 1e-4:
        raise AssertionError("BatchNorm running variances differ between card and CPU")
    return launches, ck_path


def _seeded_member(cfg, seed, proj):
    """A member of ``cfg``'s architecture whose convolutions are drawn from a
    seeded ``torch.Generator`` (He-normal weights, zero biases), with its
    BatchNorm running statistics then taken from the frames ``proj`` by
    ``BN_CALIBRATION_FORWARDS`` train-mode forwards without a gradient. A
    random net whose statistics stay at mean 0 and variance 1 grows its
    activations level by level, and its logits then reach a scale at which
    the card's and the CPU's rounding move the softmax by 1e-4; calibrated,
    it has the scale of a trained member."""
    from deepfluoro_tpu_torch.train.config import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu", generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
        model.to(proj.device).train()
        for _ in range(BN_CALIBRATION_FORWARDS):
            model(proj)
    return model.eval()


def _forward_flops(cfg):
    """Floating-point operations of one member's eval forward of one padded
    frame, counted by ``torch.utils.flop_counter`` on the meta device
    (convolutions and matrix products; 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    from deepfluoro_tpu_torch.train.config import build_model

    model = build_model(cfg).to("meta").eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros((1, 1, cfg.proj_unet_dim, cfg.proj_unet_dim), device="meta"))
    return counter.get_total_flops()


def _consume(batches):
    """Run an ``ensemble_batches`` generator to its end. Returns the
    concatenated labels and heats, and the frames per second on the host's
    clock from the first batch's arrival to the end (warm-up and the first
    batch excluded; readback included)."""
    labels, heats, t_first, n_first = [], [], None, 0
    for _, lab, hts in batches:
        if t_first is None:
            t_first, n_first = time.perf_counter(), lab.shape[0]
        labels.append(lab)
        heats.append(hts)
    rest = sum(l.shape[0] for l in labels) - n_first
    fps = rest / (time.perf_counter() - t_first) if rest else float("nan")
    return np.concatenate(labels), np.concatenate(heats), fps


def _check_against_cpu(name, data, models, cpu_models, cfg):
    """The card's ensemble (``ensemble_batches``, batches of 4, and
    ``ensemble_forward`` for the mean seg) against the CPU's on the same
    members and frames; then landmark detection and hard Dice on one
    device against the other, on the same inputs."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.data.fixtures import DEFAULT_LAND_NAMES
    from deepfluoro_tpu_torch.eval import detect_landmarks, hard_dice
    from deepfluoro_tpu_torch.infer import ensemble_batches, ensemble_forward
    from deepfluoro_tpu_torch.ops.heatmap import synthesize_heatmaps

    hw = data.orig_img_shape
    labels_d, heats_d, _ = _consume(ensemble_batches(data, models, cfg.num_lands, None, 4, cfg.proj_unet_dim))
    proj = prepare_batch(AugmentConfig(proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.0), None, torch.from_numpy(data.projs))["proj"]
    seg_d = ensemble_forward(models, proj.to(DEVICE), hw, cfg.num_lands)[0].cpu()
    seg_c, heats_c, labels_c = ensemble_forward(cpu_models, proj, hw, cfg.num_lands)
    seg_err = float((seg_d - seg_c).abs().max())
    heat_err = float(np.abs(heats_d - heats_c.numpy()).max())
    differ = labels_d != labels_c.numpy()
    top2 = torch.topk(seg_c, 2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    worst = float(margin[differ].max()) if differ.any() else 0.0
    print("  {} (padded to {}^2): card vs CPU: mean seg max |diff| {:.2e} (<= 1e-3), heats {:.2e} (<= 1e-3), "
          "labels differ on {:.4%} of pixels (< 0.1 %), largest CPU top-two margin there {:.2e} (<= 1e-4); "
          "{:.4%} of pixels have a margin <= 1e-4".format(
              name, proj.shape[-1], seg_err, heat_err, differ.mean(), worst, (margin <= 1e-4).mean()))
    if tuple(labels_d.shape) != (len(data), *hw) or tuple(heats_d.shape) != (len(data), cfg.num_lands, *hw):
        raise AssertionError("ensemble output shapes {} {}".format(labels_d.shape, heats_d.shape))
    if int(labels_d.max()) >= cfg.num_classes or not np.isfinite(heats_d).all():
        raise AssertionError("labels out of range or non-finite heats on " + name)
    if seg_err > 1e-3 or heat_err > 1e-3 or differ.mean() >= 1e-3 or worst > 1e-4:
        raise AssertionError("card and CPU ensembles disagree on " + name)

    names = DEFAULT_LAND_NAMES[: cfg.num_lands]
    true_heats = synthesize_heatmaps(torch.from_numpy(data.lands), *hw)
    for what, heats, segs in (("ensemble heats and labels", heats_c, labels_c),
                              ("true landmarks' heatmaps and label maps", true_heats, torch.from_numpy(data.segs))):
        rows_c, cols_c = detect_landmarks(heats, names, segs)
        rows_d, cols_d = detect_landmarks(heats.to(DEVICE), names, segs.to(DEVICE))
        print("  {}: detect_landmarks on the {}: {} of {} found on the CPU, card equal: {}".format(
            name, what, int((rows_c >= 0).sum()), rows_c.size, bool((rows_c == rows_d).all() and (cols_c == cols_d).all())))
        if not ((rows_c == rows_d).all() and (cols_c == cols_d).all()):
            raise AssertionError("landmark detection differs between card and CPU on " + name)
    gt = torch.from_numpy(data.segs)
    dice_c, dice_d = hard_dice(gt, labels_c, cfg.num_classes), hard_dice(gt.to(DEVICE), labels_c.to(DEVICE), cfg.num_classes)
    print("  {}: hard Dice of the CPU's labels, card equal: {} (mean {:.4f})".format(
        name, bool(np.array_equal(dice_c, dice_d)), float(dice_c.mean())))
    if not np.array_equal(dice_c, dice_d):
        raise AssertionError("hard Dice differs between card and CPU on " + name)
    return heats_d, labels_d


def phase_inference(seed, workdir, trained_ck, card):
    """The ensemble on the card: members saved and reloaded, checked
    against the CPU, then timed. The warp kernel is not on this path
    (inference does no augmentation): its count must stay 0."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.data.fixtures import DEFAULT_LAND_NAMES, make_synthetic_data
    from deepfluoro_tpu_torch.eval import detect_landmarks_timed
    from deepfluoro_tpu_torch.infer import ensemble_batches, load_net_from_checkpoint
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()

    model, cfg = load_net_from_checkpoint(trained_ck, device=DEVICE)
    models = [model]
    frames = make_synthetic_data(num_specimens=1, num_projs=CHECK_FRAMES, img_dim=INFER_FRAME, seed=seed + 1)
    odd = make_synthetic_data(num_specimens=1, num_projs=CHECK_FRAMES_ODD, img_dim=INFER_FRAME_ODD, seed=seed + 2)
    calib = prepare_batch(AugmentConfig(proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.0), None,
                          torch.from_numpy(frames.projs).to(DEVICE))["proj"]
    for i in range(1, ENSEMBLE_K):
        path = os.path.join(workdir, "member_{}.pt".format(i))
        save_checkpoint(path, cfg, _seeded_member(cfg, seed * 1000 + i, calib))
        models.append(load_net_from_checkpoint(path, device=DEVICE, verbose=False)[0])
    if not all(next(m.parameters()).device.type == DEVICE and not m.training for m in models):
        raise AssertionError("a member is not on the card in eval mode")
    flops = _forward_flops(cfg)
    print("  {} members of depth {}, wf {}, {} classes, {} landmarks, {}^2 input; one member's forward of one "
          "frame: {} floating-point operations (torch.utils.flop_counter), {} parameters".format(
              len(models), cfg.depth, cfg.init_feats_exp, cfg.num_classes, cfg.num_lands, cfg.proj_unet_dim, flops,
              sum(p.numel() for p in model.parameters())))
    cpu_models = [copy.deepcopy(m).cpu() for m in models]
    heats, labels = _check_against_cpu("{}^2 frames".format(INFER_FRAME), frames, models, cpu_models, cfg)
    _check_against_cpu("{}^2 frames".format(INFER_FRAME_ODD), odd, models, cpu_models, cfg)
    del cpu_models

    # the timed runs: the main path of this phase, with the kernel counts at 0
    warp.warp_launches = 0
    latency = make_synthetic_data(num_specimens=1, num_projs=LATENCY_FRAMES, img_dim=INFER_FRAME, seed=seed + 3)
    times = []
    _consume(ensemble_batches(latency, models, cfg.num_lands, times, 1, cfg.proj_unet_dim))
    print("  [{}] per-image latency at batch 1, K = {}, {}^2 -> {}^2, float32 (--times contract, {} frames): "
          "median {:.3f} ms, min {:.3f} ms, max {:.3f} ms".format(
              card, len(models), INFER_FRAME, cfg.proj_unet_dim, len(times), 1e3 * float(np.median(times)),
              1e3 * min(times), 1e3 * max(times)))
    bulk = make_synthetic_data(num_specimens=1, num_projs=THROUGHPUT_FRAMES, img_dim=INFER_FRAME, seed=seed + 4)
    for k in (len(models), 1):
        times = []
        _, _, wall_fps = _consume(ensemble_batches(bulk, models[:k], cfg.num_lands, times, THROUGHPUT_BATCH, cfg.proj_unet_dim))
        fps = len(times) / sum(times)
        print("  [{}] ensemble frames/s at batch {}, K = {}, {}^2 -> {}^2, float32: {:.1f} by the --times contract "
              "(pad, z-norm, forwards, mean, argmax; {} frames), {:.1f} with the readback of labels and heats; "
              "convolutions at {:.2f} TFLOP/s, the float32 peak's bound {:.1f} frames/s".format(
                  card, THROUGHPUT_BATCH, k, INFER_FRAME, cfg.proj_unet_dim, fps, len(times), wall_fps,
                  fps * k * flops / 1e12, FP32_FLOPS_PER_S / (k * flops)))
    launches = warp.warp_launches

    heats, labels = torch.from_numpy(heats).to(DEVICE), torch.from_numpy(labels).to(DEVICE)
    _, _, det_times = detect_landmarks_timed(heats, DEFAULT_LAND_NAMES[: cfg.num_lands], labels)
    per_frame = det_times.sum(axis=1)
    print("  [{}] landmark detection per frame ({} landmarks, {}^2, seg-gated, one dispatch per frame): "
          "median {:.3f} ms over {} frames".format(card, cfg.num_lands, INFER_FRAME, 1e3 * float(np.median(per_frame)),
                                                 len(per_frame)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print("  [{}] inference phase peak device memory less its baseline: {} bytes (max_memory_allocated {} bytes, "
          "baseline {} bytes)".format(card, peak - baseline, peak, baseline))
    print("  warp kernel launches during the timed inference runs: {} (no kernel on this path)".format(launches))
    if launches != 0:
        raise AssertionError("inference launched the warp kernel")
    return [trained_ck] + [os.path.join(workdir, "member_{}.pt".format(i)) for i in range(1, ENSEMBLE_K)]


def _card(card):
    return "[{}]".format(card)


def _sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _fit_files(workdir, tag):
    return {k: os.path.join(workdir, "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


def _lines(path):
    with open(path) as f:
        return len(f.readlines())


def phase_resume_and_stream(seed, workdir, card):
    """``fit`` on the 8x recipe beyond a fresh run: 1 epoch, then resumed to
    2 from its checkpoint; a run stopped by SIGTERM in its first epoch,
    with light best nets; the streaming feed against the resident one with
    augmentation off and deterministic cuDNN. Returns the warp launches of
    the augmented runs, which must be 1 per step."""
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import fit, load_checkpoint
    from deepfluoro_tpu_torch.train import loop as loop_mod

    data = _smoke_data(seed)
    pats = [2, 3, 4, 5, 6]
    files = _fit_files(workdir, "resume")
    warp.warp_launches = 0
    first = fit(data, pats, _recipe_cfg(data, seed, max_num_epochs=1), verbose=False, device=DEVICE, **files)
    resumed = fit(data, pats, _recipe_cfg(data, seed, max_num_epochs=2), verbose=False, device=DEVICE, **files)
    _sync()
    launches = warp.warp_launches
    steps = len(first["train_losses"]) + len(resumed["train_losses"])
    ck = load_checkpoint(files["checkpoint_filename"])
    opt_state = [t for st in resumed["optimizer"].state.values() for t in st.values() if torch.is_tensor(t)]
    print("  resume: epoch {} -> {}, split reused: {}, loss logs {} + {} train lines and {} valid lines, "
          "{} parameters and {} optimizer tensors on {}".format(
              first["epoch"], resumed["epoch"], resumed["train_idx"] == first["train_idx"],
              len(first["train_losses"]), len(resumed["train_losses"]), _lines(files["valid_loss_txt"]),
              sum(1 for _ in resumed["model"].parameters()), len(opt_state), DEVICE))
    if (first["epoch"], resumed["epoch"], ck["epoch"]) != (1, 2, 2) or resumed["train_idx"] != first["train_idx"]:
        raise AssertionError("the resumed run did not go on from its checkpoint")
    if _lines(files["train_loss_txt"]) != steps or _lines(files["valid_loss_txt"]) != 2:
        raise AssertionError("the resumed run's loss logs were not appended to")
    if not opt_state or not all(t.device.type == DEVICE for t in list(resumed["model"].state_dict().values()) + opt_state):
        raise AssertionError("a restored tensor is off the card")

    # SIGTERM in the first epoch: the run ends after that epoch, with its checkpoint
    real_step, calls = loop_mod.train_step, []

    def step_then_sigterm(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.SIG_IGN, None):
                raise AssertionError("fit installed no SIGTERM handler")
            signal.raise_signal(signal.SIGTERM)
        return real_step(*args, **kwargs)

    files = _fit_files(workdir, "sigterm")
    loop_mod.train_step = step_then_sigterm
    try:
        stopped = fit(data, pats, _recipe_cfg(data, seed, max_num_epochs=5, light_best_nets=True), verbose=False,
                      device=DEVICE, **files)
    finally:
        loop_mod.train_step = real_step
    _sync()
    full, light = os.path.getsize(files["checkpoint_filename"]), os.path.getsize(files["best_valid_filename"])
    print("  SIGTERM at step 2: stopped after epoch {} with a checkpoint of epoch {}; light best net {} B, "
          "{:.3f} of the full checkpoint's {} B".format(
              stopped["epoch"], load_checkpoint(files["checkpoint_filename"])["epoch"], light, light / full, full))
    if stopped["epoch"] != 1 or load_checkpoint(files["checkpoint_filename"])["epoch"] != 1:
        raise AssertionError("the SIGTERM run did not stop after its epoch with a checkpoint")
    if light >= 0.75 * full:
        raise AssertionError("the light best net is not light")
    aug_steps = steps + len(stopped["train_losses"])
    launches = warp.warp_launches
    print("  warp kernel launches in the augmented runs: {} in {} steps".format(launches, aug_steps))
    if launches != aug_steps:
        raise AssertionError("warp launches {} != 1 x {} augmented steps".format(launches, aug_steps))

    # the streaming feed against the resident one, augmentation off
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses = {}
        for stream in (False, True):
            out = fit(data, pats, _recipe_cfg(data, seed, max_num_epochs=1, data_aug=False), verbose=False,
                      stream_data=stream, device=DEVICE, **_fit_files(workdir, "stream{}".format(stream)))
            losses[stream] = np.array(out["train_losses"] + out["valid_losses"])
            sec = out["step_seconds"][1:]
            print("  {} {} feed: {} steps, {:.3f} steps/s after the first step".format(
                _card(card), "streamed" if stream else "resident", len(out["train_losses"]), len(sec) / sum(sec)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = float(np.max(np.abs(losses[True] - losses[False]) / np.abs(losses[False])))
    print("  streamed against resident, augmentation off, deterministic cuDNN: per-step and validation losses "
          "within {:.2e} relative (<= 1e-4)".format(rel))
    if rel > 1e-4:
        raise AssertionError("the streamed feed's losses differ from the resident feed's")
    return launches


def phase_folds(seed, workdir, card, kernel):
    """``fit_multifold`` over K = 6 folds at full width for 2 epochs, then
    resumed to a third; the warp pair at the fold step's K*B frames
    against its plain version; the six best nets loaded; one lockstep step
    on the card against the CPU. Returns the warp launches of the runs."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
    from deepfluoro_tpu_torch.ops import image, warp
    from deepfluoro_tpu_torch.ops.image import calc_pad_amount
    from deepfluoro_tpu_torch.train import make_optimizer
    from deepfluoro_tpu_torch.train.multifold import fit_multifold, multifold_step

    data = _smoke_data(seed)
    k_folds = len(FOLD_PATS)
    prefixes = dict(checkpoint_prefix=os.path.join(workdir, "fold_ck"), best_prefix=os.path.join(workdir, "fold_best"),
                    valid_loss_txt_prefix=os.path.join(workdir, "fold_valid"))
    cfg = _recipe_cfg(data, seed, max_num_epochs=2, light_best_nets=True)
    _sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    warp.warp_launches = 0
    t0 = time.perf_counter()
    out = fit_multifold(data, FOLD_PATS, cfg, verbose=False, device=DEVICE, **prefixes)
    more = fit_multifold(data, FOLD_PATS, _recipe_cfg(data, seed, max_num_epochs=3), verbose=False, device=DEVICE,
                         **prefixes)
    _sync()
    wall = time.perf_counter() - t0
    launches = warp.warp_launches
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    steps = len(out["train_losses"]) + len(more["train_losses"])
    losses = np.concatenate([np.array(out["train_losses"] + more["train_losses"]).ravel(),
                             np.array(out["valid_losses"] + more["valid_losses"]).ravel()])
    print("  {} folds in lockstep: epochs {} then {} (resumed), {} lockstep steps of K*B = {} frames in {:.1f} s; "
          "best valid {}".format(k_folds, out["epoch"], more["epoch"], steps, k_folds * cfg.batch_size, wall,
                                 ["%.4f" % v for v in more["best_valid_losses"]]))
    if (out["epoch"], more["epoch"]) != (2, 3) or not np.isfinite(losses).all():
        raise AssertionError("fold training did not run 2 + 1 epochs with finite losses")
    if any(not np.array_equal(a, b) for a, b in zip(out["train_idx"], more["train_idx"])):
        raise AssertionError("the resumed folds did not reuse their splits")
    print("  warp kernel launches during fold training: {} in {} lockstep steps (1 per step)".format(launches, steps))
    if launches != steps:
        raise AssertionError("warp launches {} != 1 x {} lockstep steps".format(launches, steps))
    sec = out["step_seconds"][1:] + more["step_seconds"][1:]
    rate = len(sec) / sum(sec)
    print("  {} lockstep steps/s after each session's first step: {:.3f}; fold-steps/s {:.3f} (K = {}, batch {})".format(
        _card(card), rate, rate * k_folds, k_folds, cfg.batch_size))
    print("  {} fold phase's peak device memory less its baseline: {} bytes (max_memory_allocated {} bytes, "
          "baseline {} bytes)".format(_card(card), peak - baseline, peak, baseline))

    # the six best nets, each a standard checkpoint
    for p in FOLD_PATS:
        model, loaded = load_net_from_checkpoint("{}_spec{:02d}.pt".format(prefixes["best_prefix"], p), device=DEVICE,
                                                 verbose=False)
        if next(model.parameters()).device.type != DEVICE or loaded.depth != TRAIN_DEPTH:
            raise AssertionError("fold net {} did not load".format(p))
    print("  {} best nets loaded through load_net_from_checkpoint".format(k_folds))

    # the kernel against its plain version at the fold step's batch
    b = k_folds * cfg.batch_size
    extra = calc_pad_amount(TRAIN_PAD, TRAIN_FRAME)
    out_dim = TRAIN_FRAME + 2 * extra
    oshape, off = (out_dim, out_dim), (-extra, -extra)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 7)
    proj = torch.rand((b, TRAIN_FRAME, TRAIN_FRAME), generator=gen, device=DEVICE)
    labels = torch.randint(0, 7, (b, TRAIN_FRAME, TRAIN_FRAME), generator=gen, device=DEVICE).float()
    aug_m = _aug_matrices(gen, b, TRAIN_FRAME).to(DEVICE)
    label = "8x {}->{} (batch {}, the fold step)".format(TRAIN_FRAME, out_dim, b)

    def kernel_pair():
        return warp.affine_warp_pair(proj, labels, aug_m, oshape, off)

    def plain_pair():
        return image.affine_warp(proj, aug_m, 1, oshape, off), image.affine_warp(labels, aug_m, 0)

    def library_pair():
        return warp.grid_sample_warp(proj, aug_m, 1, oshape, off), warp.grid_sample_warp(labels, aug_m, 0)

    got, want = kernel_pair(), plain_pair()
    _sync()
    err = _compare(label + " projection bilinear", got[0], want[0], 1)
    _compare(label + " labels nearest", got[1], want[1], 0)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    if DEVICE == "cuda":
        bound_ms, bound_by, nbytes, nops = _warp_bound(b, TRAIN_FRAME, out_dim)
        row = {"geometry": label, "device_ms": _graph_ms(kernel_pair), "host_ms": _host_ms(kernel_pair),
               "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": _graph_ms(plain_pair),
               "library_ms": _graph_ms(library_pair)}
        print("  {} {}: kernel device {:.5f} ms (graph of {}), host dispatch {:.5f} ms per call, bound {:.5f} ms by {} "
              "({} bytes, {} operations), plain {:.5f} ms, grid_sample_warp {:.5f} ms".format(
                  _card(card), label, row["device_ms"], GRAPH_SETS, row["host_ms"], bound_ms, bound_by, nbytes, nops,
                  row["plain_ms"], row["library_ms"]))
        kernel["geometries"].append(row)

    # one lockstep step on the card against the same step on the CPU
    idx = np.stack([t[: cfg.batch_size] for t in more["train_idx"]]).reshape(-1)
    batch = tuple(torch.from_numpy(a[idx]) for a in (data.projs, data.segs, data.lands))
    aug_off = AugmentConfig(num_classes=cfg.num_classes, proj_pad_dim=TRAIN_PAD, prob_of_aug=0.0)
    results = {}
    for dev in (DEVICE, "cpu"):
        models = [copy.deepcopy(m).to(dev) for m in more["models"]]
        opts = [make_optimizer(cfg, m.parameters()) for m in models]
        lrs = [o.param_groups[0]["lr"] for o in more["optimizers"]]
        results[dev] = multifold_step(models, opts, cfg, aug_off, None, tuple(t.to(dev) for t in batch), lrs).cpu().numpy()
    rel = float(np.max(np.abs(results[DEVICE] - results["cpu"]) / np.abs(results["cpu"])))
    print("  one lockstep step, card against CPU, augmentation off: fold losses {} within {:.2e} relative "
          "(<= 1e-3)".format(["%.5f" % v for v in results["cpu"]], rel))
    if rel > 1e-3:
        raise AssertionError("the lockstep step differs between card and CPU")
    return launches


def _peak_start():
    """Reset the peak-memory counter; returns the bytes allocated now."""
    _sync()
    if DEVICE != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_since(baseline):
    _sync()
    return torch.cuda.max_memory_allocated() - baseline if DEVICE == "cuda" else 0


def _fullres_rung(name, factor, pad, models, cpu_models, spec, batch, card):
    """One rung of full-res inference: the prep and the ensemble on the card
    against the CPU on the first FULLRES_CHECK_FRAMES raw frames, then the
    frames/s of ``fullres_batches`` over all of them (the --times
    contract) and the rung's peak memory less its baseline. A label may
    differ only where the CPU's top two mean probabilities are closer than
    twice the largest probability difference (no other pixel can flip),
    and that difference must stay within 1e-3."""
    from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep
    from deepfluoro_tpu_torch.infer import ensemble_forward
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches

    full_hw = spec["projs"].shape[1:]
    baseline = _peak_start()
    prep, hw = make_fullres_prep(factor, pad, full_hw)
    nchk = FULLRES_CHECK_FRAMES
    projs, rots = torch.from_numpy(spec["projs"][:nchk]), torch.from_numpy(spec["rots"][:nchk])
    x_c = prep(projs, rots)
    x_d = prep(projs.to(DEVICE), rots.to(DEVICE))
    prep_err = float((x_d.cpu() - x_c).abs().max())
    seg_c, heats_c, labels_c = ensemble_forward(cpu_models, x_c, hw, cpu_models[0].num_lands)
    seg_err = float((ensemble_forward(models, x_d, hw, models[0].num_lands)[0].cpu() - seg_c).abs().max())
    del x_d

    def read_batch(i0, i1):
        return spec["projs"][i0:i1], spec["rots"][i0:i1]

    got = list(fullres_batches(read_batch, nchk, full_hw, models, factor, models[0].num_lands, None, batch, pad))
    labels_d = np.concatenate([l for _, l, _ in got])
    heats_d = np.concatenate([h for _, _, h in got])
    heat_err = float(np.abs(heats_d - heats_c.numpy()).max())
    differ = labels_d != labels_c.numpy()
    top2 = torch.topk(seg_c, 2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    worst = float(margin[differ].max()) if differ.any() else 0.0
    print("  {} rung ({}^2 raw -> {}^2, padded to {}^2, K = {}): card vs CPU on {} frames: prep max |diff| {:.2e} "
          "(<= 1e-5), mean seg {:.2e} (<= 1e-3), heats {:.2e} (<= 1e-3), labels differ on {:.4%} of pixels "
          "(< 0.1 %), largest CPU top-two margin there {:.2e} (<= twice the seg difference); {:.4%} of pixels have "
          "a margin <= 1e-4".format(name, full_hw[0], hw[0], x_c.shape[-1], len(models), nchk, prep_err, seg_err,
                                     heat_err, differ.mean(), worst, (margin <= 1e-4).mean()))
    if tuple(labels_d.shape) != (nchk, *hw) or not np.isfinite(heats_d).all():
        raise AssertionError("full-res output shapes {} or non-finite heats at {}".format(labels_d.shape, name))
    if prep_err > 1e-5 or seg_err > 1e-3 or heat_err > 1e-3 or differ.mean() >= 1e-3 or worst > 2 * seg_err:
        raise AssertionError("card and CPU full-res inference disagree at " + name)

    times = []
    for _ in fullres_batches(read_batch, len(spec["projs"]), full_hw, models, factor, models[0].num_lands, times,
                             batch, pad):
        pass
    print("  {} {} rung: {:.2f} frames/s at batch {}, K = {}, over {} raw {}^2 frames (--times contract: copy to "
          "the card, prep, forwards, mean, argmax); peak device memory less its baseline {} bytes".format(
              _card(card), name, len(times) / sum(times), batch, len(models), len(times), full_hw[0],
              _peak_since(baseline)))


def _ladder_fit(seed, workdir, rung, frame, pad, batch, n_frames, card):
    """``fit`` at full width on one rung with bfloat16 compute, remat and
    the streamed feed (scripts/e2e_ladder.sh:64-72), augmentation on, for
    LADDER_EPOCHS epochs; one warp launch per step. Returns (launches,
    fit's output, checkpoint path, data)."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import fit

    data = make_synthetic_data(num_specimens=1, num_projs=n_frames, img_dim=frame, seed=seed + frame)
    cfg = _recipe_cfg(data, seed, proj_unet_dim=pad, batch_size=batch, max_num_epochs=LADDER_EPOCHS,
                      compute_dtype="bfloat16", remat=True)
    files = _fit_files(workdir, "ladder" + rung)
    baseline = _peak_start()
    warp.warp_launches = 0
    out = fit(data, [1], cfg, verbose=False, stream_data=True, device=DEVICE, **files)
    _sync()
    launches = warp.warp_launches
    peak = _peak_since(baseline)
    steps = len(out["train_losses"])
    losses = out["train_losses"] + out["valid_losses"]
    sec = out["step_seconds"][1:]
    print("  {} {} training, {}^2 -> {}^2, batch {}, bf16 + remat + streamed feed, augmentation on: {} steps in {} "
          "epochs, {:.3f} steps/s after the first step ({:.3f} s); losses {}; peak device memory less its baseline "
          "{} bytes".format(_card(card), rung, frame, pad, batch, steps, out["epoch"], len(sec) / sum(sec),
                            out["step_seconds"][0], ["%.4f" % l for l in losses], peak))
    if not all(math.isfinite(l) for l in losses) or out["epoch"] != LADDER_EPOCHS:
        raise AssertionError("{} training did not run {} epochs with finite losses".format(rung, LADDER_EPOCHS))
    model = out["model"]
    if model.dtype != torch.bfloat16 or not model.remat or not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError("{} training did not run bf16 compute with remat and float32 weights".format(rung))
    print("  warp kernel launches during {} training: {} in {} steps (1 per step)".format(rung, launches, steps))
    if launches != steps:
        raise AssertionError("warp launches {} != 1 x {} steps at {}".format(launches, steps, rung))
    return launches, out, files["checkpoint_filename"], data


def _grad_step(model, cfg, prepared):
    """One train-mode forward and backward of the training loss, no update:
    (loss, {name: grad}, BatchNorm buffers, peak memory less baseline)."""
    from deepfluoro_tpu_torch.train.step import per_sample_losses

    baseline = _peak_start()
    model.train()
    model.zero_grad(set_to_none=True)
    loss = per_sample_losses(cfg, model(prepared["proj"]), prepared["seg"], prepared["heats"], True).mean()
    loss.backward()
    peak = _peak_since(baseline)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}
    buffers = {k: v.detach().clone() for k, v in model.named_buffers()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, buffers, peak


def _grad_diff(a, b):
    """The largest, over tensors, of max |a - b| over max |b|."""
    return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30) for k in b)


def _grad_norm_diff(a, b):
    """||a - b|| over ||b||, all tensors as one vector."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
    return math.sqrt(num / sum(float(b[k].double().square().sum()) for k in b))


def _ladder_checks(out, ck_path, data, cfg_pad, card):
    """At 2x, from the trained weights and one training batch, augmentation
    off and cuDNN deterministic: remat against no remat in float32, bf16
    against float32, and the bf16 checkpoint reloaded for inference."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint

    cfg = out["cfg"]
    rows = data.subset(out["train_idx"][: cfg.batch_size])
    aug_off = AugmentConfig(num_classes=cfg.num_classes, proj_pad_dim=cfg_pad, prob_of_aug=0.0)
    batch = tuple(torch.from_numpy(a).to(DEVICE) for a in (rows.projs, rows.segs, rows.lands))
    prepared = prepare_batch(aug_off, None, *batch)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps = {}
        for dtype, remat in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, False)):
            model = copy.deepcopy(out["model"])
            model.dtype, model.remat = dtype, remat
            steps[(dtype, remat)] = _grad_step(model, cfg, prepared)
            del model
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, remat, bf16 = steps[(torch.float32, False)], steps[(torch.float32, True)], steps[(torch.bfloat16, False)]
    loss_rel = abs(remat[0] - plain[0]) / abs(plain[0])
    grad_rel = _grad_diff(remat[1], plain[1])
    buffers_equal = remat[2].keys() == plain[2].keys() and all(torch.equal(remat[2][k], plain[2][k]) for k in plain[2])
    print("  {} 2x step, remat against no remat, float32, deterministic cuDNN: loss {:.6f} vs {:.6f}, {:.2e} "
          "relative (<= 1e-6); gradients within {:.2e} of each tensor's largest (<= 1e-5); BatchNorm buffers "
          "equal: {}; peak device memory less its baseline {} bytes with remat, {} without".format(
              _card(card), remat[0], plain[0], loss_rel, grad_rel, buffers_equal, remat[3], plain[3]))
    if loss_rel > 1e-6 or grad_rel > 1e-5 or not buffers_equal:
        raise AssertionError("the remat step differs from the plain step")
    loss_rel = abs(bf16[0] - plain[0]) / abs(plain[0])
    grad_rel = _grad_diff(bf16[1], plain[1])
    print("  {} 2x step, bf16 against float32: loss {:.6f} vs {:.6f}, {:.2e} relative (<= 2e-2); gradients {:.2e} "
          "relative in norm, within {:.2e} of each tensor's largest; peak device memory less its baseline {} "
          "bytes".format(_card(card), bf16[0], plain[0], loss_rel, _grad_norm_diff(bf16[1], plain[1]), grad_rel,
                         bf16[3]))
    if loss_rel > 2e-2 or not all(torch.isfinite(g).all() for g in bf16[1].values()):
        raise AssertionError("the bf16 step is too far from the float32 step")

    model, loaded = load_net_from_checkpoint(ck_path, device=DEVICE, verbose=False)
    twin = copy.deepcopy(model)
    twin.dtype = torch.float32
    with torch.no_grad():
        seg, heats = model(prepared["proj"])
        seg_f, heats_f = twin(prepared["proj"])
    err = float((seg - seg_f).abs().max())
    print("  bf16 checkpoint reloaded through load_net_from_checkpoint: compute-dtype {}, model dtype {}, remat {}; "
          "outputs {} / {}, eval seg within {:.2e} of its float32 twin (bf16 ran: > 0; <= 5e-2)".format(
              loaded.compute_dtype, model.dtype, model.remat, seg.dtype, heats.dtype, err))
    if model.dtype != torch.bfloat16 or seg.dtype != torch.float32 or not 0 < err <= 5e-2:
        raise AssertionError("the bf16 checkpoint did not load and run in bf16")


def phase_ladder(seed, workdir, member_paths, card):
    """The downsample ladder: (a) raw FULLRES_DIM^2 frames through the fused
    prep and the ensemble at 8x (phase 5's members), 2x and 1x (a seeded
    member each), card against CPU, frames/s and peak memory per rung, no
    warp launch; (b) ``fit`` at 2x and 1x with bf16, remat and the streamed
    feed, one warp launch per step, then the 2x checks. Returns the warp
    launches of the 2x and 1x training runs."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data
    from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=FULLRES_FRAMES, img_dim=FULLRES_DIM, seed=seed + 5)[0]
    print("  {} raw {}^2 frames made from the seed in {:.1f} s ({} with the rot-180 flag)".format(
        FULLRES_FRAMES, FULLRES_DIM, time.perf_counter() - t0, int(spec["rots"].sum())))
    warp.warp_launches = 0
    for name, factor, pad, k, batch in FULLRES_RUNGS:
        if k > 1:
            members = [load_net_from_checkpoint(p, device=DEVICE, verbose=False) for p in member_paths[:k]]
            models = [m for m, _ in members]
            if members[0][1].proj_unet_dim != pad:
                raise AssertionError("phase 5's members are not padded to {}".format(pad))
        else:
            data_cfg = _recipe_cfg(types.SimpleNamespace(num_lands=spec["lands"].shape[-1]), seed, proj_unet_dim=pad)
            prep, _ = make_fullres_prep(factor, pad, spec["projs"].shape[1:])
            calib = prep(torch.from_numpy(spec["projs"][:batch]).to(DEVICE), torch.from_numpy(spec["rots"][:batch]).to(DEVICE))
            path = os.path.join(workdir, "fullres_{}.pt".format(name))
            save_checkpoint(path, data_cfg, _seeded_member(data_cfg, seed * 1000 + pad, calib))
            del calib
            models = [load_net_from_checkpoint(path, device=DEVICE, verbose=False)[0]]
        cpu_models = [copy.deepcopy(m).cpu() for m in models]
        _fullres_rung(name, factor, pad, models, cpu_models, spec, batch, card)
        del models, cpu_models
    launches = warp.warp_launches
    print("  warp kernel launches during full-res inference: {} (no kernel on this path)".format(launches))
    if launches != 0:
        raise AssertionError("full-res inference launched the warp kernel")
    del spec

    counts = {}
    for rung, frame, pad, batch, n_frames in LADDER:
        counts[rung], out, ck_path, data = _ladder_fit(seed, workdir, rung, frame, pad, batch, n_frames, card)
        if rung == "2x":
            _ladder_checks(out, ck_path, data, pad, card)
        del out, data
    return counts


def _event_ms(fn, iters=INT8_TIMED_ITERS):
    """Device time of one call of ``fn``: CUDA events around ``iters`` calls
    after two warm-up calls (the calls allocate, so no CUDA graph)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _conv_shapes(cfg):
    """The distinct convolutions of ``cfg``'s net at its padded input, in
    forward order: (kind, in channels, H, W, out channels, kernel, stride,
    padding), read by forward hooks on a meta-device forward."""
    from deepfluoro_tpu_torch.train.config import build_model

    model = build_model(cfg).to("meta").eval()
    shapes = []

    def hook(mod, args, _out):
        c, h, w = args[0].shape[1:]
        kind = "transpose" if isinstance(mod, torch.nn.ConvTranspose2d) else "conv"
        o = mod.out_channels
        key = (kind, c, h, w, o, mod.kernel_size[0], mod.stride[0], mod.padding[0])
        if key not in shapes:
            shapes.append(key)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros((1, 1, cfg.proj_unet_dim, cfg.proj_unet_dim), device="meta"))
    return shapes


def _int8_conv_check(cfg, gen, batch):
    """(a) Every distinct convolution of the net: ``int8_conv2d`` /
    ``int8_conv_transpose2x2`` on the card bit-equal (int32) to the plain
    float64 version on the same full-range int8 operands; then at
    ``batch`` frames the route's time beside its GEMM alone and cuDNN's
    float32 and bf16 convolutions of the same shapes."""
    import torch.nn.functional as F

    from deepfluoro_tpu_torch.ops import int8_conv

    def draw(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=DEVICE, dtype=torch.int8)

    rows = []
    for kind, c, h, w, o, k, stride, pad in _conv_shapes(cfg):
        label = "{} {}x{} s{} p{}: {} -> {} at {}x{}".format(kind, k, k, stride, pad, c, o, h, w)
        wq = draw(c, o, k, k) if kind == "transpose" else draw(o, c, k, k)
        if kind == "transpose":
            route = lambda x: int8_conv.int8_conv_transpose2x2(x, wq)  # noqa: E731
            plain = lambda x: int8_conv.plain_conv_transpose2x2(x, wq)  # noqa: E731
            wmat = int8_conv.gemm_weight(wq, transpose=True)
        else:
            route = lambda x: int8_conv.int8_conv2d(x, wq, stride, pad)  # noqa: E731
            plain = lambda x: int8_conv.plain_conv2d(x, wq, stride, pad)  # noqa: E731
            wmat = int8_conv.gemm_weight(wq)
        x = draw(INT8_CHECK_BATCH, c, h, w)
        got, want = route(x), plain(x)
        _sync()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError("the int8 route differs from its plain version: " + label)

        x = draw(batch, c, h, w)
        xf, wf = x.float(), wq.float()
        if kind == "transpose":
            f32 = lambda: F.conv_transpose2d(xf, wf, None, 2)  # noqa: E731
            bf16 = lambda: F.conv_transpose2d(xb, wb, None, 2)  # noqa: E731
            a = int8_conv.im2col(x, 1)[0]
        else:
            f32 = lambda: F.conv2d(xf, wf, None, stride, pad)  # noqa: E731
            bf16 = lambda: F.conv2d(xb, wb, None, stride, pad)  # noqa: E731
            a = int8_conv.im2col(x, k, stride, pad)[0]
        # the GEMM's operand as the route pads it: K to the weight matrix's, M to 17 rows
        a = F.pad(a, (0, wmat.shape[1] - a.shape[1], 0, max(0, 17 - a.shape[0]))).contiguous()
        xb, wb = xf.bfloat16(), wf.bfloat16()
        row = {
            "shape": label,
            "route_ms": _event_ms(lambda: route(x)),
            "gemm_ms": _event_ms(lambda: torch._int_mm(a, wmat.t())),
            "float32_ms": _event_ms(f32),
            "bf16_ms": _event_ms(bf16),
        }
        del x, xf, xb, a
        rows.append(row)
        print("  {}: bit-equal to the plain version; at batch {}: route {:.4f} ms (GEMM alone {:.4f} ms), cuDNN "
              "float32 {:.4f} ms, bf16 {:.4f} ms".format(label, batch, row["route_ms"], row["gemm_ms"],
                                                        row["float32_ms"], row["bf16_ms"]))
    total = {k: sum(r[k] for r in rows) for k in ("route_ms", "gemm_ms", "float32_ms", "bf16_ms")}
    print("  {} distinct convolutions, each once at batch {}: route {:.3f} ms (GEMMs {:.3f} ms), cuDNN float32 "
          "{:.3f} ms, bf16 {:.3f} ms".format(len(rows), batch, total["route_ms"], total["gemm_ms"],
                                            total["float32_ms"], total["bf16_ms"]))
    return rows, total


def _int8_convs(model, float_levels, dim):
    """Convolutions that run int8 in one forward with the finest
    ``float_levels`` levels in float: one per quantization point the filter
    keeps, two at a conv block's input with a residual 1x1."""
    from deepfluoro_tpu_torch.infer.quantized import calibration_stats, make_level_filter

    keep = make_level_filter(float_levels, len(model.down_path))
    keys = calibration_stats(model, torch.zeros((1, 1, dim, dim), device=DEVICE))[1]
    res = model.down_path[0].res_conv1x1 is not None
    return sum(1 + (res and key.endswith("/x0") and not key.startswith("lands_block")) for key in keys
               if keep is None or keep(key))


def _to_cpu(members):
    """The int8 members' state on the CPU: the same modules, int8 weights
    and scales, so a CPU forward runs the plain convolutions on the card's
    numbers."""
    from deepfluoro_tpu_torch.infer.quantized import QuantizedMember

    return [QuantizedMember(copy.deepcopy(m.model).cpu(), {k: (w.cpu(), s.cpu()) for k, (w, s) in m.qweights.items()},
                            {k: v.cpu() for k, v in m.scales.items()}, {}) for m in members]


def _int8_against_cpu(name, members, x_d, hw, num_lands):
    """The int8 ensemble on the card against the same members, scales and
    prepared input on the CPU: mean seg within 1e-3, heats within 1e-3,
    labels differing on < 0.1 % of pixels and only where the CPU's top two
    probabilities are closer than twice the seg difference. Returns the
    card's labels."""
    from deepfluoro_tpu_torch.infer.quantized import quantized_ensemble_forward

    seg_d, heats_d, labels_d = (t.cpu() for t in quantized_ensemble_forward(members, x_d, hw, num_lands))
    seg_c, heats_c, labels_c = quantized_ensemble_forward(_to_cpu(members), x_d.cpu(), hw, num_lands)
    seg_err = float((seg_d - seg_c).abs().max())
    heat_err = float((heats_d - heats_c).abs().max())
    differ = (labels_d != labels_c).numpy()
    top2 = torch.topk(seg_c, 2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    worst = float(margin[differ].max()) if differ.any() else 0.0
    print("  {}: int8 card vs CPU on the same scales and input: mean seg max |diff| {:.2e} (<= 1e-3), heats {:.2e} "
          "(<= 1e-3), labels differ on {:.4%} of pixels (< 0.1 %), largest CPU top-two margin there {:.2e} (<= twice "
          "the seg difference)".format(name, seg_err, heat_err, differ.mean(), worst))
    if not (torch.isfinite(seg_d).all() and torch.isfinite(heats_d).all()) or int(labels_d.max()) >= seg_d.shape[1]:
        raise AssertionError("non-finite int8 outputs or labels out of range on " + name)
    if seg_err > 1e-3 or heat_err > 1e-3 or differ.mean() >= 1e-3 or worst > 2 * seg_err:
        raise AssertionError("card and CPU int8 ensembles disagree on " + name)
    return labels_d


def phase_int8(seed, member_paths, card):
    """Post-training int8 inference on the card: (a) the int8 convolutions
    against their plain version for every convolution shape of the 8x net,
    and timed; (b) phase 5's K = 6 members through ``ensemble_batches(
    quantized=True)``, card against CPU on the same scales, the labels
    against the float ensemble's, frames/s at batch 64 for K = 6 and K = 1
    (float, int8, int8, float in turns) and the peak less its baseline;
    (c) the 8x full-res rung (K = 6, batch 8) with ``quantized=True``,
    checked and timed; (d) no warp launch. Returns the int8 summary."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, make_synthetic_fullres_data
    from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep
    from deepfluoro_tpu_torch.infer import ensemble_batches, ensemble_forward, load_net_from_checkpoint
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches
    from deepfluoro_tpu_torch.infer.quantized import (
        _quant_tensor, prepare_quantized_ensemble, quantize_weight, quantize_weights, quantized_ensemble_forward,
    )
    from deepfluoro_tpu_torch.ops import int8_conv, warp

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 9)
    members = [load_net_from_checkpoint(p, device=DEVICE, verbose=False) for p in member_paths]
    models, cfg = [m for m, _ in members], members[0][1]
    hw, k_all = (INFER_FRAME, INFER_FRAME), len(models)
    out = {}

    # true division on the card: the scale is a device tensor, not a CPU scalar
    xs = torch.randn((1 << 20,), generator=gen, device=DEVICE) * 3
    scale = xs.abs().amax() / 127
    w = models[0].down_path[-1].block[0].weight
    if not (torch.equal(_quant_tensor(xs, scale).cpu(), _quant_tensor(xs.cpu(), scale.cpu()))
            and all(torch.equal(a.cpu(), b) for a, b in zip(quantize_weight(w), quantize_weight(w.cpu())))):
        raise AssertionError("activation or weight quantization differs between card and CPU")
    print("  activation and weight quantization: card equal to CPU")

    out["convs"], out["convs_total"] = _int8_conv_check(cfg, gen, THROUGHPUT_BATCH)

    # (b) the K = 6 ensemble: card against CPU, against the float labels, and ensemble_batches
    n_convs = len(quantize_weights(models[0]))
    frames = make_synthetic_data(num_specimens=1, num_projs=INT8_CHECK_FRAMES, img_dim=INFER_FRAME, seed=seed + 6)
    x_d = prepare_batch(AugmentConfig(proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.0), None,
                        torch.from_numpy(frames.projs).to(DEVICE))["proj"]
    prepared = prepare_quantized_ensemble(models, [x_d])
    labels = _int8_against_cpu("{} frames of {}^2, K = {}".format(INT8_CHECK_FRAMES, INFER_FRAME, k_all), prepared, x_d,
                               hw, cfg.num_lands)
    float_labels = ensemble_forward(models, x_d, hw, cfg.num_lands)[2].cpu()
    out["int8_float_label_agreement"] = float((labels == float_labels).float().mean())
    batched = np.concatenate([l for _, l, _ in ensemble_batches(frames, models, cfg.num_lands, None, INT8_CHECK_FRAMES,
                                                                cfg.proj_unet_dim, quantized=True, calib_batches=1)])
    print("  int8 labels equal the float ensemble's on {:.4%} of pixels; ensemble_batches(quantized=True) equals the "
          "direct int8 forward: {}".format(out["int8_float_label_agreement"], bool(np.array_equal(batched, labels.numpy()))))
    if not np.array_equal(batched, labels.numpy()):
        raise AssertionError("ensemble_batches' int8 labels differ from the int8 forward's on the same scales")
    del x_d, prepared

    # (c) the 8x full-res rung, K = 6, batch 8
    name, factor, pad, _, batch = FULLRES_RUNGS[0]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=FULLRES_FRAMES, img_dim=FULLRES_DIM, seed=seed + 5)[0]
    full_hw = spec["projs"].shape[1:]
    prep, fhw = make_fullres_prep(factor, pad, full_hw)
    nchk = FULLRES_CHECK_FRAMES
    x_d = prep(torch.from_numpy(spec["projs"][:nchk]).to(DEVICE), torch.from_numpy(spec["rots"][:nchk]).to(DEVICE))
    prepared = prepare_quantized_ensemble(models, [x_d])
    labels = _int8_against_cpu("{} full-res rung, {} raw {}^2 frames -> {}^2, K = {}".format(
        name, nchk, full_hw[0], fhw[0], k_all), prepared, x_d, fhw, cfg.num_lands)

    def read_batch(i0, i1):
        return spec["projs"][i0:i1], spec["rots"][i0:i1]

    got = np.concatenate([l for _, l, _ in fullres_batches(read_batch, nchk, full_hw, models, factor, cfg.num_lands,
                                                           None, batch, pad, quantized=True)])
    if not np.array_equal(got, labels.numpy()):
        raise AssertionError("fullres_batches' int8 labels differ from the int8 forward's on the same scales")
    del x_d, prepared

    # the timed runs, (b) then (c): the main path of this phase, with the counts at 0
    warp.warp_launches = 0
    int8_conv.int8_gemm_launches = 0
    bulk = make_synthetic_data(num_specimens=1, num_projs=THROUGHPUT_FRAMES, img_dim=INFER_FRAME, seed=seed + 4)
    forwards = 0
    batches_per_run = THROUGHPUT_FRAMES // THROUGHPUT_BATCH + 1  # the warm-up batch, then the frames
    for k in (k_all, 1):
        for mode in ("float", "int8", "int8", "float"):
            times = []
            baseline = _peak_start()
            for _ in ensemble_batches(bulk, models[:k], cfg.num_lands, times, THROUGHPUT_BATCH, cfg.proj_unet_dim,
                                      quantized=mode == "int8"):
                pass
            fps = len(times) / sum(times)
            out.setdefault("fps", {}).setdefault("K={} {}".format(k, mode), []).append(fps)
            out.setdefault("peak", {})["K={} {}".format(k, mode)] = _peak_since(baseline)
            forwards += k * batches_per_run if mode == "int8" else 0
            print("  {} {} ensemble frames/s at batch {}, K = {}, {}^2 -> {}^2 (--times contract, calibration "
                  "outside): {:.1f}; peak less baseline {} bytes".format(
                      _card(card), mode, THROUGHPUT_BATCH, k, INFER_FRAME, cfg.proj_unet_dim, fps,
                      out["peak"]["K={} {}".format(k, mode)]))
    times = []
    for _ in ensemble_batches(bulk, models, cfg.num_lands, times, THROUGHPUT_BATCH, cfg.proj_unet_dim, quantized=True,
                              int8_float_levels=1):
        pass
    out["fps"]["K={} int8, finest level float".format(k_all)] = [len(times) / sum(times)]
    forwards_hybrid = k_all * batches_per_run
    print("  {} int8 with the finest level in float (--int8-float-levels 1), K = {}: {:.1f} frames/s".format(
        _card(card), k_all, len(times) / sum(times)))
    del bulk

    for mode in ("float", "int8", "int8", "float"):
        times = []
        baseline = _peak_start()
        for _ in fullres_batches(read_batch, len(spec["projs"]), full_hw, models, factor, cfg.num_lands, times, batch,
                                 pad, quantized=mode == "int8"):
            pass
        fps = len(times) / sum(times)
        key = "{} full-res {}".format(name, mode)
        out["fps"].setdefault(key, []).append(fps)
        out["peak"][key] = _peak_since(baseline)
        forwards += k_all * (-(-len(times) // batch) + 1) if mode == "int8" else 0  # the warm-up batch, then the frames
        print("  {} {} {} full-res rung: {:.2f} frames/s at batch {}, K = {}, over {} raw {}^2 frames (--times "
              "contract); peak less baseline {} bytes".format(_card(card), mode, name, fps, batch, k_all,
                                                              len(times), full_hw[0], out["peak"][key]))

    _sync()
    out["phase_peak"] = max(out["peak"][k] for k in out["peak"] if "int8" in k)
    print("  {} the int8 runs' peak device memory less baseline, the largest over the phase: {} bytes (float: "
          "{} bytes)".format(_card(card), out["phase_peak"], max(v for k, v in out["peak"].items() if "float" in k)))
    out["gemm_launches"] = int8_conv.int8_gemm_launches
    launches = warp.warp_launches
    hybrid_int8 = _int8_convs(models[0], 1, cfg.proj_unet_dim)
    expected = forwards * n_convs + forwards_hybrid * hybrid_int8
    print("  int8 GEMM launches in the timed runs: {} ({} member forwards x {} convolutions, and {} with the finest "
          "level in float x {} int8 convolutions = {}); warp kernel launches: {} (no kernel on this path)".format(
              out["gemm_launches"], forwards, n_convs, forwards_hybrid, hybrid_int8, expected, launches))
    if out["gemm_launches"] != expected:
        raise AssertionError("the int8 runs did not take the int8 GEMM route for every convolution")
    if launches != 0:
        raise AssertionError("int8 inference launched the warp kernel")
    return out


DIST_BATCH = 10  # phase 10(b)'s global batch: 5 frames per rank, as the recipe's batch on one card
DIST_LAYOUTS = {"members 3+3": {"ensemble": 2}, "rows": {"ensemble": 1, "data": 2}}


# the settings a phase-10 rank takes from the parent (a rank imports this
# file afresh): its device, and the sizes, which a CPU rehearsal shrinks
RANK_SETTINGS = ("DEVICE", "TRAIN_FRAME", "TRAIN_PAD", "TRAIN_DEPTH", "TRAIN_WF", "FOLD_PATS", "CHECK_FRAMES",
                 "INFER_FRAME", "INT8_CHECK_FRAMES", "DIST_BATCH")


def _count_plain_pairs():
    """A CPU rehearsal's ranks: CPU tensors take the plain warp and launch
    no kernel, so the pair's calls are counted in its count instead."""
    from deepfluoro_tpu_torch.ops import warp

    pair = warp.affine_warp_pair
    if getattr(pair, "counted", False):
        return

    def counted(*args, **kwargs):
        warp.warp_launches += 1
        return pair(*args, **kwargs)

    counted.counted = True
    warp.affine_warp_pair = counted


def _rank_setup(deterministic, settings=None):
    """A phase-10 rank starts from a fresh import: the parent's
    ``RANK_SETTINGS``, the float32 recipe's switches, set as phase 1 sets
    them, and deterministic cuDNN so that runs compare step for step."""
    globals().update(settings or {})
    if DEVICE == "cpu":
        _count_plain_pairs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic


def _await_go(go_file):
    """A rank that has imported the port, made its CUDA context and loaded
    the kernel waits here until the parent creates ``go_file``: the ranks
    start while the parent computes its references, and run after."""
    torch.zeros(1, device=DEVICE)
    if DEVICE == "cuda":
        from deepfluoro_tpu_torch.ops._build import load_library

        load_library("affine_warp")
    deadline = time.monotonic() + 900
    while not os.path.exists(go_file):
        if time.monotonic() > deadline:
            raise TimeoutError("no go from the parent within 900 s")
        time.sleep(0.05)


def _warp_pair_err(seed, b):
    """The warp pair of one rank's share of a step (``b`` frames of 180^2 ->
    192^2 under the augmentation's matrices) against its plain version, at
    phase 3's tolerances; returns the bilinear max |diff|."""
    from deepfluoro_tpu_torch.ops import image, warp
    from deepfluoro_tpu_torch.ops.image import calc_pad_amount

    extra = calc_pad_amount(TRAIN_PAD, TRAIN_FRAME)
    oshape, off = (TRAIN_FRAME + 2 * extra,) * 2, (-extra, -extra)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    proj = torch.rand((b, TRAIN_FRAME, TRAIN_FRAME), generator=gen, device=DEVICE)
    labels = torch.randint(0, 7, (b, TRAIN_FRAME, TRAIN_FRAME), generator=gen, device=DEVICE).float()
    m = _aug_matrices(gen, b, TRAIN_FRAME).to(DEVICE)
    got = warp.affine_warp_pair(proj, labels, m, oshape, off)
    want = image.affine_warp(proj, m, 1, oshape, off), image.affine_warp(labels, m, 0)
    _sync()
    name = "rank {} warp pair, {} frames {}->{}".format(torch.distributed.get_rank(), b, TRAIN_FRAME, oshape[0])
    err = _compare(name + " projection bilinear", got[0], want[0], 1)
    _compare(name + " labels nearest", got[1], want[1], 0)
    return err


def _rank_fit(seed, workdir, batch_size, epochs, **modes):
    """One rank of a data-parallel ``fit`` of the 8x recipe over a 'data'
    mesh of every rank (process 0 writes the files); ``modes`` go to the
    config (bf16 compute, remat)."""
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.parallel import make_mesh
    from deepfluoro_tpu_torch.train import fit

    data = _smoke_data(seed)
    mesh = make_mesh({"data": torch.distributed.get_world_size()})
    baseline = _peak_start()
    warp.warp_launches = 0
    out = fit(data, [2, 3, 4, 5, 6], _recipe_cfg(data, seed, max_num_epochs=epochs, batch_size=batch_size, **modes),
              verbose=False, device=DEVICE, mesh=mesh,
              **_fit_files(workdir, "dp{}{}".format(batch_size, "_".join(sorted(modes)))))
    _sync()
    bn = {k: v.cpu().numpy() for k, v in out["model"].state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return {"train": out["train_losses"], "valid": out["valid_losses"], "steps": len(out["train_losses"]),
            "launches": warp.warp_launches, "step_seconds": out["step_seconds"], "peak": _peak_since(baseline),
            "bn": bn}


def _rank_nccl(seed, workdir, settings, go_file):
    """Phase 10(a): one rank of the backend that ``run_ranks`` picks by
    default, NCCL on the card (gloo in a CPU rehearsal). Its collectives
    run (a sum and the agreement helpers on a device tensor), then the
    data-parallel ``fit``."""
    from deepfluoro_tpu_torch.parallel.sharding import barrier, sum_over

    _rank_setup(True, settings)
    t = torch.ones(3, device=DEVICE)
    torch.distributed.all_reduce(t)
    barrier()
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if torch.distributed.get_backend() != backend or t.tolist() != [1.0] * 3 or sum_over([2.5]) != [2.5]:
        raise AssertionError("the {} group of one rank did not reduce".format(backend))
    _await_go(go_file)
    return _rank_fit(seed, workdir, 5, 2)


def _rank_gloo(seed, workdir, member_paths, settings, go_file):
    """Phase 10(b)-(d) on one of two gloo ranks sharing the card."""
    from deepfluoro_tpu_torch.infer import ensemble_batches, ensemble_forward, load_net_from_checkpoint
    from deepfluoro_tpu_torch.infer.quantized import int8_forwards
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.parallel import make_mesh
    from deepfluoro_tpu_torch.train.multifold import fit_multifold

    _rank_setup(True, settings)
    _await_go(go_file)
    out = {"b": _rank_fit(seed, workdir, DIST_BATCH, 2)}
    out["b"]["warp_err"] = _warp_pair_err(seed + 11 + torch.distributed.get_rank(), DIST_BATCH // 2)
    out["b_bf16"] = _rank_fit(seed, workdir, DIST_BATCH, 1, compute_dtype="bfloat16", remat=True)

    data = _smoke_data(seed)
    cfg = _recipe_cfg(data, seed, max_num_epochs=1)
    baseline = _peak_start()
    warp.warp_launches = 0
    folds = fit_multifold(data, FOLD_PATS, cfg, verbose=False, device=DEVICE, mesh=make_mesh({"ensemble": 2}),
                          checkpoint_prefix=os.path.join(workdir, "dfold_ck"),
                          best_prefix=os.path.join(workdir, "dfold_best"))
    _sync()
    out["c"] = {"train": np.array(folds["train_losses"]), "valid": np.array(folds["valid_losses"]),
                "folds": folds["folds"], "launches": warp.warp_launches, "steps": len(folds["train_losses"]),
                "step_seconds": folds["step_seconds"], "peak": _peak_since(baseline)}
    del folds

    frames, x, x9 = _dist_inputs(seed)
    out["d"] = {}
    for name, axes in DIST_LAYOUTS.items():
        mesh = make_mesh(axes)
        own = member_paths[mesh.axis("ensemble").rows(len(member_paths))]
        models = [load_net_from_checkpoint(p, device=DEVICE, verbose=False)[0] for p in own]
        num_lands, pad = models[0].num_lands, x.shape[-1]
        for mode in ("float", "int8"):
            baseline = _peak_start()
            fwds = int8_forwards(models, [x9]) if mode == "int8" else models
            res = [t.cpu().numpy() for t in ensemble_forward(fwds, x9 if mode == "int8" else x, frames.orig_img_shape,
                                                               num_lands, mesh)]
            batched = [(l, h) for _, l, h in ensemble_batches(frames, models, num_lands, None, 4, pad,
                                                               quantized=mode == "int8", calib_batches=1, mesh=mesh)]
            out["d"][name, mode] = {"forward": res, "batches": batched, "peak": _peak_since(baseline)}
        del models
    return out


def _dist_inputs(seed):
    """Phase 10(d)'s inputs: phase 5's check frames, their first 4 prepared
    (float), and phase 9's prepared check frames (int8, whose scales they
    set)."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data

    aug = AugmentConfig(proj_pad_dim=TRAIN_PAD, prob_of_aug=0.0)
    frames = make_synthetic_data(num_specimens=1, num_projs=CHECK_FRAMES, img_dim=INFER_FRAME, seed=seed + 1)
    x = prepare_batch(aug, None, torch.from_numpy(frames.projs[:4]).to(DEVICE))["proj"]
    int8_frames = make_synthetic_data(num_specimens=1, num_projs=INT8_CHECK_FRAMES, img_dim=INFER_FRAME, seed=seed + 6)
    x9 = prepare_batch(aug, None, torch.from_numpy(int8_frames.projs).to(DEVICE))["proj"]
    return frames, x, x9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _fit_rel(got, want, epoch_steps):
    """(first epoch, whole run): the largest relative difference of the
    per-step train and the validation losses of ``got`` (a rank's) from
    ``want`` (a one-process ``fit``'s), over the first epoch and over all."""
    first = max(_rel(got["train"][:epoch_steps], want["train_losses"][:epoch_steps]),
                _rel(got["valid"][:1], want["valid_losses"][:1]))
    return first, max(_rel(got["train"], want["train_losses"]), _rel(got["valid"], want["valid_losses"]))


def _labels_match(name, got, want_seg, seg_err):
    """Labels equal except where the one-process mean seg's top two are
    closer than twice the seg difference."""
    top2 = np.sort(want_seg, axis=1)[:, -2:]
    differ = got != want_seg.argmax(1)
    worst = float((top2[:, 1] - top2[:, 0])[differ].max()) if differ.any() else 0.0
    if worst > 2 * seg_err:
        raise AssertionError("{}: labels differ where the top two are {:.2e} apart".format(name, worst))
    return float(differ.mean())


def phase_distributed(seed, workdir, member_paths):
    """Phase 10 (see the module docstring), with deterministic cuDNN in
    every process. Returns the summary, the launches of the training
    paths, counted by the ranks, and the losses of (a)'s one-process run,
    which phase 11(b) is held against."""
    try:
        _rank_setup(True)
        return _phase_distributed(seed, workdir, member_paths)
    finally:
        _rank_setup(False)


def _phase_distributed(seed, workdir, member_paths):
    from deepfluoro_tpu_torch.parallel.multihost import Ranks

    # the ranks start now (spawn, imports, CUDA contexts, the kernel) and
    # wait while this process computes the one-process references
    settings = {k: globals()[k] for k in RANK_SETTINGS}
    go_a, go_b = os.path.join(workdir, "go_a"), os.path.join(workdir, "go_b")
    t0 = time.perf_counter()
    ranks_a = Ranks(_rank_nccl, 1, args=(seed, workdir, settings, go_a), device=DEVICE)
    ranks_b = Ranks(_rank_gloo, 2, args=(seed, workdir, member_paths, settings, go_b), device=DEVICE, backend="gloo")
    try:
        refs = _distributed_references(seed, workdir, member_paths)
        print("  one-process references while the ranks start: {:.1f} s".format(time.perf_counter() - t0))
        t0 = time.perf_counter()
        open(go_a, "w").close()
        (a,) = ranks_a.results(timeout=600)
        t1 = time.perf_counter()
        open(go_b, "w").close()
        ranks = ranks_b.results(timeout=900)
        print("  (a) ran {:.1f} s, (b)-(d) {:.1f} s after their go".format(t1 - t0, time.perf_counter() - t1))
    finally:
        ranks_a.close()
        ranks_b.close()
    summary, launches = _distributed_checks(refs, a, ranks)
    # phase 11(b) is held against (a)'s one-process run: its losses only
    return summary, launches, {"a": {k: v for k, v in refs["a"].items() if k not in ("model", "optimizer")}}


def _distributed_references(seed, workdir, member_paths):
    """The one-process runs phase 10's ranks are held against: (a) phase
    4's recipe; (b) at batch 10; (c) the K = 6 folds; (d) the ensemble,
    float and int8."""
    from deepfluoro_tpu_torch.infer import ensemble_batches, ensemble_forward, load_net_from_checkpoint
    from deepfluoro_tpu_torch.infer.quantized import int8_forwards
    from deepfluoro_tpu_torch.train import fit
    from deepfluoro_tpu_torch.train.multifold import fit_multifold

    data = _smoke_data(seed)
    pats = [2, 3, 4, 5, 6]
    refs = {"a": fit(data, pats, _recipe_cfg(data, seed, max_num_epochs=2), verbose=False, device=DEVICE,
                     **_fit_files(workdir, "ref_a"))}
    cfg_b = _recipe_cfg(data, seed, max_num_epochs=2, batch_size=DIST_BATCH)
    refs["b"] = fit(data, pats, cfg_b, verbose=False, device=DEVICE, **_fit_files(workdir, "ref_b"))
    refs["b_bf16"] = fit(data, pats, _recipe_cfg(data, seed, max_num_epochs=1, batch_size=DIST_BATCH,
                                                 compute_dtype="bfloat16", remat=True),
                         verbose=False, device=DEVICE, **_fit_files(workdir, "ref_b_bf16"))
    refs["c"] = fit_multifold(data, FOLD_PATS, _recipe_cfg(data, seed, max_num_epochs=1), verbose=False, device=DEVICE,
                              checkpoint_prefix=os.path.join(workdir, "rfold_ck"),
                              best_prefix=os.path.join(workdir, "rfold_best"))
    frames, x, x9 = _dist_inputs(seed)
    models = [load_net_from_checkpoint(p, device=DEVICE, verbose=False)[0] for p in member_paths]
    num_lands, hw = models[0].num_lands, frames.orig_img_shape
    refs["d"] = {}
    for mode in ("float", "int8"):
        fwds = int8_forwards(models, [x9]) if mode == "int8" else models
        refs["d"][mode] = (
            [t.cpu().numpy() for t in ensemble_forward(fwds, x9 if mode == "int8" else x, hw, num_lands)],
            [(l, h) for _, l, h in ensemble_batches(frames, models, num_lands, None, 4, TRAIN_PAD,
                                                     quantized=mode == "int8", calib_batches=1)])
    return refs


def _distributed_checks(refs, a, ranks):
    """Phase 10's checks and summary, from the references and the ranks'
    results; returns (summary, launches of the two training paths)."""
    summary = {}
    one, one_b, one_c = refs["a"], refs["b"], refs["c"]
    rel = _fit_rel(a, one, len(one["train_losses"]) // 2)[1]
    print("  (a) NCCL, one rank, fit on a {{'data': 1}} mesh, 2 epochs: {} steps, {} warp launches, losses within "
          "{:.2e} relative of the one-process fit (<= 1e-5); peak less baseline {} bytes".format(
              a["steps"], a["launches"], rel, a["peak"]))
    if rel > 1e-5 or a["launches"] != a["steps"]:
        raise AssertionError("phase 10(a): the one-rank NCCL fit differs from one process")
    summary["a_nccl_one_rank"] = {"steps": a["steps"], "warp_launches": [a["launches"]], "max_rel_loss_diff": rel,
                                  "peak_less_baseline": [a["peak"]]}

    b = [r["b"] for r in ranks]
    first, rel = (max(v) for v in zip(*(_fit_rel(r, one_b, b[0]["steps"] // 2) for r in b)))
    # how the difference grows along the trajectory, step by step
    want_b = np.asarray(one_b["train_losses"], np.float64)
    per_step = np.max([np.abs(np.asarray(r["train"], np.float64) - want_b) / np.abs(want_b) for r in b], axis=0).tolist()
    bn_equal = all(np.array_equal(b[0]["bn"][k], b[1]["bn"][k]) for k in b[0]["bn"])
    rates = [len(r["step_seconds"][1:]) / sum(r["step_seconds"][1:]) for r in b]
    one_rate = len(one_b["step_seconds"][1:]) / sum(one_b["step_seconds"][1:])
    print("  (b) gloo, two ranks sharing one card, fit at global batch {} ({} per rank), augmentation on, 2 epochs: "
          "{} steps per rank, warp launches per rank {}, losses against one process at batch {}: first epoch within "
          "{:.2e} relative (<= 1e-4), both epochs {:.2e} (<= 1e-3), per step {}, BatchNorm buffers equal across "
          "ranks: {}, {} steps/s per rank (two ranks sharing one card; one process, while the ranks start, {:.3f}), "
          "peaks less baseline {} bytes; warp pair per rank max |diff| {}".format(
              DIST_BATCH, DIST_BATCH // 2, b[0]["steps"], [r["launches"] for r in b], DIST_BATCH, first, rel,
              ["%.1e" % v for v in per_step], bn_equal, ["%.3f" % v for v in rates], one_rate, [r["peak"] for r in b],
              ["%.2e" % r["warp_err"] for r in b]))
    if first > 1e-4 or rel > 1e-3 or not bn_equal or any(r["launches"] != r["steps"] for r in b):
        raise AssertionError("phase 10(b): the two-rank fit differs from one process")
    summary["b_gloo_two_ranks"] = {
        "steps_per_rank": b[0]["steps"], "warp_launches": [r["launches"] for r in b],
        "max_rel_loss_diff_first_epoch": first, "max_rel_loss_diff": rel, "rel_loss_diff_per_step": per_step,
        "bn_buffers_equal": bn_equal, "steps_per_s_two_ranks_sharing_one_card": rates, "one_process_steps_per_s": one_rate,
        "peak_less_baseline": [r["peak"] for r in b], "warp_pair_max_abs_err": [r["warp_err"] for r in b]}

    bb = [r["b_bf16"] for r in ranks]
    rel = max(_fit_rel(r, refs["b_bf16"], r["steps"])[1] for r in bb)
    bn_equal = all(np.array_equal(bb[0]["bn"][k], bb[1]["bn"][k]) for k in bb[0]["bn"])
    rates = [len(r["step_seconds"][1:]) / sum(r["step_seconds"][1:]) for r in bb]
    print("  (b) the same at bf16 compute with remat, 1 epoch: {} steps per rank, warp launches per rank {}, losses "
          "within {:.2e} relative of one process with the same modes (<= 5e-3: the bf16 tolerance of the CPU tests), "
          "BatchNorm buffers equal across ranks: {}, {} steps/s per rank, peaks less baseline {} bytes".format(
              bb[0]["steps"], [r["launches"] for r in bb], rel, bn_equal, ["%.3f" % v for v in rates],
              [r["peak"] for r in bb]))
    if rel > 5e-3 or not bn_equal or any(r["launches"] != r["steps"] for r in bb):
        raise AssertionError("phase 10(b): the two-rank bf16 + remat fit differs from one process")
    summary["b_gloo_two_ranks_bf16_remat"] = {
        "steps_per_rank": bb[0]["steps"], "warp_launches": [r["launches"] for r in bb], "max_rel_loss_diff": rel,
        "bn_buffers_equal": bn_equal, "steps_per_s_two_ranks_sharing_one_card": rates,
        "peak_less_baseline": [r["peak"] for r in bb]}

    c = [r["c"] for r in ranks]
    want_train, want_valid = np.array(one_c["train_losses"]), np.array(one_c["valid_losses"])
    rel = max(max(_rel(r["train"], want_train), _rel(r["valid"], want_valid)) for r in c)
    rates = [len(r["step_seconds"][1:]) / sum(r["step_seconds"][1:]) for r in c]
    print("  (c) gloo, two ranks, fit_multifold K = {} split {} + {}, 1 epoch, augmentation on (each rank its folds' "
          "rows of one process's draws): {} lockstep steps per "
          "rank, warp launches per rank {}, every fold within {:.2e} relative of one process (<= 1e-3), {} lockstep "
          "steps/s per rank (two ranks sharing one card), peaks less baseline {} bytes".format(
              len(FOLD_PATS), len(c[0]["folds"]), len(c[1]["folds"]), c[0]["steps"], [r["launches"] for r in c], rel,
              ["%.3f" % v for v in rates], [r["peak"] for r in c]))
    if rel > 1e-3 or any(r["launches"] != r["steps"] for r in c) or [r["folds"] for r in c] != [[0, 1, 2], [3, 4, 5]]:
        raise AssertionError("phase 10(c): the fold-sharded run differs from one process")
    summary["c_folds_two_ranks"] = {
        "lockstep_steps_per_rank": c[0]["steps"], "warp_launches": [r["launches"] for r in c], "max_rel_loss_diff": rel,
        "steps_per_s_two_ranks_sharing_one_card": rates, "peak_less_baseline": [r["peak"] for r in c]}

    summary["d_ensemble_two_ranks"] = {}
    for mode in ("float", "int8"):
        want, want_b = refs["d"][mode]
        for name in DIST_LAYOUTS:
            got = ranks[0]["d"][name, mode]
            seg_err = float(np.abs(got["forward"][0] - want[0]).max())
            heat_err = float(np.abs(got["forward"][1] - want[1]).max())
            differ = _labels_match("phase 10(d) " + name + " " + mode, got["forward"][2], want[0], seg_err)
            batch_heat_err = max(float(np.abs(g[1] - w[1]).max()) for g, w in zip(got["batches"], want_b))
            batch_differ = float(np.mean(np.concatenate([(g[0] != w[0]).ravel() for g, w in zip(got["batches"], want_b)])))
            print("  (d) {} ensemble, {} over two ranks against one process: mean seg {:.2e}, heats {:.2e} (<= 1e-5), "
                  "labels differ on {:.4%} (near-ties only); ensemble_batches heats {:.2e}, labels differ on {:.4%}; "
                  "rank peaks less baseline {} bytes".format(
                      mode, name, seg_err, heat_err, differ, batch_heat_err, batch_differ,
                      [r["d"][name, mode]["peak"] for r in ranks]))
            if seg_err > 1e-5 or heat_err > 1e-5 or batch_heat_err > 1e-5 or batch_differ >= 1e-3:
                raise AssertionError("phase 10(d): the sharded {} ensemble ({}) differs from one process".format(mode, name))
            summary["d_ensemble_two_ranks"]["{} {}".format(mode, name)] = {
                "seg_max_abs": seg_err, "heats_max_abs": heat_err, "label_share_differ": differ,
                "peak_less_baseline": [r["d"][name, mode]["peak"] for r in ranks]}
    launches = {"dp_training": a["launches"] + sum(r["launches"] for r in b),
                "dp_training_bf16_remat": sum(r["launches"] for r in bb),
                "folds_ensemble_devices": sum(r["launches"] for r in c)}
    return summary, launches


# phase 11: the JAX package's checkpoints and the spatial axis
FIXTURE = "tests/fixtures/torch_port/jax_fit_d6_wf1"  # .msgpack and .npz, written by scripts/write_jax_ckpt_fixture.py
SPATIAL_EPOCHS = 2  # phase 11(b): the 8x recipe row-sharded over two ranks
SPATIAL_FULLRES_FRAMES = 2  # phase 11(d): raw 1x frames through the row-sharded ensemble
# the settings a phase-11 rank takes from the parent, beside phase 10's
SPATIAL_SETTINGS = RANK_SETTINGS + ("LADDER", "FULLRES_DIM", "FULLRES_RUNGS", "SPATIAL_EPOCHS", "SPATIAL_FULLRES_FRAMES")


def _fixture_module():
    """``scripts/write_jax_ckpt_fixture.py``, for its data and recipe
    constants (it imports JAX only inside ``write``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "write_jax_ckpt_fixture.py")
    spec = importlib.util.spec_from_file_location("write_jax_ckpt_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and (a == b or (a != a and b != b))


def _phase_jax_checkpoint(seed, workdir, card):
    """Phase 11(a); returns the warp launches of the augmented resume."""
    from deepfluoro_tpu_torch.cli import export_torch_net
    from deepfluoro_tpu_torch.compat import msgpack_lite, torch_checkpoint_from_jax
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import TrainConfig, fit, load_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    ck_path, npz_path = os.path.join(root, FIXTURE + ".msgpack"), os.path.join(root, FIXTURE + ".npz")
    ref = np.load(npz_path)
    lite = msgpack_lite.read(ck_path, use_msgpack=False)
    try:
        pkg = msgpack_lite.read(ck_path, use_msgpack=True)
        decoders = "msgpack {} and msgpack_lite give identical trees: {}".format(
            ".".join(map(str, __import__("msgpack").version)), _same_tree(pkg, lite))
        if not _same_tree(pkg, lite):
            raise AssertionError("phase 11(a): msgpack and msgpack_lite decode the fixture differently")
    except ImportError:
        decoders = "the msgpack package is not installed here: msgpack_lite alone decodes it"
    print("  (a) {} ({} bytes, JAX fit at depth 6, wf 1, 192^2, epoch {}): {}".format(
        FIXTURE + ".msgpack", os.path.getsize(ck_path), lite["epoch"], decoders))

    ck = torch_checkpoint_from_jax(ck_path)
    sd_equal = sorted(ck["model-state-dict"]) == sorted(k[3:] for k in ref.files if k.startswith("sd/")) and all(
        np.array_equal(v.numpy(), ref["sd/" + k]) for k, v in ck["model-state-dict"].items())
    mom = ck["optimizer-state-dict"]["state"]
    mom_equal = sorted(mom) == sorted(int(k[4:]) for k in ref.files if k.startswith("mom/")) and all(
        np.array_equal(e["momentum_buffer"].numpy(), ref["mom/{}".format(i)]) for i, e in mom.items())
    print("      torch_checkpoint_from_jax against the JAX exporter's file: state dict ({} tensors) equal bit for bit: "
          "{}; momentum buffers ({}) equal: {}".format(len(ck["model-state-dict"]), sd_equal, len(mom), mom_equal))
    if not (sd_equal and mom_equal):
        raise AssertionError("phase 11(a): the converted checkpoint differs from the JAX exporter's")

    model, cfg = load_net_from_checkpoint(ck_path, device=DEVICE, verbose=False)
    with torch.no_grad():
        seg, heats = model(torch.from_numpy(ref["forward_input"]).to(DEVICE))
    sub = int(ref["forward_subsample"])
    fwd_err = max(float(np.abs(seg.cpu().numpy()[:, :, ::sub, ::sub] - ref["forward_seg"]).max()),
                  float(np.abs(heats.cpu().numpy()[:, :, ::sub, ::sub] - ref["forward_heats"]).max()))
    print("      {} the member's forward against JAX's outputs: max |diff| {:.2e} (<= 1e-4)".format(_card(card), fwd_err))
    if fwd_err > 1e-4:
        raise AssertionError("phase 11(a): the loaded JAX member's forward differs from JAX's")
    del model, seg, heats

    mod = _fixture_module()
    data = make_synthetic_data(**mod.DATA)
    files = _fit_files(workdir, "jaxck")
    shutil.copy(ck_path, files["checkpoint_filename"])
    torch.backends.cudnn.deterministic = True
    try:
        out = fit(data, mod.PATS, TrainConfig(**dict(mod.RECIPE, max_num_epochs=2)), verbose=False, device=DEVICE,
                  **files)
    finally:
        torch.backends.cudnn.deterministic = False
    rel = max(_rel(out["train_losses"], ref["resumed_train_losses"]), _rel(out["valid_losses"],
                                                                          ref["resumed_valid_losses"]))
    print("      {} fit resumed from the msgpack file for one epoch (deterministic cuDNN, augmentation off): {} steps, "
          "losses within {:.2e} relative of the JAX fit's (<= 1e-3)".format(_card(card), len(out["train_losses"]), rel))
    if rel > 1e-3 or out["epoch"] != 2:
        raise AssertionError("phase 11(a): the resumed fit does not track the JAX fit")

    # the file carries data-aug False: the same resume with augmentation on
    # runs from a copy of its conversion with the flag set
    aug = load_checkpoint(ck_path)
    aug["data-aug"] = True
    aug_files = _fit_files(workdir, "jaxck_aug")
    torch.save(aug, aug_files["checkpoint_filename"])
    warp.warp_launches = 0
    out = fit(data, mod.PATS, TrainConfig(**dict(mod.RECIPE, max_num_epochs=2)), verbose=False, device=DEVICE,
              **aug_files)
    _sync()
    launches, steps = warp.warp_launches, len(out["train_losses"])
    print("      the same resume with augmentation on: {} warp launches in {} steps (1 per step), losses {}".format(
        launches, steps, ["%.4f" % v for v in out["train_losses"]]))
    if launches != steps or not all(math.isfinite(v) for v in out["train_losses"]):
        raise AssertionError("phase 11(a): the augmented resume did not launch the warp kernel once per step")

    out_pt = os.path.join(workdir, "exported.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        export_torch_net.main([ck_path, out_pt])
    exported = torch.load(out_pt, map_location="cpu", weights_only=False)
    same = exported.keys() == ck.keys() and all(torch.equal(v, ck["model-state-dict"][k])
                                                for k, v in exported["model-state-dict"].items())
    jax_loaded = any(m == "jax" or m.startswith(("jax.", "flax", "optax", "deepfluoro_tpu.")) for m in sys.modules)
    print("      cli.export_torch_net wrote the reference .pt ({} bytes), equal to the conversion: {}; JAX imported: "
          "{}".format(os.path.getsize(out_pt), same, jax_loaded))
    if not same or jax_loaded:
        raise AssertionError("phase 11(a): export_torch_net differs or imported JAX")
    return launches


def _spatial_step(seed, dtype=torch.float32, mesh=None):
    """One train-mode forward and backward of the 8x recipe's loss from
    ``fit``'s seeded initial weights on the first 5 smoke frames
    (augmentation off), whole or row-sharded on ``mesh``'s 'spatial' axis
    (gradients then summed over the bands): (loss, {name: float64
    gradient}, {name: BatchNorm running buffer})."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.parallel.mesh import row_shard
    from deepfluoro_tpu_torch.parallel.sharding import average_gradients, shard_rows
    from deepfluoro_tpu_torch.train.config import build_model
    from deepfluoro_tpu_torch.train.step import per_sample_losses, shard_prepared

    data = _smoke_data(seed)
    cfg = _recipe_cfg(data, seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg)
    model.to(DEVICE, dtype)
    b = cfg.batch_size
    prepared = prepare_batch(AugmentConfig(num_classes=7, proj_pad_dim=TRAIN_PAD, prob_of_aug=0.0), None,
                             *(torch.from_numpy(a[:b]).to(DEVICE) for a in (data.projs, data.segs, data.lands)))
    prepared = {k: v.to(dtype) if torch.is_floating_point(v) else v for k, v in prepared.items()}
    shard = None
    if mesh is not None:
        shard = row_shard(mesh, TRAIN_PAD, 2 ** (TRAIN_DEPTH - 1))
        shard_rows(model, shard)
        prepared = shard_prepared(prepared, shard)
    model.train()
    loss = per_sample_losses(cfg, model(prepared["proj"]), prepared["seg"], prepared["heats"], True, shard,
                             prepared.get("target_rows", 0)).mean()
    loss.backward()
    loss = loss.detach()
    if shard is not None:
        loss = average_gradients(model.parameters(), loss, shard.joint)
    grads = {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters() if p.grad is not None}
    bufs = {k: v.double().cpu().numpy() for k, v in model.named_buffers() if "running" in k}
    return float(loss), grads, bufs


def _spatial_data(seed):
    """Phase 11(c)'s 2x frames (LADDER's 2x rung)."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data

    rung, frame, pad, batch, n_frames = LADDER[0]
    return make_synthetic_data(num_specimens=1, num_projs=n_frames, img_dim=frame, seed=seed + frame), pad, batch


def _spatial_2x_cfg(data, seed, pad, batch):
    return _recipe_cfg(data, seed, proj_unet_dim=pad, batch_size=batch, max_num_epochs=1, compute_dtype="bfloat16",
                       remat=True)


def _fullres_1x_frames(seed):
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data

    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=SPATIAL_FULLRES_FRAMES, img_dim=FULLRES_DIM,
                                       seed=seed + 5)[0]
    return spec["projs"], spec["rots"]


def _rank_spatial(seed, workdir, member_path, settings, go_file):
    """Phase 11(b)-(d) on one of two gloo ranks sharing the card, on a
    {'spatial': 2} mesh."""
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.parallel import make_mesh
    from deepfluoro_tpu_torch.train import fit

    _rank_setup(True, settings)
    _await_go(go_file)
    mesh = make_mesh({"spatial": 2})
    rank = torch.distributed.get_rank()
    loss, grads, bufs = _spatial_step(seed, mesh=mesh)
    out = {"step": (loss, grads if rank == 0 else None, bufs)}
    del grads
    data = _smoke_data(seed)
    baseline = _peak_start()
    warp.warp_launches = 0
    res = fit(data, [2, 3, 4, 5, 6], _recipe_cfg(data, seed, max_num_epochs=SPATIAL_EPOCHS), verbose=False,
              device=DEVICE, mesh=mesh, shard_spatial=True, **_fit_files(workdir, "sp8x"))
    _sync()
    bn = {k: v.cpu().numpy() for k, v in res["model"].state_dict().items() if k.endswith(("running_mean", "running_var"))}
    out["b"] = {"train": res["train_losses"], "valid": res["valid_losses"], "steps": len(res["train_losses"]),
                "launches": warp.warp_launches, "step_seconds": res["step_seconds"], "peak": _peak_since(baseline),
                "bn": bn}
    del res

    data2x, pad, batch = _spatial_data(seed)
    baseline = _peak_start()
    warp.warp_launches = 0
    res = fit(data2x, [1], _spatial_2x_cfg(data2x, seed, pad, batch), verbose=False, device=DEVICE, mesh=mesh,
              shard_spatial=True, stream_data=True, **_fit_files(workdir, "sp2x"))
    _sync()
    out["c"] = {"train": res["train_losses"], "valid": res["valid_losses"], "steps": len(res["train_losses"]),
                "launches": warp.warp_launches, "step_seconds": res["step_seconds"], "peak": _peak_since(baseline)}
    del res, data2x

    projs, rots = _fullres_1x_frames(seed)
    model, mcfg = load_net_from_checkpoint(member_path, device=DEVICE, verbose=False)
    baseline = _peak_start()
    times = []
    got = list(fullres_batches(lambda i0, i1: (projs[i0:i1], rots[i0:i1]), len(projs), projs.shape[1:], [model], 1,
                               model.num_lands, times, len(projs), mcfg.proj_unet_dim, mesh=mesh))
    out["d"] = {"batches": got if rank == 0 else None, "fps": len(times) / sum(times), "peak": _peak_since(baseline)}
    return out


def _spatial_references(seed, workdir, member_path, refs):
    """The one-process runs phase 11's ranks are held against: (b) phase
    10's reference of the 8x recipe (2 epochs, batch 5, deterministic); (c)
    the 2x rung with bf16, remat and the streamed feed for one epoch; (d)
    the 1x member over the raw frames, timed."""
    from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep
    from deepfluoro_tpu_torch.infer import ensemble_forward, load_net_from_checkpoint
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches
    from deepfluoro_tpu_torch.train import fit

    out = {"b": refs["a"], "step32": _spatial_step(seed), "step64": _spatial_step(seed, torch.float64)}
    if SPATIAL_EPOCHS != 2:
        data = _smoke_data(seed)
        out["b"] = fit(data, [2, 3, 4, 5, 6], _recipe_cfg(data, seed, max_num_epochs=SPATIAL_EPOCHS), verbose=False,
                       device=DEVICE, **_fit_files(workdir, "ref_sp8x"))
    data2x, pad, batch = _spatial_data(seed)
    out["c"] = fit(data2x, [1], _spatial_2x_cfg(data2x, seed, pad, batch), verbose=False, device=DEVICE,
                   stream_data=True, **_fit_files(workdir, "ref_sp2x"))
    projs, rots = _fullres_1x_frames(seed)
    model, mcfg = load_net_from_checkpoint(member_path, device=DEVICE, verbose=False)
    times = []
    out["d"] = list(fullres_batches(lambda i0, i1: (projs[i0:i1], rots[i0:i1]), len(projs), projs.shape[1:], [model],
                                    1, model.num_lands, times, len(projs), mcfg.proj_unet_dim))
    out["d_fps"] = len(times) / sum(times)
    prep, hw = make_fullres_prep(1, mcfg.proj_unet_dim, projs.shape[1:])
    with torch.no_grad():
        seg = ensemble_forward([model], prep(torch.from_numpy(projs).to(DEVICE), torch.from_numpy(rots).to(DEVICE)),
                               hw, model.num_lands)[0]
        top2 = torch.topk(seg, 2, dim=1).values
    out["d_margin"] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    return out


def _benchmark_fit(seed, workdir):
    """Phase 4's recipe for SPATIAL_EPOCHS epochs in one process with
    ``cudnn.benchmark`` (fastest algorithms, not deterministic), the
    losses for (b)'s float32 spread."""
    from deepfluoro_tpu_torch.train import fit

    data = _smoke_data(seed)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    try:
        out = fit(data, [2, 3, 4, 5, 6], _recipe_cfg(data, seed, max_num_epochs=SPATIAL_EPOCHS), verbose=False,
                  device=DEVICE, **_fit_files(workdir, "spread"))
    finally:
        torch.backends.cudnn.benchmark = False
    return {"train": out["train_losses"], "valid": out["valid_losses"]}


def phase_spatial(seed, workdir, member_path, refs, card):
    """Phase 11 (see the module docstring), with deterministic cuDNN in
    every process of (b)-(d). Returns (summary, launches per path)."""
    from deepfluoro_tpu_torch.parallel.multihost import Ranks

    settings = {k: globals()[k] for k in SPATIAL_SETTINGS}
    go = os.path.join(workdir, "go_spatial")
    t0 = time.perf_counter()
    ranks = Ranks(_rank_spatial, 2, args=(seed, workdir, member_path, settings, go), device=DEVICE, backend="gloo")
    try:
        launches = {"jax_checkpoint_resume": _phase_jax_checkpoint(seed, workdir, card)}
        _rank_setup(True)
        try:
            one = _spatial_references(seed, workdir, member_path, refs)
        finally:
            _rank_setup(False)
        print("  (a) and the one-process references while the ranks start: {:.1f} s".format(time.perf_counter() - t0))
        t1 = time.perf_counter()
        open(go, "w").close()
        # while the ranks run: how far one process's own float32 trajectory
        # moves when only cuDNN's choice of algorithms changes
        one["spread"] = _benchmark_fit(seed, workdir)
        got = ranks.results(timeout=900)
        print("  (b)-(d) ran {:.1f} s after their go".format(time.perf_counter() - t1))
    finally:
        ranks.close()
    summary, more = _spatial_checks(one, got, card)
    launches.update(more)
    return summary, launches


def _spatial_checks(one, ranks, card):
    summary = {}
    loss_sp, g_sp, bufs_sp = ranks[0]["step"]
    loss_32, g_32, bufs_32 = one["step32"]
    g_64 = one["step64"][1]
    step_rel = abs(loss_sp - loss_32) / abs(loss_32)
    # per tensor: the bands' float32 gradient against float64, over one
    # process's float32 gradient against float64 (a floor of 1e-5 of the
    # tensor's largest value: float32's rounding of a sum)
    ratio = max((np.abs(g_sp[k] - g_64[k]).max() / max(np.abs(g_32[k] - g_64[k]).max(), 1e-5 * np.abs(g_64[k]).max()),
                 k) for k in g_64)
    buf_err = max(float(np.abs(r["step"][2][k] - bufs_32[k]).max()) for r in ranks for k in bufs_32)
    print("  (b) {} one step of the 8x recipe at full width from fit's initial weights (5 frames, augmentation off), "
          "row-sharded {} against one process: loss within {:.2e} relative (<= 1e-6); every gradient as close "
          "to one process's float64 step as one process's float32 step is: the worst ratio of the two errors {:.3f} "
          "({}; <= 2); BatchNorm running buffers within {:.2e} (<= 1e-6)".format(
              _card(card), _bands(TRAIN_PAD), step_rel, ratio[0], ratio[1], buf_err))
    if step_rel > 1e-6 or ratio[0] > 2.0 or buf_err > 1e-6:
        raise AssertionError("phase 11(b): the row-sharded step is not as exact as one process's float32 step")

    b = [r["b"] for r in ranks]
    want = one["b"]
    epoch = b[0]["steps"] // SPATIAL_EPOCHS
    first, rel = (max(v) for v in zip(*(_fit_rel(r, want, epoch) for r in b)))
    spread_first, spread = _fit_rel(one["spread"], want, epoch)
    want_b = np.asarray(want["train_losses"], np.float64)
    per_step = np.max([np.abs(np.asarray(r["train"], np.float64) - want_b) / np.abs(want_b) for r in b], axis=0)
    spread_step = np.abs(np.asarray(one["spread"]["train"], np.float64) - want_b) / np.abs(want_b)
    bn_equal = all(np.array_equal(b[0]["bn"][k], b[1]["bn"][k]) for k in b[0]["bn"])
    rates = [len(r["step_seconds"][1:]) / sum(r["step_seconds"][1:]) for r in b]
    print("  (b) {} gloo, two ranks sharing one card, {{'spatial': 2}}: fit on the 8x recipe (depth {}, wf {}, {}^2 "
          "from {}^2, batch 5) row-sharded {}, {} epochs, augmentation on: {} steps per rank, warp launches per "
          "rank {} (1 per step), losses against one process (deterministic cuDNN): first epoch within {:.2e} "
          "relative (<= 2e-3), all {:.2e} (<= 5e-2), per step {}; one process with cuDNN's benchmark algorithms "
          "against the same run: first epoch {:.2e}, all {:.2e}, per step {}; BatchNorm buffers equal across ranks: "
          "{}, {} steps/s per rank (two ranks sharing one card), peaks less baseline {} bytes".format(
              _card(card), TRAIN_DEPTH, TRAIN_WF, TRAIN_PAD, TRAIN_FRAME, _bands(TRAIN_PAD), SPATIAL_EPOCHS,
              b[0]["steps"], [r["launches"] for r in b], first, rel, ["%.1e" % v for v in per_step],
              spread_first, spread, ["%.1e" % v for v in spread_step], bn_equal, ["%.3f" % v for v in rates],
              [r["peak"] for r in b]))
    if first > 2e-3 or rel > 5e-2 or not bn_equal or any(r["launches"] != r["steps"] for r in b):
        raise AssertionError("phase 11(b): the row-sharded fit differs from one process")
    summary["b_spatial_8x"] = {"step_loss_rel": step_rel, "step_grad_error_ratio": float(ratio[0]),
                               "step_buffer_max_abs": buf_err, "steps_per_rank": b[0]["steps"],
                               "warp_launches": [r["launches"] for r in b],
                               "max_rel_loss_diff_first_epoch": first, "max_rel_loss_diff": rel,
                               "rel_loss_diff_per_step": per_step.tolist(),
                               "benchmark_spread_first_epoch": spread_first, "benchmark_spread": spread,
                               "benchmark_spread_per_step": spread_step.tolist(),
                               "bn_buffers_equal": bn_equal, "steps_per_s_two_ranks_sharing_one_card": rates,
                               "peak_less_baseline": [r["peak"] for r in b]}

    c = [r["c"] for r in ranks]
    rel = max(max(_rel(r["train"], one["c"]["train_losses"]), _rel(r["valid"], one["c"]["valid_losses"])) for r in c)
    rates = [len(r["step_seconds"][1:]) / max(sum(r["step_seconds"][1:]), 1e-9) for r in c]
    _, frame, pad, batch, _ = LADDER[0]
    print("  (c) {} 2x rung row-sharded over two ranks ({}^2 from {}^2, bands {}), bf16 + remat + streamed feed, "
          "batch {}, 1 epoch: {} steps per rank, warp launches per rank {}, losses within {:.2e} relative of one "
          "process with the same modes (<= 5e-3), {} steps/s per rank, peaks less baseline {} bytes".format(
              _card(card), pad, frame, _bands(pad), batch, c[0]["steps"], [r["launches"] for r in c], rel,
              ["%.3f" % v for v in rates], [r["peak"] for r in c]))
    if rel > 5e-3 or any(r["launches"] != r["steps"] for r in c):
        raise AssertionError("phase 11(c): the row-sharded 2x fit differs from one process")
    summary["c_spatial_2x"] = {"steps_per_rank": c[0]["steps"], "warp_launches": [r["launches"] for r in c],
                               "max_rel_loss_diff": rel, "steps_per_s_two_ranks_sharing_one_card": rates,
                               "peak_less_baseline": [r["peak"] for r in c]}

    got, want = ranks[0]["d"]["batches"], one["d"]
    labels_g = np.concatenate([l for _, l, _ in got])
    labels_w = np.concatenate([l for _, l, _ in want])
    heats_g = np.concatenate([h for _, _, h in got])
    heats_w = np.concatenate([h for _, _, h in want])
    heat_err = float(np.abs(heats_g - heats_w).max())
    mask = labels_g != labels_w
    differ = float(mask.mean())
    worst = float(one["d_margin"][mask].max()) if mask.any() else 0.0
    pad1x = FULLRES_RUNGS[-1][2]
    print("  (d) {} 1x full-res inference row-sharded over two ranks ({} raw {}^2 frames, {}^2 padded, bands {}): "
          "labels differ from one process on {:.4%} of pixels (< 0.1 %), where one process's top two are at most "
          "{:.2e} apart (near-ties: <= 1e-4), heats within {:.2e} (<= 1e-4); {:.3f} frames/s (two ranks sharing one "
          "card) against {:.3f} for one process; peaks less baseline {} bytes".format(
              _card(card), SPATIAL_FULLRES_FRAMES, FULLRES_DIM, pad1x, _bands(pad1x), differ, worst, heat_err,
              ranks[0]["d"]["fps"], one["d_fps"], [r["d"]["peak"] for r in ranks]))
    if labels_g.shape != labels_w.shape or differ >= 1e-3 or worst > 1e-4 or heat_err > 1e-4:
        raise AssertionError("phase 11(d): the row-sharded full-res inference differs from one process")
    summary["d_spatial_fullres_1x"] = {"label_share_differ": differ, "heats_max_abs": heat_err,
                                       "frames_per_s_two_ranks_sharing_one_card": ranks[0]["d"]["fps"],
                                       "one_process_frames_per_s": one["d_fps"],
                                       "peak_less_baseline": [r["d"]["peak"] for r in ranks]}
    return summary, {"spatial_training": sum(r["launches"] for r in b),
                     "spatial_2x_training": sum(r["launches"] for r in c)}


def _bands(rows):
    from deepfluoro_tpu_torch.parallel.mesh import row_layout

    return "+".join(str(r) for r in row_layout(rows, 2, 2 ** (TRAIN_DEPTH - 1)))


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
            ("4 training", lambda: phase_training(args.seed, workdir, results["1 environment"])),
            ("5 inference", lambda: phase_inference(args.seed, workdir, results["4 training"][1], results["1 environment"])),
            ("6 resume and stream", lambda: phase_resume_and_stream(args.seed, workdir, results["1 environment"])),
            ("7 folds", lambda: phase_folds(args.seed, workdir, results["1 environment"], results["3 kernel vs plain"][1])),
            ("8 ladder", lambda: phase_ladder(args.seed, workdir, results["5 inference"], results["1 environment"])),
            ("9 int8", lambda: phase_int8(args.seed, results["5 inference"], results["1 environment"])),
            ("10 distributed", lambda: phase_distributed(args.seed, workdir, results["5 inference"])),
            ("11 JAX checkpoints and spatial", lambda: phase_spatial(
                args.seed, workdir, os.path.join(workdir, "fullres_1x.pt"), results["10 distributed"][2],
                results["1 environment"])),
            ("12 profiler", lambda: phase_profiler(*results["3 kernel vs plain"])),
        ]
        results = {}
        for name, fn in phases:
            print("== phase {}".format(name), flush=True)
            t0 = time.perf_counter()
            results[name] = fn()
            print("== phase {} done in {:.1f} s".format(name, time.perf_counter() - t0), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernel = dict(results["3 kernel vs plain"][1])
    # each path's launches, counted from 0 around its runs; the total is their sum
    kernel["launches_per_path"] = {
        "training": results["4 training"][0],
        "resume_and_stream": results["6 resume and stream"],
        "folds": results["7 folds"],
        "ladder_2x_training": results["8 ladder"]["2x"],
        "ladder_1x_training": results["8 ladder"]["1x"],
        **results["10 distributed"][1],
        **results["11 JAX checkpoints and spatial"][1],
    }
    kernel["launches"] = sum(kernel["launches_per_path"].values())
    int8 = results["9 int8"]
    print("int8 summary: " + json.dumps({k: int8[k] for k in ("fps", "peak", "phase_peak", "gemm_launches",
                                                               "convs_total", "int8_float_label_agreement")}))
    print("distributed summary: " + json.dumps(results["10 distributed"][0]))
    print("spatial summary: " + json.dumps(results["11 JAX checkpoints and spatial"][0]))
    print("total {:.1f} s".format(time.perf_counter() - t_all))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
