"""The batch driver of the port's inference, ``run_batches``, which both
front ends return: ``infer/fullres.py::fullres_batches`` (raw full-res
frames) and ``infer/ensemble.py::ensemble_batches`` (a preprocessed
archive). The cuDNN policy, the padding rule, the spans (their
``fullres.*`` names are the ones the benchmark's readers hold) and the
readback are decided here, once (no JAX counterpart).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from deepfluoro_tpu_torch.utils.profiling import count, span

# candidates cuDNN times per convolution shape under measured_algorithms (in
# the order of its heuristics; torch's default is 10): at the 2x rung on an
# H100 the first forward then takes 2.8 s instead of 5.0-5.4 s, and the
# forward 49.5 ms instead of 49.1-49.4 ms
MEASURED_CANDIDATES = 5


@contextlib.contextmanager
def measured_algorithms():
    """A scope in which cuDNN picks each convolution's algorithm by timing
    its candidates (``torch.backends.cudnn.benchmark``), once per shape,
    at most ``MEASURED_CANDIDATES`` of them; the caller's ``benchmark``,
    ``deterministic`` and ``benchmark_limit`` come back on exit, also on
    an exception. TF32 and ``enabled`` stay as the caller set them."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic, cudnn.benchmark_limit
    # deterministic is set for the plan cache's key, not for
    # reproducibility: torch keys its cached cuDNN plans by shape, strides,
    # dtype, layout, deterministic and TF32, not by benchmark, so without it
    # a plan the heuristic chose for an earlier forward at the same shape
    # (a BatchNorm calibration, say) would be reused here. It costs the
    # transposed convolutions their fastest, non-deterministic algorithms:
    # 6.7 against 2.9 ms of a 49-50 ms forward at the 2x rung on an H100.
    # Measurement may pick other algorithms in another process.
    cudnn.benchmark = cudnn.deterministic = True
    cudnn.benchmark_limit = MEASURED_CANDIDATES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic, cudnn.benchmark_limit = saved


@torch.no_grad()
def run_batches(read_batch, n: int, frame_hw, run, dev, times, batch_size: int, writer: bool = True):
    """A generator of ``(start, labels, heats or None)`` numpy batches of
    ``run(projs, rot_flags) -> (labels, heats or None)`` (tensors on
    ``dev``) over ``n`` frames in order, which ``read_batch(i0, i1) ->
    (projs (i1 - i0, *frame_hw), rot_flags (i1 - i0,) bool)`` gives as
    numpy arrays. Every batch has ``batch_size`` rows: a final partial one
    is padded with its last frame, and only its real rows are yielded.
    That one shape runs once, on ones and no rotation, before the first
    read. Each forward runs inside ``measured_algorithms``, never across a
    yield: the consumer runs under the caller's cuDNN flags.

    With ``times`` each real frame gets its batch's wall-clock over its
    real frames: the copy to the device and ``run``, up to a synchronise;
    the readback falls outside. Each batch's arrays are its own, however
    long the consumer keeps them; on a CUDA device they are in page-locked
    host memory, with one wait a batch. With ``writer`` False (a mesh
    process other than 0) it yields (start, None, None); with ``n`` 0,
    nothing."""
    if not n:
        return

    def sync():
        count("host_syncs")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def readback(*xs):
        # on a card the copies land in page-locked blocks of torch's caching
        # host allocator (the DMA engine writes the arrays the consumer gets,
        # where a pageable copy is staged through a CUDA bounce buffer);
        # a block is reused only once its array is freed, so each batch's
        # arrays are its own however long they are kept
        count("host_syncs")
        if dev.type != "cuda":
            return [None if x is None else x.cpu().numpy() for x in xs]
        hosts = [None if x is None else torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
                 for x in xs]
        torch.cuda.current_stream(dev).synchronize()
        count("pinned_readbacks")
        return [None if h is None else h.numpy() for h in hosts]

    with measured_algorithms():
        run(torch.ones((batch_size, *frame_hw), device=dev), torch.zeros((batch_size,), dtype=torch.bool, device=dev))
    sync()

    for i0 in range(0, n, batch_size):
        # no span stays open across the yield, where the consumer runs
        with span("fullres.batch", i0):
            i1 = min(i0 + batch_size, n)
            real_b = i1 - i0
            projs, rots = read_batch(i0, i1)
            if real_b < batch_size:
                pad = batch_size - real_b
                projs = np.concatenate([projs, np.repeat(projs[-1:], pad, axis=0)])
                rots = np.concatenate([rots, np.repeat(rots[-1:], pad)])
            t0 = time.perf_counter()
            with span("fullres.copy_up", i0):
                projs, rots = torch.from_numpy(projs).to(dev), torch.from_numpy(rots).to(dev)
            with span("fullres.forward", i0), measured_algorithms():
                labels, heats = run(projs, rots)
            with span("fullres.sync", i0):
                sync()
            elapsed = time.perf_counter() - t0
            if times is not None:
                times.extend([elapsed / real_b] * real_b)
            if writer:
                with span("fullres.readback", i0):
                    labels, heats = readback(labels[:real_b], None if heats is None else heats[:real_b])
            else:
                labels = heats = None
        yield i0, labels, heats
