"""The batch driver of the port's inference, ``run_batches``, which both
front ends return: ``infer/fullres.py::fullres_batches`` (raw full-res
frames) and ``infer/ensemble.py::ensemble_batches`` (a preprocessed
archive). The cuDNN policy, the padding rule, the spans (their
``fullres.*`` names are the ones the benchmark's readers hold), the
readback and the choice between eager forwards and one CUDA graph are
decided here, once (no JAX counterpart).
"""

from __future__ import annotations

import contextlib
import logging
import math
import time

import numpy as np
import torch

from deepfluoro_tpu_torch.models.unet import UNet
from deepfluoro_tpu_torch.utils.graphs import TIMED_RUNS, capture, graph_pays, on_stream, timed
from deepfluoro_tpu_torch.utils.profiling import count, span

# candidates cuDNN times per convolution shape under measured_algorithms (in
# the order of its heuristics; torch's default is 10): at the 2x rung on an
# H100 the first forward then takes 2.8 s instead of 5.0-5.4 s, and the
# forward 49.5 ms instead of 49.1-49.4 ms
MEASURED_CANDIDATES = 5

_log = logging.getLogger(__name__)


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


def may_capture(models, mesh=None, quantized: bool = False) -> bool:
    """Whether a front end's forward over ``models`` may be offered to
    ``run_batches`` for one CUDA graph: on one device (a mesh's ranks must
    not decide apart, and gloo's collectives cannot be captured), in float
    (the int8 forwards stay eager), and with U-Net members only: a
    TransUNet's, a Swin UNETR's or a SAMed's forward records its spans and
    its ``attention_calls``, ``window_attention_calls`` or
    ``rel_pos_attention_calls`` on the host, which a replay would not
    record."""
    return mesh is None and not quantized and all(isinstance(m, UNet) for m in models)


def _captured(run, projs, rots):
    """``(graph, outputs)``: ``run(projs, rots)`` on these device tensors
    captured as one CUDA graph, whose replays read them and write
    ``outputs``; or None where ``graph_pays`` says no. ``TIMED_RUNS``
    eager forwards measure both sides: the host's dispatch (the call to its
    return) and the card's time (CUDA events around it), the last on the
    stream the capture uses. The decision is logged at INFO. The forwards
    before it chose and cached every convolution's algorithm, so the
    capture times no candidate."""
    dispatch_s = device_s = math.inf
    stream = torch.cuda.Stream(projs.device)
    with measured_algorithms():
        for i in range(TIMED_RUNS):
            on = stream if i == TIMED_RUNS - 1 else None
            _, dispatch, device = timed(lambda: on_stream(lambda: run(projs, rots), on))
            dispatch_s, device_s = min(dispatch_s, dispatch), min(device_s, device)
        pays = graph_pays(dispatch_s, device_s)
        _log.info("batch of %d: host dispatch %.3f ms, card %.3f ms: %s", int(projs.shape[0]), 1e3 * dispatch_s,
                  1e3 * device_s, "one CUDA graph" if pays else "eager")
        if not pays:
            return None
        return capture(lambda: run(projs, rots), stream)


@torch.no_grad()
def run_batches(read_batch, n: int, frame_hw, run, dev, times, batch_size: int, writer: bool = True,
                graphable: bool = False):
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
    nothing.

    Every batch's frames (as float32) and flags are copied into the same
    two device tensors. With ``graphable`` (the caller's ``run`` makes no
    host sync, collective or random draw, and records no span or counter:
    ``may_capture``) on a CUDA device, timed warm-up forwards decide by
    ``graph_pays`` whether ``run`` is captured as one CUDA graph on those
    tensors (``_captured``); each batch then replays it (counter
    ``graph_replays``). Its outputs are read back before the generator
    yields, so no replay overwrites what the consumer has not received.
    On the CPU nothing is captured."""
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

    projs_d = torch.ones((batch_size, *frame_hw), device=dev)
    rots_d = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    with measured_algorithms():
        run(projs_d, rots_d)
    sync()
    graphed = _captured(run, projs_d, rots_d) if graphable and dev.type == "cuda" else None

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
                projs_d.copy_(torch.from_numpy(projs))
                rots_d.copy_(torch.from_numpy(rots))
            with span("fullres.forward", i0):
                if graphed is None:
                    with measured_algorithms():
                        labels, heats = run(projs_d, rots_d)
                else:
                    graphed[0].replay()
                    count("graph_replays")
                    labels, heats = graphed[1]
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
