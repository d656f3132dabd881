"""The one rule by which the port chooses between eager launches and one
CUDA graph, shared by inference (``infer/batches.py::run_batches``) and
the training step (``train/step.py::StepGraph``); no JAX counterpart.

A piece of work is run eagerly on a card ``TIMED_RUNS`` times for its
times (``timed``): the host's dispatch, from the call to its return,
against the card's time for it, from CUDA events around the call. The
caller captures the work once and replays it where the dispatch is at
least ``GRAPH_DISPATCH_SHARE`` of the card's time (``graph_pays``: the
card waits for the host's launches).
"""

from __future__ import annotations

import gc
import time

import torch

# the host's dispatch, as a share of the card's time for the same work, at
# or above which the card waits for the host and the work is replayed as
# one CUDA graph. Where the host sets the pace the card's time holds its
# waits for the launches, and the share reads about 1: 0.996 at batch 1 of
# the K = 6 ensemble forward at the 8x rung on an H100; 0.16 at batch 4 at
# the 2x rung and at batch 64 at 8x
GRAPH_DISPATCH_SHARE = 0.5
# eager runs timed for that decision, after an untimed first one, each side
# the least of them: a preempted host, or an allocation the first run
# makes, only lengthens a dispatch (one timed forward of a TransUNet at
# batch 4 at the 2x rung read 0.49 where another read 0.22)
TIMED_RUNS = 2


def graph_pays(dispatch_s: float, device_s: float) -> bool:
    """Whether work whose host dispatch took ``dispatch_s`` and whose run on
    the card took ``device_s`` is worth replaying as one CUDA graph: where
    the dispatch is at least ``GRAPH_DISPATCH_SHARE`` of the card's time,
    the card waits for the host's launches."""
    return dispatch_s >= GRAPH_DISPATCH_SHARE * device_s


def timed(fn):
    """``(fn(), dispatch_s, device_s)`` for a call of ``fn`` that enqueues
    work on the current CUDA stream: the host's time from the call to its
    return, and the card's between CUDA events recorded before and after
    it. Waits for the second event."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = fn()
    dispatch_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return out, dispatch_s, start.elapsed_time(end) / 1e3


def on_stream(fn, stream):
    """``fn()`` with ``stream`` (a CUDA stream, or None: the current one) as
    the current stream, ordered after the work already enqueued on the
    current stream and before the work enqueued there after it."""
    if stream is None:
        return fn()
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def capture(fn, stream, generator=None):
    """``(graph, fn())``: the work ``fn`` enqueues captured on ``stream`` as
    one CUDA graph, whose ``replay()`` runs it again on the same tensors;
    with a CUDA ``generator`` its draws, each replay taking them from the
    generator's state at that moment and advancing it as an eager call
    does. The capture runs nothing. The caller has run ``fn``'s work
    eagerly on ``stream`` before (``on_stream``): the libraries set up what
    they keep per stream (cuBLAS's workspaces inside cuDNN's FFT
    convolutions) there, where a capture could not. The cyclic garbage
    collector runs before the capture, not during it, and calls that other
    threads (a checkpoint writer, a prefetch producer) make into the CUDA
    runtime meanwhile do not invalidate it (``relaxed``): only work on the
    capturing stream is captured."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    return graph, out
