"""Tracing, step timing and NaN debugging (JAX counterpart:
``deepfluoro_tpu/utils/profiling.py``).

- ``profile_trace``: a ``torch.profiler`` scope over CPU and, where a card
  is present, CUDA activity that writes a TensorBoard-loadable trace file
  into a directory (``--profile-dir`` of the ``train``, ``test_ensemble``
  and ``seg_fullres`` CLIs).
- ``StepTimer``: per-step wall-clock with a mean/p50/p95 summary.
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, so the
  backward op that first produces a NaN raises with the forward's trace
  (``train --debug-nans``; the JAX package's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` trace scope writing ``<host>_<pid>.<ms>.pt.trace.
    json`` into ``log_dir`` when it ends; a no-op for a falsy ``log_dir``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Accumulates per-step durations; ``summary`` gives mean/p50/p95."""

    def __init__(self):
        self.durations: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        if not self.durations:
            return {"count": 0}
        ds = sorted(self.durations)
        n = len(ds)
        return {
            "count": n,
            "mean_s": sum(ds) / n,
            "p50_s": ds[n // 2],
            "p95_s": ds[min(n - 1, int(0.95 * n))],
            "total_s": sum(ds),
        }
