"""Tracing, the program's own spans and counters, and NaN debugging (JAX
counterpart: ``deepfluoro_tpu/utils/profiling.py``).

- ``profile_trace``: a ``torch.profiler`` scope over CPU and, where a card
  is present, CUDA activity that writes a TensorBoard-loadable trace file
  into a directory (``--profile-dir`` of the ``train``, ``test_ensemble``
  and ``seg_fullres`` CLIs). The program's spans appear in that trace
  under their names.
- ``span``, ``count``, ``recorded``, ``reset``: the program's spans
  (``fit.*`` in ``train/loop.py``, ``fullres.*`` in ``infer/fullres.py``,
  ``landmarks.detect``) and counters (``host_syncs``, each blocking read
  of the device on those paths; ``measured_algo_runs``, each full-res
  batch forward run under ``infer/fullres.py::measured_algorithms``).
  They record only while a ``torch.profiler`` session is active on the
  calling thread (as
  ``torch.autograd._profiler_enabled()`` reports), into memory, and write
  nothing: a span is then also a ``record_function`` range of the same
  name, and its start and end are ``time.time_ns()``, the clock the
  profiler's events carry. With no profiler, ``span`` returns a shared
  null context after one check and ``count`` returns at once. The
  recording is one per process, as the profiler is.
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, so the
  backward op that first produces a NaN raises with the forward's trace
  (``train --debug-nans``; the JAX package's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import _profiler_enabled

_NULL = contextlib.nullcontext()
_spans: list[Span] = []
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans, innermost last


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` trace scope writing ``<host>_<pid>.<ms>.pt.trace.
    json`` into ``log_dir`` when it ends; a no-op for a falsy ``log_dir``.
    While it runs, the program's spans are recorded in memory (``recorded``)
    and appear in the trace as ranges of their names."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Span:
    """One recorded span: ``name``, ``id`` (the caller's, or None), the
    span that enclosed it on the same thread when it began (``parent``, a
    ``Span`` or None), and ``start_ns``/``end_ns`` on ``time.time_ns()``."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, id=None, parent: Span | None = None, start_ns: int = 0, end_ns: int = 0):
        self.name, self.id, self.parent, self.start_ns, self.end_ns = name, id, parent, start_ns, end_ns

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self) -> Span:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        # each clock read comes just before the range's own: the range's
        # calls release the interpreter lock, and another thread may hold
        # it for a switch interval before they return
        self.start_ns = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        _spans.append(self)
        return False

    def __repr__(self) -> str:
        return "Span({!r}, id={!r}, {:.3f} ms)".format(self.name, self.id, self.ms)


def span(name: str, id=None):
    """A context manager that records ``name`` (with ``id``) over its body
    while a profiler is active on this thread; otherwise a shared null
    context."""
    if not _profiler_enabled():
        return _NULL
    return Span(name, id)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler is active on this
    thread."""
    if not _profiler_enabled():
        return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def recorded() -> tuple[list[Span], dict[str, int]]:
    """(the closed spans in the order they ended, the counters) recorded
    since the last ``reset``."""
    with _counts_lock:
        return list(_spans), dict(_counts)


def reset() -> None:
    """Forget every recorded span and counter."""
    with _counts_lock:
        _spans.clear()
        _counts.clear()


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
