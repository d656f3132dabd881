"""Tracing, the program's own spans and counters, and NaN debugging (JAX
counterpart: ``deepfluoro_tpu/utils/profiling.py``).

- ``profile_trace``: a ``torch.profiler`` scope over CPU and, where a card
  is present, CUDA activity that writes a TensorBoard-loadable trace file
  into a directory (``--profile-dir`` of the ``train``, ``test_ensemble``
  and ``seg_fullres`` CLIs). The program's spans appear in that trace
  under their names.
- ``span``, ``count``, ``recorded``, ``reset``: the program's spans
  (``fit.*`` in ``train/loop.py``, ``fullres.*`` in ``infer/batches.py``,
  the batch driver of both inference front ends, ``landmarks.detect``)
  and counters (``host_syncs``, each blocking read of the device on those
  paths; ``pinned_readbacks``, each inference batch read back from a card
  through page-locked host memory; ``step_graph_replays``, each training
  step replayed from ``train/step.py::StepGraph``'s CUDA graph).
  They record only while a ``torch.profiler`` session is active on the
  calling thread (as
  ``torch.autograd._profiler_enabled()`` reports), into memory, and write
  nothing: a span is then also a ``record_function`` range of the same
  name. While the session runs its start and end are ``time.time_ns()``,
  the clock the profiler's events carry; when the session ends they
  become its range's own start and end (``_settle``), so a thread switch
  or a preemption between the two clocks' reads leaves no gap. With no
  profiler, ``span`` returns a shared null context after one check and
  ``count`` returns at once. The recording is one per process, as the
  profiler is.
- ``span(name, device=True)`` and ``device_seconds``: where a span asks
  for it, the device time of the kernels, copies and sets launched inside
  its ranges, summed when each session ends over the kernels whose
  launching op (the CPU op the profiler links the kernel to) began inside
  a range of that name on the same thread (``models/samed.py``'s
  ``samed.rel_pos_attention``: the rel-pos mask and its SDPA call). A
  session without CUDA activity gives 0.
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly``, so the
  backward op that first produces a NaN raises with the forward's trace
  (``train --debug-nans``; the JAX package's ``jax_debug_nans``).
"""

from __future__ import annotations

import bisect
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
_unsettled: list[Span] = []  # spans closed in the running session, on time.time_ns()
_session = 0  # how many sessions have ended since the first span
_hooked = False
_device_named: set[str] = set()  # span names whose device time is summed
_device_s: dict[str, float] = {}


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


def _hook_session_end() -> None:
    """Have ``_settle`` see the result of every profiler session that
    ends from now on: ``torch.autograd.profiler.profile.__exit__``, which
    ``torch.profiler.profile`` runs, takes the session's events from the
    module's ``_disable_profiler``. Where torch has no such function the
    spans keep their own clock reads."""
    global _hooked
    from torch.autograd import profiler as autograd_profiler

    with _counts_lock:
        if _hooked:
            return
        _hooked = True
        disable = getattr(autograd_profiler, "_disable_profiler", None)
        if disable is None:
            return

        def _disable_profiler(*args, **kwargs):
            result = disable(*args, **kwargs)
            _settle(result)
            return result

        autograd_profiler._disable_profiler = _disable_profiler


def _settle(result) -> None:
    """Give each span closed in the session that just ended its range's
    start and end from the session's ``result``: the ranges of a name, in
    start order, to the spans of that name in start order. A name with as
    many spans as ranges only: where the profiler left a thread's ranges
    out, that name's spans keep their clock reads."""
    global _session
    with _counts_lock:
        spans = _unsettled[:]
        _unsettled.clear()
        _session += 1
        timed = {s.name for s in spans} & _device_named
    events = getattr(result, "events", None)
    if not spans or events is None:
        return
    events = events()
    if timed:
        found = device_time_inside(events, timed)
        with _counts_lock:
            for name, seconds in found.items():
                _device_s[name] = _device_s.get(name, 0.0) + seconds
    ranges: dict[str, list] = {}
    for e in events:
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    mine: dict[str, list] = {}
    for s in spans:
        mine.setdefault(s.name, []).append(s)
    for name, group in mine.items():
        theirs = sorted(ranges.get(name, ()))
        if len(theirs) == len(group):
            for s, (start, end) in zip(sorted(group, key=lambda s: s.start_ns), theirs):
                s.start_ns, s.end_ns = start, end


def device_time_inside(events, names) -> dict[str, float]:
    """Device seconds, per name of ``names``, of the kernels, copies and
    sets among the profiler's ``events`` whose launching op began inside a
    CPU range of that name on the op's own thread. A range mirrored on the
    device's timeline (a device event named as a CPU range) is no device
    work."""
    cpu = torch.autograd.DeviceType.CPU
    ops, launched, annotations, spans = {}, [], set(), {name: {} for name in names}
    for e in events:
        if e.device_type() == cpu:
            if e.is_user_annotation():
                annotations.add(e.name())
                if e.name() in spans:
                    spans[e.name()].setdefault(e.start_thread_id(), []).append(
                        (e.start_ns(), e.start_ns() + e.duration_ns()))
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif not e.is_user_annotation() and e.linked_correlation_id() > 0:
            launched.append((e.name(), e.linked_correlation_id(), e.duration_ns()))
    launched = [(corr, ns) for name, corr, ns in launched if name not in annotations]
    out = {}
    for name, threads in spans.items():
        found = {tid: sorted(r) for tid, r in threads.items()}
        starts = {tid: [s for s, _ in r] for tid, r in found.items()}
        total = 0
        for corr, ns in launched:
            t, tid = ops.get(corr, (None, None))
            if tid not in found:
                continue
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t <= found[tid][i][1]:
                total += ns
        out[name] = total / 1e9
    return out


class Span:
    """One recorded span: ``name``, ``id`` (the caller's, or None), the
    span that enclosed it on the same thread when it began (``parent``, a
    ``Span`` or None), and ``start_ns``/``end_ns``: its profiler range's
    once the session has ended, ``time.time_ns()`` reads until then."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "_range", "_session")

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
        if not _hooked:
            _hook_session_end()
        self._session = _session
        self._range = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        with _counts_lock:
            _spans.append(self)
            if self._session == _session:
                _unsettled.append(self)
        return False

    def __repr__(self) -> str:
        return "Span({!r}, id={!r}, {:.3f} ms)".format(self.name, self.id, self.ms)


def span(name: str, id=None, device: bool = False):
    """A context manager that records ``name`` (with ``id``) over its body
    while a profiler is active on this thread; otherwise a shared null
    context. With ``device`` the device time of what it launches is summed
    under ``name`` when the session ends (``device_seconds``)."""
    if not _profiler_enabled():
        return _NULL
    if device:
        _device_named.add(name)
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


def device_seconds() -> dict[str, float]:
    """The device seconds of what each ``span(..., device=True)`` name
    launched, over the sessions ended since the last ``reset``."""
    with _counts_lock:
        return dict(_device_s)


def reset() -> None:
    """Forget every recorded span, counter and span's device time."""
    with _counts_lock:
        _spans.clear()
        _counts.clear()
        _unsettled.clear()
        _device_s.clear()


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
