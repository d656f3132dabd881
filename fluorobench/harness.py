"""What every cell shares: finding a cell's files by name, the harness's
own spans, the profiler's trace reduced to device time, the check of what
the run loaded, the comparisons that decide ``correct``, and the result
line.

A cell's configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (whose ``runner`` names the module under
``runners/`` that runs it), its limits ``workloads/<cell>.json``, and each
per-layer metric a reader ``metrics/<metric>.py`` with ``read(run)``
returning a number or None. ``BENCHMARK.json`` at the checkout's root
says which cell takes which configuration, traffic and metrics.

A runner module has ``main(run)`` (set-up, the window, the check),
``check(run, num)`` and ``CONTROL`` (the control's numerics),
``faults(cell)`` (the names of the faults the cell can have: ``faults.py``'s
or the runner's own ``FAULTS``), and ``test_size(cell)`` (the cell cut to
what the CPU tests run in seconds, and its window's seconds there).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "deepfluoro_tpu")


def loaded_forbidden() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name (before the first
    dot, compared whole) is JAX's, one of its libraries' or the JAX
    package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN_MODULES})


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (by default ``root/BENCHMARK.json``)
    with its files."""
    bench = bench or read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit("no workload {!r} in BENCHMARK.json".format(name))
    config = read_json(HERE / "configs" / "{}.json".format(entry["config"]))
    traffic = read_json(HERE / "traffic" / "{}.json".format(entry["traffic"]))
    limits = read_json(HERE / "workloads" / "{}.json".format(name))["limits"]
    reported = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    e2e = [m for m in bench["end_to_end"] if m["name"] in reported]
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, config, traffic, limits, int(entry["chips"]), e2e, layer)


def load_runner(cell: Cell):
    """The module under ``runners/`` that the cell's traffic names."""
    return importlib.import_module("fluorobench.runners.{}".format(cell.traffic["runner"]))


def load_reader(metric: str):
    path = HERE / "metrics" / "{}.py".format(metric)
    spec = importlib.util.spec_from_file_location("fluorobench_metric_{}".format(metric.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The harness's own spans around its calls into the program: each
    name's durations in seconds; under a trace also a profiler range of
    the same name."""

    def __init__(self):
        self.times: dict[str, list[float]] = {}
        self.traced = False
        self.ranges = []  # (start, end, name) on the profiler's clock, while traced

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        t0, w0 = time.perf_counter(), time.time_ns()
        with ctx:
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        if self.traced:
            self.ranges.append((w0, time.time_ns(), name))


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict  # device seconds per kernel name
    kernel_calls: dict
    device_ops: list  # [[name, seconds]] most time first
    idle_gaps: list  # [[what the host was doing, seconds]] most time first
    reduce_s: float = 0.0


def _union_seconds(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def summarize_trace(prof, t0_ns: int, t1_ns: int, spans=()) -> TraceSummary:
    """Device busy time (the union of every kernel, copy and set on the
    card), device time per kernel name, and the longest idle gaps named by
    the innermost host range that spans each, within [t0_ns, t1_ns] of the
    profiler's clock."""
    dev, host, ranges = [], [], set()
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        d = e.duration_ns()
        if s + d < t0_ns or s > t1_ns:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((max(s, t0_ns), min(s + d, t1_ns), e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
            if e.is_user_annotation():
                ranges.add(e.name())
    # a profiler range mirrored on the device's timeline is no device work
    dev = [x for x in dev if x[2] not in ranges]
    kernel_s, calls = {}, {}
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e9
        calls[name] = calls.get(name, 0) + 1
    busy = _union_seconds([(s, e) for s, e, _ in dev])
    gaps, end = [], t0_ns
    for s, e, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1_ns > end:
        gaps.append((end, t1_ns))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    host.sort()
    starts = [h[0] for h in host]

    def innermost(ranges, mid):
        best = None
        for s, e, name in ranges:
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best

    named = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        best = innermost(host[max(0, i - 2000) : i], mid) or innermost(spans, mid)
        what = best[2] if best else "no host range"
        named[what] = named.get(what, 0.0) + (g1 - g0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return TraceSummary((t1_ns - t0_ns) / 1e9, busy, kernel_s, calls, top(kernel_s), top(named))


class Trace:
    """A ``torch.profiler`` window (CPU and CUDA activity) over the
    measured window, or nothing when tracing is off."""

    def __init__(self, enabled: bool, spans: Spans):
        self.enabled = enabled
        self.spans = spans
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self.spans.traced = True
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            t1 = time.time_ns()
            t = time.perf_counter()
            self._prof.__exit__(*exc)
            self.spans.traced = False
            if exc[0] is None:
                self.summary = summarize_trace(self._prof, self._t0, t1, self.spans.ranges)
                self.summary.reduce_s = time.perf_counter() - t
            self._prof = None
        return False


@dataclasses.dataclass
class Run:
    """One run of one cell: what the runner measures and what the metric
    readers read."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int = 1
    rank: int = 0  # this process's among the cell's processes, one a card; rank 0 checks and reports
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: float | None = None
    window_s: float | None = None
    end_to_end: dict = dataclasses.field(default_factory=dict)
    values: dict = dataclasses.field(default_factory=dict)  # the runner's own readings, for the readers
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: list = dataclasses.field(default_factory=list)  # [name, value, limit]
    check_inputs: dict = dataclasses.field(default_factory=dict)  # what the runner's check reads
    trace_summary: TraceSummary | None = None

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def open_window(self):
        self.sync()
        found = loaded_forbidden()
        if found:
            raise SystemExit("set-up loaded {}".format(", ".join(found)))
        self.setup_s = time.perf_counter() - self.t_start

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_peak(self):
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def check(self, name: str, value: float):
        """Compare ``value`` with the cell's limit of ``name``: at most it."""
        self.checks.append([name, float(value), float(self.cell.limits[name])])

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def card_power_limit() -> str:
    """The card's name, power limit, and its clock, draw and temperature now."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def result(run: Run) -> dict:
    """The last line's object; ``checks`` comes last."""
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            v = run.setup_s if m["name"] == "setup_s" else run.end_to_end.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "count": run.chips,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary.busy_s
        device["window_s"] = run.trace_summary.window_s
        out["breakdown"] = {"device_ops": run.trace_summary.device_ops, "idle_gaps": run.trace_summary.idle_gaps}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def mfu_pct(run: Run) -> float | None:
    """The window's share of its cards' float32 peak: the operations
    ``counts.py`` works out from the configuration's shapes for each frame
    completed (on all cards), times the frames, over the window and the
    run's cards, in %."""
    from fluorobench import counts

    if not run.values.get("frames") or not run.window_s:
        return None
    peak = run.chips * counts.FP32_FLOPS_PER_S
    return 100.0 * run.values["flops_per_frame"] * run.values["frames"] / run.window_s / peak


def idle_pct(run: Run) -> float | None:
    """The share of the traced window in which no kernel, copy or set ran
    on the card, in %."""
    t = run.trace_summary
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def summary(run: Run) -> dict:
    """What a run prints at its end: ``err``, the lines for standard error
    (what the check compared last), and ``line``, the result object."""
    err = ["card after the window: {}".format(run.values.get("card"))]
    t0 = time.perf_counter()
    line = result(run)
    err.append("card at the end: {}; setup_s {:.4f}; window_s {:.4f}; check_s {}; trace_s {}; result_s {:.3f}".format(
        card_power_limit(), run.setup_s, run.window_s, run.values.get("check_s"),
        getattr(run.trace_summary, "reduce_s", None), time.perf_counter() - t0))
    err.append("set-up: " + ", ".join("{} {:.3f} s".format(k, sum(v)) for k, v in run.spans.times.items()
                                      if k.startswith("setup.")))
    for name, v, lim in run.checks:
        err.append("check {}: {} (limit {}){}".format(name, v, lim, "" if v <= lim else "  FAILED"))
    return {"err": err, "line": line}


def emit(summary: dict, elsewhere=()) -> int:
    """Print a ``summary``: its lines on standard error, its result object
    on standard output; nothing on standard output when JAX or the JAX
    package is loaded in this process or, as ``elsewhere`` lists, in
    another process of the run. Returns the exit code."""
    found = sorted(set(loaded_forbidden()) | set(elsewhere))
    if found:
        print("loaded in the run's processes: {}".format(", ".join(found)), file=sys.stderr)
        return 3
    for text in summary["err"]:
        print(text, file=sys.stderr)
    print(json.dumps(summary["line"]), flush=True)
    return 0


def control_line(run: Run, runner, fault: str | None) -> dict:
    """``control.py``'s line for one seed: the program's compared numbers
    and, without a fault, the control's, held to the same limits by the
    runner's own ``check``."""
    line = {"seed": run.seed, "fault": fault or "none", "correct": run.correct,
            "program": {n: v for n, v, _ in run.checks}, "setup_s": run.setup_s, "window_s": run.window_s,
            "end_to_end": run.end_to_end, "memory_peak_bytes": run.memory_peak_bytes,
            "detail": run.values.get("check_detail")}
    if fault in (None, "none"):
        control = dataclasses.replace(run, checks=[], values=dict(run.values))
        t0 = time.perf_counter()
        runner.check(control, runner.CONTROL)
        line.update(control_correct=control.correct, control={n: v for n, v, _ in control.checks},
                    control_detail=control.values.get("check_detail"), control_s=time.perf_counter() - t0)
    return line
