"""Cells of several cards: one process a card, rank 0 checking and
reporting (``ranks.py``), here four gloo processes on the CPU.

The four-card cell ``train-8x-dp4`` brings its files (``traffic/
fold-8x-dp4.json``, ``workloads/train-8x-dp4.json``, its three readers) but
is not in ``BENCHMARK.json``: its runs on four H100s spread too widely
(PERF.md section 7). The tests run it with the entries it would append to
``BENCHMARK.json``: a sound run comes out correct, the control and each
fault its runner declares for it (the exchange between the ranks left out
among them) come out not correct."""

import json

import pytest
import torch

from fluorobench import harness, ranks
from fluorobench.tests.small import ROOT, run_small

DP4 = {"name": "train-8x-dp4", "config": "deepfluoro-8x", "traffic": "fold-8x-dp4", "chips": 4,
       "why": "fold-8x's fit data-parallel on four cards, 5 frames a card (global batch 20): NCCL all-reduces of "
              "gradients and synchronized BatchNorm each step"}
DP4_METRICS = [
    {"name": "allreduce_ms.dp4", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "collectives (parallel/sharding.py, models/unet.py's synchronized BatchNorm, NCCL)",
     "moves": "train_frames_per_s", "workloads": ["train-8x-dp4"]},
    {"name": "mfu.dp4", "unit": "%", "better": "higher", "source": "host_clock",
     "layer": "model step (models/unet.py, train/step.py)", "moves": "train_frames_per_s",
     "workloads": ["train-8x-dp4"]},
    {"name": "device_idle_pct.dp4", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
     "moves": "train_frames_per_s", "workloads": ["train-8x-dp4"]},
]


def dp4_bench() -> dict:
    """``BENCHMARK.json`` with ``train-8x-dp4``'s names appended."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(DP4)
    next(m for m in bench["end_to_end"] if m["name"] == "train_frames_per_s")["workloads"].append(DP4["name"])
    bench["per_layer"] += DP4_METRICS
    return bench


CELL = harness.load_cell(ROOT, DP4["name"], dp4_bench())
FAULTS = harness.load_runner(CELL).faults(CELL)


@pytest.fixture(scope="module")
def sound():
    return run_small(DP4["name"], trace=True, control=True, bench=dp4_bench())


def test_the_cell_finds_its_files_and_reports_enough():
    assert CELL.chips == 4 and set(CELL.limits) == set(harness.load_cell(ROOT, "train-8x").limits)
    assert {m["name"] for m in CELL.end_to_end} == {"train_frames_per_s", "setup_s"}
    assert {m["name"] for m in CELL.per_layer} == {m["name"] for m in DP4_METRICS}
    assert all(callable(harness.load_reader(m["name"])) for m in DP4_METRICS)
    assert "no_exchange" in FAULTS


def test_four_ranks_run_the_cell_correct(sound):
    run, out = sound["run"], sound["line"]
    assert run.correct, run.checks
    assert run.chips == 4 and out["device"]["count"] == 4
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(CELL.limits)
    assert out["attempted"] == run.values["frames"] > 0 and out["failed"] == 0 and out["correct"] is True
    assert set(out["metrics"]) <= {m["name"] for m in DP4_METRICS} and "mfu.dp4" in out["metrics"]
    assert sound["err"][-len(run.checks):] == ["check {}: {} (limit {})".format(n, v, lim) for n, v, lim in run.checks]
    run.trace = False
    assert set(harness.result(run)["metrics"]) == {"train_frames_per_s", "setup_s"}


def test_control_fails(sound):
    line = sound["control"]
    assert line["correct"] is True, line["program"]
    assert line["control_correct"] is False, line["control"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_are_not_correct(fault):
    assert run_small(DP4["name"], fault, bench=dp4_bench())["line"]["correct"] is False


def test_merge_takes_the_fullest_card_and_the_mean_busy_time():
    line = {"correct": True, "device": {"count": 1, "memory_peak_bytes": 5, "busy_s": 2.0}, "checks": {}}
    reports = [{"rank": 1, "peak": 9, "busy_s": 4.0, "forbidden": ["jax"]},
               {"rank": 0, "peak": 5, "busy_s": 2.0, "forbidden": [], "line": line, "err": ["check a: 1 (limit 2)"]}]
    out = ranks.merge(reports, 2)
    assert out["line"]["device"] == {"count": 2, "memory_peak_bytes": 9, "busy_s": 3.0}
    assert list(out["line"]) == ["correct", "device", "checks"] and out["err"][-1] == "check a: 1 (limit 2)"
    assert out["forbidden"] == ["jax"]


def test_allreduce_reader_reads_nccl_kernels_per_step():
    run = harness.Run(cell=CELL, seed=1, seconds=1.0, trace=True, device=torch.device("cpu"), chips=4)
    read = harness.load_reader("allreduce_ms.dp4")
    assert read(run) is None
    run.values["step_seconds"] = [0.1] * 4
    run.trace_summary = harness.TraceSummary(1.0, 0.5, {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.02,
                                                        "ncclKernel_AllReduce_RING_LL_Sum_double": 0.01,
                                                        "sm80_xmma_fprop": 0.3}, {}, [], [])
    assert read(run) == pytest.approx(7.5)  # (20 + 10) ms over 4 steps
    run.trace_summary.kernel_s = {"sm80_xmma_fprop": 0.3}
    assert read(run) is None


def test_mfu_divides_by_every_card():
    run = harness.Run(cell=CELL, seed=1, seconds=1.0, trace=False, device=torch.device("cpu"), chips=1)
    run.values.update(frames=100, flops_per_frame=6.7e11)
    run.window_s = 1.0
    assert harness.mfu_pct(run) == pytest.approx(100.0)
    run.chips = 4
    assert harness.mfu_pct(run) == pytest.approx(25.0)
