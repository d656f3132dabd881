"""Cells cut to a size the CPU runs in seconds, for the tests: each
runner's ``test_size`` says how its cells are cut and how long their
window lasts. A cell of several cards runs in as many gloo processes on
the CPU (``ranks.py``)."""

import time
from pathlib import Path

import torch

from fluorobench import faults, harness, ranks

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def _cut(name: str, bench: dict | None = None):
    cell = harness.load_cell(ROOT, name, bench)
    return harness.load_runner(cell).test_size(cell)


def small_cell(name: str) -> harness.Cell:
    """A cell of ``BENCHMARK.json`` cut to test size."""
    return _cut(name)[0]


def small_run(name: str, seed: int = SEED, seconds: float | None = None, trace: bool = False) -> harness.Run:
    """A tiny run of ``name`` in this process."""
    cell, test_seconds = _cut(name)
    seconds = test_seconds if seconds is None else seconds
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"))


def run_small(name: str, fault: str | None = None, trace: bool = False, control: bool = False,
              seed: int = SEED, bench: dict | None = None) -> dict:
    """A tiny run of the cell ``name`` of ``bench`` (by default
    ``BENCHMARK.json``) with ``fault`` planted, as the benchmark's command
    runs it: in this process, or one gloo process a card. Returns rank 0's
    report: ``line`` (the result object), ``run`` (the run without the
    check's inputs) and, with ``control``, ``control`` (the
    ``control_line``, the control held to the cell's limits)."""
    cell, seconds = _cut(name, bench)
    runner = harness.load_runner(cell)
    if cell.chips > 1:
        (report,) = ranks.launch(cell, [seed], seconds, trace, time.time(), fault=fault, control=control,
                                 device="cpu", timeout=600.0)
        return report
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"))
    with faults.planted(fault, runner):
        runner.main(run)
    report = {"line": harness.result(run), "run": run}
    if control:
        report["control"] = harness.control_line(run, runner, fault)
    return report
