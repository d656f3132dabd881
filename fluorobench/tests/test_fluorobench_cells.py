"""Each cell end to end on the CPU at a tiny size: sound runs come out
correct; the control (the reference at TF32 precision in the program's
place) and each planted fault come out not correct."""

import contextlib
import dataclasses
import json

import pytest

from fluorobench import faults, harness
from fluorobench.runners import fullres, train
from fluorobench.tests.small import small_run

RUNNERS = {"train": train, "fullres": fullres}
CELLS = ["train-8x", "latency-8x", "fullres-2x"]


def run_cell(name, fault=None, trace=False):
    run = small_run(name, trace=trace)
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        RUNNERS[run.traffic["runner"]].main(run)
    return run


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(name):
    run = run_cell(name, trace=True)
    assert run.correct, run.checks
    out = harness.result(run)
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(run.cell.limits)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {m["name"] for m in run.cell.per_layer} >= set(out["metrics"])
    json.dumps(out)
    run.trace = False
    assert set(harness.result(run)["metrics"]) == {m["name"] for m in run.cell.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    run = run_cell(name)
    assert run.correct, run.checks
    mod = RUNNERS[run.traffic["runner"]]
    control = dataclasses.replace(run, checks=[], values=dict(run.values))
    mod.check(control, mod.CONTROL)
    assert not control.correct, control.checks
    line = harness.control_line(run, mod, None)
    assert line["correct"] is True and line["control_correct"] is False


@pytest.mark.parametrize("name,fault", [("train-8x", "unchanged"), ("train-8x", "half_batch"),
                                        ("latency-8x", "altered"), ("fullres-2x", "altered")])
def test_planted_faults_are_not_correct(name, fault):
    assert not run_cell(name, fault).correct

