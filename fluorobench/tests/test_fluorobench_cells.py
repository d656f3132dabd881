"""Each cell of ``BENCHMARK.json`` end to end on the CPU at a tiny size, as
its runner cuts it, through the runner its traffic names (a cell of
several cards in one gloo process a card): sound runs come out correct;
the control (the reference at TF32 precision in the program's place) and
each fault the runner declares for the cell come out not correct."""

import json

import pytest

from fluorobench import harness
from fluorobench.tests.small import ROOT, run_small, small_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def faults_of(name: str) -> list[str]:
    cell = small_cell(name)
    return harness.load_runner(cell).faults(cell)


FAULTS = [(name, fault) for name in CELLS for fault in faults_of(name)]


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    """A traced sound run of the cell, with the control held to its limits."""
    return run_small(request.param, trace=True, control=True)


def test_sound_run_is_correct_and_reports_its_metrics(sound):
    run, out = sound["run"], sound["line"]
    assert run.correct, run.checks
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(run.cell.limits)
    assert out["attempted"] > 0 and out["failed"] == 0 and out["correct"] is True
    assert out["device"]["count"] == run.cell.chips
    assert {m["name"] for m in run.cell.per_layer} >= set(out["metrics"])
    json.dumps(out)
    run.trace = False
    assert set(harness.result(run)["metrics"]) == {m["name"] for m in run.cell.end_to_end}


def test_control_fails(sound):
    line = sound["control"]
    assert line["correct"] is True, line["program"]
    assert line["control_correct"] is False, line["control"]


def test_the_pairs_of_the_parent_stay():
    assert {("train-8x", "unchanged"), ("train-8x", "half_batch"), ("latency-8x", "altered"),
            ("fullres-2x", "altered")} <= set(FAULTS)


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_faults_are_not_correct(name, fault):
    assert run_small(name, fault)["line"]["correct"] is False
