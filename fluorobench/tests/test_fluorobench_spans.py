"""The readers of the program's spans and counters.

Every per-layer metric of ``BENCHMARK.json`` whose source is a program span
or counter and whose reader reads the program's recording (through
``program_spans.py``) has a case, ``cases/<metric>.py``: a hand-made
recording (``recording()``), the runner's own readings it needs
(``VALUES``, optional) and the value expected from them (``WANT``). A
reader without a case fails, and so does a case without a reader. Each
reader returns its case's value, None from an empty recorder and from a
program without the recorder, and reads a number in a traced run of each
of its one-card cells on the CPU (within ``TRACED``, where a case gives
it)."""

import importlib.util
import json

import pytest

from deepfluoro_tpu_torch.utils import profiling
from fluorobench import harness
from fluorobench.tests.small import ROOT, small_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CASES = {p.name[: -len(".py")]: p for p in sorted((ROOT / "fluorobench" / "tests" / "cases").glob("*.py"))}
PROGRAM = {m["name"]: m for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")}
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


def reads_the_recording(metric: str) -> bool:
    """Whether the reader of ``metric`` reads the program's spans and
    counters, which it reaches through ``program_spans.py``."""
    return "program_spans" in (ROOT / "fluorobench" / "metrics" / "{}.py".format(metric)).read_text()


def load_case(name: str):
    spec = importlib.util.spec_from_file_location("fluorobench_case_{}".format(name.replace(".", "_")), CASES[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name):
    run = small_run(PROGRAM[name]["workloads"][0], trace=True)
    run.values.update(getattr(load_case(name), "VALUES", {}))
    return run


def test_every_new_reader_has_an_expected_value():
    new = {n for n in PROGRAM if reads_the_recording(n)}
    assert new == set(CASES), {"readers without a case": sorted(new - set(CASES)),
                               "cases without a reader": sorted(set(CASES) - new)}
    assert all(hasattr(load_case(n), "WANT") for n in CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_a_handmade_recording(name, monkeypatch):
    case = load_case(name)
    monkeypatch.setattr(profiling, "recorded", case.recording)
    assert harness.load_reader(name)(_run(name)) == pytest.approx(case.WANT)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_returns_none_from_an_empty_recorder(name):
    profiling.reset()
    assert harness.load_reader(name)(_run(name)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_returns_none_from_a_program_without_the_recorder(name, monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert harness.load_reader(name)(_run(name)) is None


@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_traced_cpu_run_reads_each_new_metric_of_its_cell(cell):
    profiling.reset()
    run = small_run(cell, trace=True)
    harness.load_runner(run.cell).main(run)
    got = harness.result(run)["metrics"]
    profiling.reset()
    mine = {n for n in CASES if cell in PROGRAM[n]["workloads"]}
    assert mine <= set(got), sorted(mine - set(got))
    assert all(got[n]["value"] > 0 for n in mine), {n: got[n] for n in mine}
    for n in mine:
        lo, hi = getattr(load_case(n), "TRACED", (0.0, float("inf")))
        assert lo < got[n]["value"] < hi, (n, got[n])
