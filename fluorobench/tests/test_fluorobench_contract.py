"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import re

import pytest

from fluorobench import harness
from fluorobench.tests.small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["fluorobench"] and BENCH["command"] == ["python3", "fluorobench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique_and_cells_are_distinct():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[-1], set()).add(m["layer"])
    assert all(len(v) >= 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.config and c.traffic and c.limits
    assert (ROOT / "fluorobench" / "runners" / "{}.py".format(c.traffic["runner"])).is_file()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert config["file"].startswith("fluorobench/") and path.is_file()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"]
    assert config["source"].startswith("https://") and cfg["source"] == config["source"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_per_layer_metrics_name_only_cells_that_report_what_they_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {e["name"] for e in harness.load_cell(ROOT, cell).end_to_end}
