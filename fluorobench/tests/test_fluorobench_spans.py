"""The readers of the program's spans and counters: each returns its value
from a recorder that holds a handmade set of spans and counters, None from
an empty one and from a program without the recorder, and each reads a
number in a traced run of its cell on the CPU."""

import json

import pytest

from deepfluoro_tpu_torch.utils import profiling
from fluorobench import harness
from fluorobench.runners import fullres, train
from fluorobench.tests.small import ROOT, small_run

MS = 1_000_000
NEW = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
       if m["source"] in ("program_span", "program_counter") and m["name"] not in
       ("step_ms.train", "epoch_overhead_ms.train", "batch_ms.infer")}


def _span(name, id, t0_ms, t1_ms, parent=None):
    return profiling.Span(name, id, parent, int(t0_ms * MS), int(t1_ms * MS))


def _handmade():
    """Two epochs of three steps, then two batches of the full-res path and
    two landmark decodes, with round durations."""
    spans = []
    for e in range(2):
        epoch = _span("fit.epoch", e, 100 * e, 100 * e + 90)
        for k in range(3):
            step = 3 * e + k
            spans += [_span("fit.step", step, 100 * e + 10 * k, 100 * e + 10 * k + 4 + step, epoch),
                      _span("fit.loss_readback", step, 100 * e + 10 * k + 5, 100 * e + 10 * k + 6 + e, epoch)]
        spans += [_span("fit.validation", e, 100 * e + 40, 100 * e + 60 + 10 * e, epoch),
                  _span("fit.checkpoint", e + 1, 100 * e + 70, 100 * e + 73, epoch), epoch]
    spans.append(_span("fit.checkpoint_wait", None, 200, 206))
    for b, i0 in enumerate((0, 4)):
        t = 300 + 100 * b
        batch = _span("fullres.batch", i0, t, t + 90)
        spans += [_span("fullres.copy_up", i0, t, t + 1 + b, batch),
                  _span("fullres.forward", i0, t + 2, t + 32 + 2 * b, batch),
                  _span("fullres.sync", i0, t + 40, t + 45 + 4 * b, batch),
                  _span("fullres.readback", i0, t + 50, t + 52 + 2 * b, batch), batch,
                  _span("landmarks.detect", None, t + 91, t + 93 + b)]
    return spans, {"host_syncs": 8}


WANT = {
    "step_dispatch_ms.train": 6.5,  # steps of 4..9 ms
    "loss_wait_ms.train": 1.5,  # 1, 1, 1, 2, 2, 2
    "validation_ms.train": 25.0,  # 20 and 30
    "checkpoint_ms.train": 6.0,  # (3 + 3 + 6) / 2 epochs
    "syncs_per_step.train": 8 / 6,
    "dispatch_ms.latency": 31.0,  # 30 and 32
    "device_wait_ms.latency": 7.0,  # 5 and 9
    "copy_ms.latency": 4.5,  # 1 + 2 and 2 + 4
    "landmark_decode_ms.latency": 2.5,  # 2 and 3
    "readback_ms.infer": 3.0,  # 2 and 4
    "device_wait_ms.infer": 7.0,
}


def _run(name):
    run = small_run(NEW[name]["workloads"][0], trace=True)
    run.values["epochs"] = 2
    return run


def test_every_new_reader_has_an_expected_value():
    assert set(WANT) == set(NEW) and len(NEW) == 11


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_a_handmade_recording(name, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", _handmade)
    assert harness.load_reader(name)(_run(name)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_returns_none_from_an_empty_recorder(name):
    profiling.reset()
    assert harness.load_reader(name)(_run(name)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_returns_none_from_a_program_without_the_recorder(name, monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert harness.load_reader(name)(_run(name)) is None


@pytest.mark.parametrize("cell", ["train-8x", "latency-8x", "fullres-2x"])
def test_a_traced_cpu_run_reads_each_new_metric_of_its_cell(cell):
    profiling.reset()
    run = small_run(cell, trace=True)
    {"train": train, "fullres": fullres}[run.traffic["runner"]].main(run)
    got = harness.result(run)["metrics"]
    profiling.reset()
    mine = {n for n, m in NEW.items() if cell in m["workloads"]}
    assert mine and mine <= set(got), sorted(mine - set(got))
    assert all(got[n]["value"] > 0 for n in mine), {n: got[n] for n in mine}
    if cell == "train-8x":
        # the window's first step began before the trace: one loss read
        # more than recorded steps, and one validation read an epoch
        assert 1.0 < got["syncs_per_step.train"]["value"] < 1.5
