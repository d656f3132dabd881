"""The command's refusals and the import check."""

import json
import subprocess
import sys

import pytest

from fluorobench import harness
from fluorobench.tests.small import ROOT


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "fluorobench/run.py", "--workload", "latency-8x", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell(ROOT, "no-such-cell")


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    for name in ("deepfluoro_tpu_torch", "deepfluoro_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "deepfluoro_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.loaded_forbidden() == ["deepfluoro_tpu.models", "jax"]


def test_reference_and_harness_import_neither_jax_nor_the_program():
    code = ("import sys, json; sys.path.insert(0, {!r});"
            "import fluorobench.reference.unet, fluorobench.reference.train, fluorobench.reference.infer;"
            "import fluorobench.counts, fluorobench.weights, fluorobench.traffic.specimens, "
            "fluorobench.traffic.fullres_frames;"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deepfluoro_tpu', 'deepfluoro_tpu_torch'))))").format(str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, {!r});"
            "from fluorobench.tests.small import small_run; from fluorobench import harness;"
            "from fluorobench.runners import fullres; run = small_run('fullres-2x'); fullres.main(run);"
            "print(harness.loaded_forbidden(), run.correct)").format(str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "fluorobench/run.py", "--workload", "latency-8x", "--seed", "2147483659",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
