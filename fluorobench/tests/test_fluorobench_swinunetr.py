"""The Swin UNETR configuration's pieces: its operation counts against
``torch.utils.flop_counter`` on the program's net, the window attention's
bound, the benchmark's reference against the tests' copy in float64, the
runner's seeded weights, the new readers, and the cell this
configuration came with and ``train-2x``, run at their test size."""

import importlib.util
import json
import tempfile

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deepfluoro_tpu_torch.utils import profiling
from fluorobench import counts_swinunetr, harness
from fluorobench.reference import swinunetr as ref
from fluorobench.reference.unet import Numerics
from fluorobench.runners import swinunetr as runner
from fluorobench.runners.train import model_shapes, train_config
from fluorobench.tests.small import ROOT, run_small, small_cell

CFG = json.loads((ROOT / "fluorobench/configs/swinunetr-fs48-2x.json").read_text())
SMALL = small_cell("fullres-2x-swinunetr").config


def program_flops(cfg: dict, size: int) -> int:
    """``torch.utils.flop_counter``'s count of one forward of the
    program's net for ``cfg`` on a ``size``^2 frame (meta tensors)."""
    from deepfluoro_tpu_torch.train.config import build_model

    with torch.device("meta"):
        model = build_model(train_config(dict(cfg, proj_unet_dim=size), 0)).eval()
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(torch.empty(1, 1, size, size))
    return counter.get_total_flops()


@pytest.mark.parametrize("cfg,size", [(CFG, 736), (CFG, 224), (SMALL, 64), (dict(SMALL, num_lands=0), 96)])
def test_forward_flops_match_the_flop_counter(cfg, size):
    assert counts_swinunetr.swinunetr_forward_flops(cfg, size) == program_flops(cfg, size)


def test_the_published_net_at_736_and_its_parts():
    assert counts_swinunetr.swinunetr_forward_flops(CFG, 736) == 293_785_185_408
    assert counts_swinunetr.swin_flops(CFG, 736) == (66_653_048_832, 5_018_358_912)
    assert counts_swinunetr.conv_side_flops(CFG, 736) == 222_113_777_664
    assert [(s["side"], s["window"], s["windows"], s["shifted"]) for s in counts_swinunetr.stages(CFG, 736)] == [
        (368, 7, 53 * 53, True), (184, 7, 27 * 27, True), (92, 7, 14 * 14, True), (46, 7, 7 * 7, True)]
    assert [(s["side"], s["window"], s["shifted"]) for s in counts_swinunetr.stages(SMALL, 64)][-1] == (4, 4, False)
    with pytest.raises(ValueError, match="divide"):
        counts_swinunetr.swinunetr_forward_flops(CFG, 720)


def test_window_attention_bound_of_a_batch_of_four():
    # bound by its bytes in every block: 1.676 GB at 3.35 TB/s
    assert counts_swinunetr.window_attention_bytes(CFG, 4, 736) == 1_675_844_100
    assert counts_swinunetr.window_attention_bound_s(CFG, 4, 736) * 1e6 == pytest.approx(500.25, abs=0.01)


def _tests_copy():
    path = ROOT / "tests" / "swinunetr_reference.py"
    spec = importlib.util.spec_from_file_location("swinunetr_reference_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [64, 96])
def test_the_two_reference_copies_agree_in_float64(size):
    shapes, _ = model_shapes(train_config(SMALL, 0))
    state = runner.make_state(shapes, 2**31 + 3, "cpu", SMALL["window_size"])
    gen = torch.Generator().manual_seed(5)
    for k in state:
        if ".norm" in k:
            state[k] = state[k] + 0.5 * torch.rand(state[k].shape, generator=gen)
    p = {k: v.double() if v.is_floating_point() else v for k, v in state.items()}
    x = torch.randn(2, 1, size, size, dtype=torch.float64, generator=gen)
    a = ref.forward(p, x, SMALL, Numerics(torch.float64))
    b = _tests_copy().forward(p, x, SMALL)
    for u, v in zip(a, b):
        assert (u - v).abs().max() <= 1e-12 * v.abs().max()


def test_seeded_weights():
    shapes, _ = model_shapes(train_config(SMALL, 0))
    a = runner.make_state(shapes, 2**31 + 11, "cpu", 7)
    b = runner.make_state(shapes, 2**31 + 11, "cpu", 7)
    assert set(a) == set(shapes) and all(torch.equal(a[k], b[k]) for k in a)
    key = "swinViT.layers2.0.blocks.1."
    assert torch.equal(a[key + "norm2.weight"], torch.ones(24)) and torch.equal(a[key + "norm1.bias"], torch.zeros(24))
    assert torch.equal(a["swinViT.layers3.0.downsample.norm.weight"], torch.ones(4 * 48))
    table = a[key + "attn.relative_position_bias_table"]
    assert table.shape == (169, 6) and 0 < table.abs().max() <= runner.BIAS_TABLE_SCALE
    assert torch.equal(a[key + "attn.relative_position_index"], ref.relative_position_index(7))
    w = a[key + "attn.qkv.weight"]
    assert 0 < w.abs().max() <= 24**-0.5


def _summary(kernels: dict) -> harness.TraceSummary:
    return harness.TraceSummary(20.0, 19.0, kernels, {k: 1 for k in kernels}, [], [])


def test_window_attention_roofline_reads_the_attention_kernels_and_the_counter(monkeypatch):
    read = harness.load_reader("window_attention_roofline.swinunetr")
    run = harness.Run(cell=small_cell("fullres-2x-swinunetr"), seed=1, seconds=1, trace=True,
                      device=torch.device("cpu"))
    run.values["window_attention_bound_s"] = 5e-4
    run.trace_summary = _summary({"fmha_cutlassF_f32_aligned_64x64_rf_sm80(Params)": 0.8, "sm90_xmma_gemm_f32": 9.0})
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {"window_attention_calls": 800}))
    assert read(run) == pytest.approx(100.0 * 5e-4 * 100 / 0.8)
    run.trace_summary = _summary({"sm90_xmma_gemm_f32": 9.0})
    assert read(run) is None
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {}))
    run.trace_summary = _summary({"fmha_cutlassF_f32": 0.5})
    assert read(run) is None


def test_mfu_counts_the_swinunetr_forward():
    run = harness.Run(cell=small_cell("fullres-2x-swinunetr"), seed=1, seconds=1, trace=True,
                      device=torch.device("cpu"))
    run.window_s = 20.0
    run.values.update(frames=400, flops_per_frame=counts_swinunetr.swinunetr_forward_flops(CFG, 736))
    assert harness.load_reader("mfu.swinunetr")(run) == pytest.approx(100.0 * 293_785_185_408 * 20 / 67e12)


def test_the_swin_cell_records_eight_window_attentions_a_forward():
    profiling.reset()
    out = run_small("fullres-2x-swinunetr", trace=True)
    run = out["run"]
    spans, counters = profiling.recorded()
    forwards = [s for s in spans if s.name == "swinunetr.swin"]
    assert forwards and counters["window_attention_calls"] == 8 * len(forwards)
    assert len([s for s in spans if s.name == "swinunetr.decoder"]) == len(forwards)
    assert all(s.parent is not None and s.parent.name == "fullres.forward" for s in forwards)
    metrics = out["line"]["metrics"]
    assert {"mfu.swinunetr", "swin_dispatch_ms.swinunetr", "batch_ms.infer"} <= set(metrics)
    assert run.correct and run.values["window_attention_bound_s"] > 0
    profiling.reset()


TRAIN_2X = {"name": "train-2x", "config": "deepfluoro-2x", "traffic": "fold-2x", "chips": 1,
            "why": "fit on one fold of a 366-frame archive at the 2x rung: batch 5 of 718^2 padded to 736, float32, "
                   "augmentation on (one warp launch a step), validation and checkpoints at epoch ends"}


def train_2x_bench() -> dict:
    """``BENCHMARK.json`` with ``train-2x`` appended to its cells and to the
    lists of ``train-8x``'s metrics. The cell brings its files
    (``traffic/fold-2x.json``, ``workloads/train-2x.json``) but is not in
    ``BENCHMARK.json``: its runs on the H100 spread too widely (PERF.md
    section 2)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(TRAIN_2X)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train-8x" in m.get("workloads", []):
            m["workloads"].append(TRAIN_2X["name"])
    return bench


def test_the_train_2x_cell_runs_at_its_test_size(tmp_path, monkeypatch):
    # the runner's work directory is named after the cell under the temporary
    # directory: one of this test's own, apart from the cells' tests
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bench = train_2x_bench()
    assert {m["name"] for m in harness.load_cell(ROOT, "train-2x", bench).per_layer} == {
        m["name"] for m in harness.load_cell(ROOT, "train-8x").per_layer}
    out = run_small("train-2x", bench=bench)
    assert out["run"].correct, out["run"].checks
    cfg = out["run"].cell.config
    assert (cfg["frame"], cfg["proj_unet_dim"], cfg["ds_factor"]) == (32, 36, 2)
    assert out["line"]["metrics"]["train_frames_per_s"]["value"] > 0
