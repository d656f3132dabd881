"""The TransUNet configuration's pieces: its operation counts against
``torch.utils.flop_counter`` on the program's net, the attention bound,
the benchmark's reference against the tests' copy in float64, the
runner's seeded weights, and the attention roofline's reader."""

import importlib.util
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deepfluoro_tpu_torch.utils import profiling
from fluorobench import counts_transunet, harness
from fluorobench.reference import transunet as ref
from fluorobench.reference.unet import Numerics
from fluorobench.runners import transunet as runner
from fluorobench.runners.train import model_shapes, train_config
from fluorobench.tests.small import ROOT, small_cell

CFG = json.loads((ROOT / "fluorobench/configs/transunet-r50-b16-2x.json").read_text())
SMALL = small_cell("fullres-2x-transunet").config


def program_flops(cfg: dict, size: int) -> int:
    """``torch.utils.flop_counter``'s count of one forward of the
    program's net for ``cfg`` on a ``size``^2 frame (meta tensors)."""
    from deepfluoro_tpu_torch.train.config import build_model

    with torch.device("meta"):
        model = build_model(train_config(dict(cfg, proj_unet_dim=size), 0)).eval()
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(torch.empty(1, 1, size, size))
    return counter.get_total_flops()


@pytest.mark.parametrize("cfg,size", [(CFG, 736), (CFG, 224), (SMALL, 48), (dict(SMALL, num_lands=0), 64)])
def test_forward_flops_match_the_flop_counter(cfg, size):
    assert counts_transunet.transunet_forward_flops(cfg, size) == program_flops(cfg, size)


def test_the_published_net_at_736_and_its_parts():
    assert counts_transunet.transunet_forward_flops(CFG, 736) == 781_743_704_064
    linear, attention = counts_transunet.block_flops(CFG, 46 * 46)
    assert 12 * attention == 165_056_937_984 and 12 * (linear + attention) == 524_500_402_176
    assert counts_transunet.resnet_flops(CFG, 736) == (84_740_210_688, 46)
    with pytest.raises(ValueError, match="grid"):
        counts_transunet.transunet_forward_flops(CFG, 740)


def test_attention_bound_of_a_batch_of_four():
    assert counts_transunet.attention_bound_s(CFG, 4, 2116) * 1e6 == pytest.approx(111.2, abs=0.05)
    # a short sequence is bound by its bytes
    assert counts_transunet.attention_bound_s(CFG, 4, 16) == pytest.approx(
        counts_transunet.attention_bytes(CFG, 4, 16) / 3.35e12)


def test_the_two_reference_copies_agree_in_float64():
    path = ROOT / "tests" / "transunet_reference.py"
    spec = importlib.util.spec_from_file_location("transunet_reference_tests", path)
    tests_copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests_copy)
    shapes, _ = model_shapes(train_config(SMALL, 0))
    state = runner.make_state(shapes, 2**31 + 3, "cpu")
    gen = torch.Generator().manual_seed(5)
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            state[k] = state[k] + 0.5 * torch.rand(state[k].shape, generator=gen)
    p = {k: v.double() if v.is_floating_point() else v for k, v in state.items()}
    x = torch.randn(2, 1, 48, 48, dtype=torch.float64, generator=gen)
    for train in (False, True):
        a = ref.forward(p, x, SMALL, Numerics(torch.float64), train=train)
        b = tests_copy.forward(p, x, SMALL, train=train)
        for u, v in zip(a, b):
            assert (u - v).abs().max() <= 1e-12 * v.abs().max()


def test_seeded_weights_and_calibration():
    shapes, _ = model_shapes(train_config(SMALL, 0))
    a = runner.make_state(shapes, 2**31 + 11, "cpu")
    b = runner.make_state(shapes, 2**31 + 11, "cpu")
    assert set(a) == set(shapes) and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["transformer.encoder.layer.0.ffn_norm.weight"], torch.ones(32))
    assert torch.equal(a["transformer.embeddings.hybrid_model.root.gn.bias"], torch.zeros(8))
    pos = a["transformer.embeddings.position_embeddings"]
    assert pos.shape == (1, 9, 32) and 0 < pos.abs().max() <= runner.POSITION_SCALE
    w = a["transformer.encoder.layer.1.attn.value.weight"]
    assert 0 < w.abs().max() <= 32**-0.5
    x = torch.randn(3, 1, 48, 48, generator=torch.Generator().manual_seed(6))
    cal = runner.calibrate(a, x, SMALL)
    stats = {}
    ref.forward(a, x, SMALL, Numerics(torch.float32), train=True, stats=stats)
    assert set(stats) == {k[: -len(".running_mean")] for k in shapes if k.endswith(".running_mean")}
    for key, (mean, var) in stats.items():
        assert torch.equal(cal[key + ".running_mean"], mean) and torch.equal(cal[key + ".running_var"], var)


def _summary(kernels: dict) -> harness.TraceSummary:
    return harness.TraceSummary(20.0, 19.0, kernels, {k: 1 for k in kernels}, [], [])


def test_attention_roofline_reads_the_attention_kernels_and_the_counter(monkeypatch):
    read = harness.load_reader("attention_roofline.transunet")
    run = harness.Run(cell=small_cell("fullres-2x-transunet"), seed=1, seconds=1, trace=True,
                      device=torch.device("cpu"))
    run.values["attention_bound_s"] = 1e-4
    run.trace_summary = _summary({"fmha_cutlassF_f32_aligned_64x64_rf_sm80(Params)": 0.5, "sm80_xmma_gemm_f32": 9.0})
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {"attention_calls": 1200}))
    assert read(run) == pytest.approx(100.0 * 1e-4 * 1200 / 0.5)
    run.trace_summary = _summary({"sm80_xmma_gemm_f32": 9.0})
    assert read(run) is None
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {}))
    run.trace_summary = _summary({"fmha_cutlassF_f32": 0.5})
    assert read(run) is None


def test_mfu_counts_the_transunet_forward():
    run = harness.Run(cell=small_cell("fullres-2x-transunet"), seed=1, seconds=1, trace=True,
                      device=torch.device("cpu"))
    run.window_s = 20.0
    run.values.update(frames=400, flops_per_frame=counts_transunet.transunet_forward_flops(CFG, 736))
    assert harness.load_reader("mfu.transunet")(run) == pytest.approx(100.0 * 781_743_704_064 * 20 / 67e12)
