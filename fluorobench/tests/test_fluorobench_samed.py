"""The SAMed configuration's pieces: its operation counts against
``torch.utils.flop_counter`` on the program's net, the encoder
attention's bound, the runner's seeded weights, the new readers, and the
cell this configuration came with, run at its test size: correct, with
the control and the ``altered`` fault not correct, and every new metric
read."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deepfluoro_tpu_torch.utils import profiling
from fluorobench import counts_samed, harness
from fluorobench.runners import samed as runner
from fluorobench.runners.train import model_shapes, train_config
from fluorobench.tests.small import ROOT, run_small, small_cell

CELL = "fullres-2x-samed"
CFG = json.loads((ROOT / "fluorobench/configs/samed-vitb-2x.json").read_text())
SMALL = small_cell(CELL).config
NEW = ("rel_pos_attention_roofline.samed", "encoder_dispatch_ms.samed", "decoder_dispatch_ms.samed")


def program_flops(cfg: dict, size: int) -> int:
    """``torch.utils.flop_counter``'s count of one forward of the
    program's net for ``cfg`` on a ``size``^2 frame (meta tensors)."""
    from deepfluoro_tpu_torch.train.config import build_model

    with torch.device("meta"):
        model = build_model(train_config(dict(cfg, proj_unet_dim=size), 0)).eval()
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(torch.empty(1, 1, size, size))
    return counter.get_total_flops()


@pytest.mark.parametrize("cfg,size", [(CFG, 736), (CFG, 224), (SMALL, 80), (dict(SMALL, num_lands=0), 96)])
def test_forward_flops_match_the_flop_counter(cfg, size):
    assert counts_samed.samed_forward_flops(cfg, size) == program_flops(cfg, size)


def test_the_published_net_at_736_and_its_parts():
    assert counts_samed.samed_forward_flops(CFG, 736) == 478_982_859_904
    assert counts_samed.encoder_flops(CFG, 736) == (404_596_064_256, 72_399_814_656)
    assert counts_samed.decoder_flops(CFG, 736) == 1_986_980_992
    blocks = counts_samed.blocks(CFG, 736)
    assert [(b["side"], b["windows"], b["n"]) for b in blocks[1:3]] == [(14, 16, 196), (46, 1, 2116)]
    assert sum(b["n"] == 2116 for b in blocks) == 4
    assert counts_samed.blocks(SMALL, 80)[0] == dict(side=4, windows=4, n=16)
    with pytest.raises(ValueError, match="divide"):
        counts_samed.samed_forward_flops(CFG, 728)


def test_rel_pos_attention_bound_of_a_batch_of_four():
    # a global block is bound by its 56.2 GFLOP (113.6 us), a windowed one
    # by its 171 MB (51.0 us): 4 x 113.6 + 8 x 51.0 us a forward
    blocks = counts_samed.blocks(CFG, 736)
    flops = [4 * counts_samed._attention_flops(CFG, b) for b in blocks]
    assert flops[2] == 56_215_044_096 and flops[0] == 8_092_385_280
    assert [counts_samed._block_bytes(CFG, 4, b) for b in blocks[1:3]] == [170_999_808, 141_382_656]
    assert counts_samed.rel_pos_attention_bytes(CFG, 4, 736) == 1_933_529_088
    assert counts_samed.rel_pos_attention_bound_s(CFG, 4, 736) * 1e6 == pytest.approx(862.90, abs=0.01)


def test_seeded_weights():
    shapes, _ = model_shapes(train_config(SMALL, 0))
    a = runner.make_state(shapes, 2**31 + 11, "cpu")
    b = runner.make_state(shapes, 2**31 + 11, "cpu")
    assert set(a) == set(shapes) and all(torch.equal(a[k], b[k]) for k in a)
    block = "image_encoder.blocks.1."
    assert torch.equal(a[block + "norm2.weight"], torch.ones(48))
    assert torch.equal(a[block + "norm1.bias"], torch.zeros(48))
    assert torch.equal(a["mask_decoder.output_upscaling.1.weight"], torch.ones(8))
    assert torch.equal(a["mask_decoder.transformer.norm_final_attn.bias"], torch.zeros(32))
    table = a[block + "attn.rel_pos_h"]
    assert table.shape == (9, 12) and 0 < table.abs().max() <= runner.REL_POS_SCALE
    assert 0 < a["image_encoder.pos_embed"].abs().max() <= runner.POS_EMBED_SCALE
    for k in ("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", "prompt_encoder.no_mask_embed.weight",
              "mask_decoder.mask_tokens.weight", "mask_decoder.iou_token.weight"):
        assert a[k].abs().max() > 1.0, k  # standard normal, not +-1/sqrt(fan_in)
    lora = a[block + "attn.qkv.linear_b_q.weight"]
    assert lora.shape == (48, 4) and 0 < lora.abs().max() <= 0.5
    assert 0 < a[block + "attn.qkv.qkv.weight"].abs().max() <= 48**-0.5


def test_rel_pos_attention_roofline_reads_the_spans_device_time_and_the_counter(monkeypatch):
    read = harness.load_reader("rel_pos_attention_roofline.samed")
    run = harness.Run(cell=small_cell(CELL), seed=1, seconds=1, trace=True, device=torch.device("cpu"))
    run.values["rel_pos_attention_bound_s"] = 8e-4
    run.trace_summary = harness.TraceSummary(20.0, 19.0, {"sm90_xmma_gemm_f32": 9.0}, {"sm90_xmma_gemm_f32": 1}, [], [])
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {"rel_pos_attention_calls": 400}))
    monkeypatch.setattr(profiling, "device_seconds", lambda: {"samed.rel_pos_attention": 1.25, "other": 3.0})
    # 400 calls of a depth-4 cut: 100 forwards, whatever the kernels' names
    assert read(run) == pytest.approx(100.0 * 8e-4 * 100 / 1.25)
    monkeypatch.setattr(profiling, "device_seconds", lambda: {"samed.rel_pos_attention": 0.0})
    assert read(run) is None
    monkeypatch.setattr(profiling, "device_seconds", lambda: {"samed.rel_pos_attention": 1.25})
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {}))
    assert read(run) is None
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {"rel_pos_attention_calls": 400}))
    monkeypatch.delattr(profiling, "device_seconds")
    assert read(run) is None


def test_mfu_infer_counts_the_samed_forward():
    run = harness.Run(cell=small_cell(CELL), seed=1, seconds=1, trace=True, device=torch.device("cpu"))
    run.window_s = 20.0
    run.values.update(frames=1000, flops_per_frame=counts_samed.samed_forward_flops(CFG, 736))
    assert harness.load_reader("mfu.infer")(run) == pytest.approx(100.0 * 478_982_859_904 * 50 / 67e12)


def test_the_cell_is_correct_and_records_its_spans_and_one_attention_call_a_block():
    profiling.reset()
    out = run_small(CELL, trace=True, control=True)
    run = out["run"]
    spans, counters = profiling.recorded()
    encoders = [s for s in spans if s.name == "samed.encoder"]
    assert encoders and counters["rel_pos_attention_calls"] == SMALL["num_layers"] * len(encoders)
    assert len([s for s in spans if s.name == "samed.decoder"]) == len(encoders)
    assert all(s.parent is not None and s.parent.name == "fullres.forward" for s in encoders)
    assert run.correct and out["line"]["correct"] and run.values["rel_pos_attention_bound_s"] > 0
    assert out["control"]["control_correct"] is False
    metrics = out["line"]["metrics"]
    # no device trace on the CPU: the roofline share has no kernel time to read
    assert set(NEW) - {"rel_pos_attention_roofline.samed"} <= set(metrics)
    assert {"mfu.infer", "batch_ms.infer", "readback_ms.infer", "device_wait_ms.infer"} <= set(metrics)
    assert {m["name"] for m in run.cell.per_layer} >= set(NEW) | {"mfu.infer", "device_idle_pct.infer"}
    profiling.reset()


def test_the_altered_fault_is_not_correct():
    assert run_small(CELL, "altered")["line"]["correct"] is False


def test_a_program_without_samed_stops_at_once(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "deepfluoro_tpu_torch.models.samed", None)
    run = harness.Run(cell=small_cell(CELL), seed=1, seconds=1, trace=False, device=torch.device("cpu"))
    with pytest.raises(SystemExit, match="cannot build a SAMed"):
        runner.main(run)
