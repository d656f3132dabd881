"""SAMed (SAM ViT-B with LoRA, prompt-free, one mask token per class) on
the port's normal path (``models/samed.py``, ``train/config.py``'s
``arch``, ``load_net_from_checkpoint``, ``fullres_batches``,
``seg_fullres``) against the plain float64 reference
``fluorobench/reference/samed.py``, on the CPU. The JAX package has no
SAMed, so the reference is SAM's and SAMed's equations written out.

Sizes: width 48 in 4 heads of 12, MLP 192, depth 4 with global blocks 1 and 3,
windows of 4, a decoder of width 32 (4 heads, MLP 64), LoRA rank 4, on
160^2 and 96^2 inputs: grids of 10 and 6, which the windowed blocks
zero-pad to 12 and 8, so padded tokens run through ``qkv`` and are
attended to. Weights are seeded, with LayerNorm scales and shifts, the
relative-position tables, ``pos_embed``, the positional-encoding matrix,
the tokens and LoRA's ``linear_b`` drawn too, so that no parameter is at
a value that hides its use. Tolerances: float64 within 1e-10 (the port
and the reference differ only in the order of their sums: the
probabilities read about 1e-16 and the heatmaps 3e-15 of their largest
magnitude); float32 within 1e-5 of the probabilities, which lie in [0,
1], and 1e-5 of the heatmaps' largest magnitude (float32 rounding through
some forty layers at these widths reads 3e-8 to 4e-8 and 8e-7 to 1.1e-6).
A bfloat16 forward misses the float32 tolerance by more than ten times
(8e-4 and 2e-2 read), and the reference with TF32 operands misses it too
(3e-4 and 2e-2)."""

import h5py
import numpy as np
import pytest
import torch

from deepfluoro_tpu_torch.cli import seg_fullres as port_cli
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, make_synthetic_fullres_data
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.infer.batches import may_capture
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.models.samed import SAMed, rel_pos_index, rel_pos_mask, window_partition
from deepfluoro_tpu_torch.models.unet import UNet
from deepfluoro_tpu_torch.parallel.mesh import Mesh
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit
from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint
from deepfluoro_tpu_torch.utils import profiling
from fluorobench.reference import samed as ref
from fluorobench.reference.unet import Numerics

SMALL = dict(arch="samed", num_classes=7, num_lands=14, proj_unet_dim=160, hidden_size=48, num_heads=4, num_layers=4,
             mlp_dim=192,
             sam_global_attn_indexes=(1, 3), sam_window_size=4, sam_prompt_dim=32, sam_decoder_heads=4,
             sam_decoder_mlp_dim=64)
REF_CFG = dict(num_heads=4, sam_window_size=4, sam_global_attn_indexes=[1, 3], sam_decoder_heads=4)
F64 = Numerics(torch.float64)
TOL = 1e-5
TOL64 = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded(cfg: TrainConfig, seed: int = 0) -> SAMed:
    """A SAMed of ``cfg`` with every float parameter and buffer drawn from
    ``seed``: weights uniform in +-1/sqrt(fan_in), LayerNorm scales in
    [0.5, 1.5], the rest (biases, shifts, tables, ``pos_embed``, the PE
    matrix) in +-0.3."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            u = torch.rand(v.shape, generator=gen)
            if k.endswith(".weight") and v.ndim == 1:
                v.copy_(0.5 + u)
            elif k.endswith(".weight"):
                v.copy_((2 * u - 1) / v[0].numel() ** 0.5)
            else:
                v.copy_(0.6 * u - 0.3)
    return model


def as64(model) -> dict:
    return {k: v.double() for k, v in model.state_dict().items()}


def frames(n=2, size=160, seed=1):
    return torch.randn(n, 1, size, size, generator=torch.Generator().manual_seed(seed))


def gaps(got, want):
    """(largest probability difference, largest heatmap difference over
    the heatmaps' largest magnitude)."""
    (seg, heats), (rseg, rheats) = got, want
    assert seg.shape == rseg.shape and heats.shape == rheats.shape
    return float((seg.double() - rseg).abs().max()), float((heats.double() - rheats).abs().max() / rheats.abs().max())


def test_build_model_builds_the_configured_net():
    model = build_model(TrainConfig(**SMALL))
    assert isinstance(model, SAMed)
    keys = set(model.state_dict())
    for k in ("image_encoder.pos_embed", "image_encoder.patch_embed.proj.bias", "image_encoder.blocks.0.norm1.weight",
              "image_encoder.blocks.1.attn.rel_pos_h", "image_encoder.blocks.2.attn.qkv.qkv.bias",
              "image_encoder.blocks.3.attn.qkv.linear_a_q.weight", "image_encoder.blocks.3.attn.qkv.linear_b_v.weight",
              "image_encoder.blocks.0.attn.proj.weight", "image_encoder.blocks.2.mlp.lin2.bias",
              "image_encoder.neck.0.weight", "image_encoder.neck.3.bias",
              "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", "prompt_encoder.no_mask_embed.weight",
              "mask_decoder.transformer.layers.0.self_attn.q_proj.weight",
              "mask_decoder.transformer.layers.1.cross_attn_image_to_token.out_proj.bias",
              "mask_decoder.transformer.layers.1.norm4.weight", "mask_decoder.transformer.layers.0.mlp.lin1.weight",
              "mask_decoder.transformer.final_attn_token_to_image.v_proj.weight",
              "mask_decoder.transformer.norm_final_attn.bias", "mask_decoder.iou_token.weight",
              "mask_decoder.mask_tokens.weight", "mask_decoder.output_upscaling.0.weight",
              "mask_decoder.output_upscaling.1.weight", "mask_decoder.output_upscaling.3.bias",
              "mask_decoder.output_hypernetworks_mlps.6.layers.2.weight", "lands_1x1.1.weight"):
        assert k in keys, k
    assert "image_encoder.neck.0.bias" not in keys and "image_encoder.blocks.0.attn.qkv.linear_a_q.bias" not in keys
    # only what the forward runs: no point embeddings, mask branch or IoU head
    assert not any(k.startswith(("prompt_encoder.point_embeddings", "prompt_encoder.not_a_point_embed",
                                 "prompt_encoder.mask_downscaling", "mask_decoder.iou_prediction_head")) for k in keys)
    enc = model.image_encoder
    assert enc.blocks[0].attn.rel_pos_h.shape == (7, 12) and enc.blocks[1].attn.rel_pos_w.shape == (19, 12)
    assert enc.pos_embed.shape == (1, 10, 10, 48) and model.mask_decoder.mask_tokens.weight.shape == (7, 32)
    assert model.mask_decoder.transformer.layers[0].cross_attn_token_to_image.q_proj.weight.shape == (16, 32)
    assert isinstance(build_model(TrainConfig(num_classes=7)), UNet)
    with pytest.raises(ValueError, match="SAMed runs in float32 without remat"):
        build_model(TrainConfig(**SMALL, remat=True))
    with pytest.raises(ValueError, match="Swin UNETR runs in float32"):
        build_model(TrainConfig(arch="swinunetr", compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="multiple of 16"):
        build_model(TrainConfig(**dict(SMALL, proj_unet_dim=72)))


def test_the_published_net_at_736_has_its_widths():
    with torch.device("meta"):
        model = build_model(TrainConfig(arch="samed", num_classes=7, num_lands=14, proj_unet_dim=736))
    assert sum(p.numel() for p in model.parameters()) == 92_626_585
    enc = model.image_encoder
    assert enc.pos_embed.shape == (1, 46, 46, 768) and len(enc.blocks) == 12
    assert [b.window for b in enc.blocks] == [14, 14, 0, 14, 14, 0, 14, 14, 0, 14, 14, 0]
    assert enc.blocks[2].attn.rel_pos_h.shape == (91, 64) and enc.blocks[0].attn.rel_pos_w.shape == (27, 64)
    assert enc.blocks[0].attn.qkv.linear_a_q.weight.shape == (4, 768)
    assert model.mask_decoder.transformer.layers[1].mlp.lin1.weight.shape == (2048, 256)
    assert model.mask_decoder.output_upscaling[3].weight.shape == (64, 32, 2, 2)


@pytest.mark.parametrize("size", [160, 96])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_the_reference(size, dtype):
    """Padded windows, global blocks and the decoder at both sizes, the
    landmark head included."""
    model = seeded(TrainConfig(**dict(SMALL, proj_unet_dim=size))).eval().to(dtype)
    x = frames(size=size)
    with torch.no_grad():
        got = model(x.to(dtype))
    seg_gap, heat_gap = gaps(got, ref.forward(as64(model), x.double(), REF_CFG, F64))
    tol = TOL64 if dtype == torch.float64 else TOL
    assert seg_gap < tol and heat_gap < tol


def test_without_landmarks_the_forward_returns_the_probabilities():
    model = seeded(TrainConfig(**dict(SMALL, num_lands=0))).eval().double()
    x = frames().double()
    with torch.no_grad():
        seg = model(x)
    want, _ = ref.forward(as64(model), x, REF_CFG, F64)
    assert (seg - want).abs().max() < TOL64 and torch.allclose(seg.sum(dim=1), torch.ones_like(seg[:, 0]))


def test_lower_precision_fails_the_float32_tolerance():
    """A bfloat16 forward, and the reference with TF32 operands, miss the
    float32 tolerance the port meets."""
    model = seeded(TrainConfig(**SMALL)).eval()
    x = frames()
    want = ref.forward(as64(model), x.double(), REF_CFG, F64)
    with torch.no_grad():
        bf16 = model.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert max(gaps(bf16, want)) > 10 * TOL
    low = {k: v.float() for k, v in as64(model).items()}
    tf32 = ref.forward(low, x, REF_CFG, Numerics(torch.float32, tf32=True))
    assert max(gaps(tf32, want)) > TOL


def test_the_relative_position_index_is_sams():
    """``get_rel_pos`` with equal query and key sizes: ``(q - k) + (size -
    1)``, so that row i of the gathered table holds R[i - j + size - 1]."""
    for size in (1, 4, 46):
        idx = rel_pos_index(size)
        assert torch.equal(idx, ref.rel_index(size))
        assert idx.min() == 0 and idx.max() == 2 * size - 2
        assert idx[0, size - 1] == 0 and idx[size - 1, 0] == 2 * size - 2
        assert torch.equal(idx.diagonal(), torch.full((size,), size - 1))


def test_the_mask_is_the_decomposed_relative_positions_of_the_unscaled_q():
    """Each entry of the mask, written out from its definition, and the
    rows padded to a multiple of 8 elements under the (b, heads, n, n)
    view."""
    gen = torch.Generator().manual_seed(2)
    h, w, d = 3, 5, 6
    q = torch.randn(2, 3, h * w, d, dtype=torch.float64, generator=gen)
    rh = torch.randn(2 * h - 1, d, dtype=torch.float64, generator=gen)
    rw = torch.randn(2 * w - 1, d, dtype=torch.float64, generator=gen)
    mask = rel_pos_mask(q, rh, rw, h, w)
    assert mask.shape == (2, 3, 15, 15) and mask.stride(-1) == 1 and mask.stride(-2) == 16
    want = torch.empty(2, 3, 15, 15, dtype=torch.float64)
    for i in range(15):
        for j in range(15):
            (ih, iw), (jh, jw) = divmod(i, w), divmod(j, w)
            want[:, :, i, j] = q[:, :, i] @ rh[ih - jh + h - 1] + q[:, :, i] @ rw[iw - jw + w - 1]
    assert (mask - want).abs().max() < 1e-12
    with pytest.raises(ValueError, match="do not fit"):
        rel_pos_mask(q, rh[:-1], rw, h, w)


def test_padded_keys_are_attended_unmasked():
    """A windowed block on a 5x5 grid pads to two windows a side; a real
    token's attention takes in the padded tokens (their keys and values
    are ``qkv``'s bias with the LoRA of zeros added), as published.
    Masking them out gives another output."""
    model = seeded(TrainConfig(**dict(SMALL, proj_unet_dim=80))).eval().double()
    block = model.image_encoder.blocks[0]
    assert block.window == 4
    x = torch.randn(1, 5, 5, 48, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = block(x)
        y, _ = window_partition(block.norm1(x), 4)
        assert y.shape == (4, 4, 4, 48) and y[3, 0, 0].abs().max() > 0
        assert y[3, 1:].abs().max() == 0 and y[3, :, 1:].abs().max() == 0
        attn = block.attn
        b, n, c, heads = y.shape[0], 16, 48, 4
        q, k, v = attn.qkv(y).reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4).unbind(0)
        assert torch.equal(k[3, 0, 15], attn.qkv.qkv.bias[c : c + 12])
        logits = q @ k.transpose(-1, -2) / (c // heads) ** 0.5 + rel_pos_mask(q, attn.rel_pos_h, attn.rel_pos_w, 4, 4)
        real = torch.zeros(8, 8, dtype=torch.bool)
        real[:5, :5] = True
        real, _ = window_partition(real[None, ..., None].double(), 4)
        masked = logits.masked_fill(real.reshape(4, 1, 1, 16) == 0, -torch.inf)
        out = attn.proj((masked.softmax(-1) @ v).transpose(1, 2).reshape(4, 4, 4, c))
        other = x + torch.cat([torch.cat([out[0], out[1]], 1), torch.cat([out[2], out[3]], 1)], 0)[None, :5, :5]
        other = other + block.mlp(block.norm2(other))
    assert (got - other).abs().max() > 1e-3
    assert (got - ref.encoder_block(F64, as64(model), "image_encoder.blocks.0", x, 4, 4)).abs().max() < TOL64


def test_lora_with_a_nonzero_b_moves_the_output():
    """SAMed's init (``linear_b`` zero) leaves the frozen SAM's output; a
    non-zero ``linear_b_q`` or ``linear_b_v`` moves it, and the reference
    follows."""
    model = seeded(TrainConfig(**SMALL)).eval().double()
    x = frames().double()
    with torch.no_grad():
        moved = model(x)
        for name in ("linear_b_q", "linear_b_v"):
            for block in model.image_encoder.blocks:
                getattr(block.attn.qkv, name).weight.zero_()
        zero = model(x)
    want, _ = ref.forward(as64(model), x, REF_CFG, F64)
    assert (zero[0] - want).abs().max() < TOL64
    assert (moved[0] - zero[0]).abs().max() > 1e-3


def test_checkpoint_meta_round_trips_and_a_meta_without_arch_is_a_unet(tmp_path):
    cfg = TrainConfig(**SMALL)
    meta = cfg.to_checkpoint_meta()
    assert meta["arch"] == "samed" and meta["vit-hidden-size"] == 48 and meta["sam-global-attn-indexes"] == [1, 3]
    assert meta["vit-num-heads"] == 4 and meta["vit-num-layers"] == 4 and meta["vit-mlp-dim"] == 192
    assert meta["sam-window-size"] == 4 and meta["sam-decoder-mlp-dim"] == 64
    assert not any(k.startswith(("resnet-", "swin-", "gn-", "decoder-")) for k in meta)
    back = TrainConfig.from_checkpoint_meta(meta)
    assert back == cfg
    assert TrainConfig.from_checkpoint_meta(TrainConfig(num_classes=7).to_checkpoint_meta(), base=cfg).arch == "unet"
    model = seeded(cfg)
    path = str(tmp_path / "samed.pt")
    save_checkpoint(path, cfg, model, epoch=3)
    loaded, got = load_net_from_checkpoint(path, device="cpu", verbose=False)
    assert isinstance(loaded, SAMed) and not loaded.training and got == back
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _reference_ensemble(models, projs, rots, pad):
    """The float64 reference's prep, forward, center crop, per-image
    min-max heats, member mean and argmax."""
    cfg = dict(REF_CFG, ds_factor=2, proj_unet_dim=pad)
    return ref.ensemble([as64(m) for m in models], torch.from_numpy(projs), torch.from_numpy(rots), cfg, F64)


def _assert_served_like_the_reference(labels, heats, want):
    seg, want_heats, want_labels = want
    assert np.abs(heats - want_heats.numpy()).max() < 1e-5
    top2 = seg.sort(dim=1).values[:, -2:]
    clear = ((top2[:, 1] - top2[:, 0]) > 1e-4).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], want_labels.numpy()[clear])


def test_fullres_batches_serves_samed_members_like_the_reference():
    """Raw 212^2 frames at 2x (56^2 padded to 80: a 5x5 grid, padded
    windows), two members, batch 2 over five frames (the last batch
    padded); a SAMed member is not offered for a CUDA graph and runs
    eager."""
    cfg = TrainConfig(**dict(SMALL, proj_unet_dim=80))
    models = [seeded(cfg, seed=s).eval() for s in (5, 6)]
    assert not may_capture(models) and not may_capture(models[:1])
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=212, seed=7)[0]
    times = []
    batches = list(fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (212, 212), models,
                                   2, 14, times, 2, 80))
    assert [(s, l.shape, h.shape) for s, l, h in batches][-1] == (4, (1, 56, 56), (1, 14, 56, 56))
    assert len(times) == 5
    labels = np.concatenate([l for _, l, _ in batches])
    heats = np.concatenate([h for _, _, h in batches])
    _assert_served_like_the_reference(labels, heats, _reference_ensemble(models, spec["projs"], spec["rots"], 80))


def test_seg_fullres_serves_a_samed_checkpoint(tmp_path):
    archive = write_synthetic_fullres_dataset(str(tmp_path / "full.h5"), num_projs=3, seed=3)
    cfg = TrainConfig(**dict(SMALL, proj_unet_dim=64))
    model = seeded(cfg, seed=8)
    net = str(tmp_path / "samed.pt")
    save_checkpoint(net, cfg, model)
    out = str(tmp_path / "out.h5")
    port_cli.main([archive, out, "--ds-factor", "2", "--nets", net, "--batch-size", "2", "--no-gpu"])
    with h5py.File(archive, "r") as src:
        keys = sorted(src["17-1882"]["projections"].keys())
        projs = np.stack([src["17-1882"]["projections"][k]["image/pixels"][:] for k in keys]).astype(np.float32)
        rots = np.array([bool(np.asarray(src["17-1882"]["projections"][k]["rot-180-for-up"][()])) for k in keys])
    with h5py.File(out, "r") as f:
        labels, heats = f["nn-segs"][:], f["nn-heats"][:]
    assert labels.shape == (3, 24, 24) and heats.shape == (3, 14, 24, 24)
    _assert_served_like_the_reference(labels, heats, _reference_ensemble([model.eval()], projs, rots, 64))


def test_mesh_int8_and_sharded_training_refuse_a_samed(tmp_path):
    model = seeded(TrainConfig(**dict(SMALL, proj_unet_dim=80))).eval()
    projs = np.ones((2, 212, 212), np.float32)
    rots = np.zeros(2, bool)
    read = lambda i0, i1: (projs[i0:i1], rots[i0:i1])  # noqa: E731
    with pytest.raises(ValueError, match="U-Net members only; SAMed runs on one device"):
        next(fullres_batches(read, 2, (212, 212), [model], 2, 14, None, 2, 80, mesh=Mesh({"data": 1}, 0, {})))
    with pytest.raises(ValueError, match="int8 inference quantizes U-Net members only; SAMed"):
        next(fullres_batches(read, 2, (212, 212), [model], 2, 14, None, 2, 80, quantized=True))
    with pytest.raises(ValueError, match="cannot be row-sharded"):
        model.set_bands([(0, 10)])
    data = make_synthetic_data(num_specimens=2, num_projs=2, img_dim=32, seed=1)
    cfg = TrainConfig(**dict(SMALL, proj_unet_dim=64), batch_size=2, train_valid_split=0.5, max_num_epochs=1)
    for axes, spatial in (({"data": 1, "spatial": 2}, True), ({"data": 1, "model": 2}, False)):
        with pytest.raises(ValueError, match="shard the U-Net only; samed"):
            fit(data, [1, 2], cfg, verbose=False, device="cpu", mesh=Mesh(axes, 0, {}), shard_spatial=spatial,
                checkpoint_filename=str(tmp_path / "ck.pt"))


def test_a_profiled_forward_records_its_spans_and_one_attention_call_a_block():
    model = seeded(TrainConfig(**SMALL)).eval()
    x = frames()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model(x)
        model(x)
    spans, counts = profiling.recorded()
    device = profiling.device_seconds()
    profiling.reset()
    blocks = ["samed.rel_pos_attention"] * SMALL["num_layers"]
    assert [s.name for s in sorted(spans, key=lambda s: s.start_ns)] == (["samed.encoder"] + blocks +
                                                                         ["samed.decoder"]) * 2
    assert all(s.parent.name == "samed.encoder" for s in spans if s.name == "samed.rel_pos_attention")
    assert counts == {"rel_pos_attention_calls": 8}
    # its device time is summed; a CPU session launches nothing on a card
    assert device == {"samed.rel_pos_attention": 0.0}
    with torch.no_grad():
        model(x)
    assert profiling.recorded() == ([], {})
