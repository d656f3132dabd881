"""Swin UNETR in 2D on the port's normal path (``models/swinunetr.py``,
``train/config.py``'s ``arch``, ``load_net_from_checkpoint``,
``fullres_batches``, ``seg_fullres``, ``fit``) against the plain
reference ``tests/swinunetr_reference.py``, on the CPU. The JAX package
has no Swin UNETR, so the reference is MONAI's equations written out; the
full-res prep is held against the JAX package's.

Sizes: feature size 12 (the published heads 3, 6, 12, 24, of width 4),
the published window of 7, on 64^2 and 96^2 inputs. At 64^2 the stage
grids are 32, 16, 8 and 4: the first three pad to whole windows (35, 21,
14) and their shifted blocks take the shift mask; the last is at or under
the window, which clamps to 4 (16 tokens, the bias index cut to its first
16 rows and columns) with no shift. At 96^2 the grids are 48, 24, 12 and
6 (padded to 49, 28 and 14; the last clamped to 6). Weights are seeded,
with LayerNorm scales and shifts and the bias tables drawn too, so that no
parameter is at a value that hides its use. Tolerances: float64 within
1e-10 (the port and the reference differ only in the order of their
sums: 2e-15 and 6e-15 read); float32 within 1e-5 of the probabilities,
which lie in [0, 1], and 1e-5 of the heatmaps' largest magnitude
(float32 rounding through some seventy layers at these widths reads 4e-7
and 6e-7)."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swinunetr_reference as ref
from deepfluoro_tpu.data.preprocess import make_fullres_prep as jax_prep
from deepfluoro_tpu_torch.cli import seg_fullres as port_cli
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, make_synthetic_fullres_data
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.infer.batches import may_capture
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.models.swinunetr import SwinUNETR, WindowAttention, padded, shift_mask
from deepfluoro_tpu_torch.models.unet import UNet
from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.parallel.mesh import Mesh
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit
from deepfluoro_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from deepfluoro_tpu_torch.utils import profiling

SMALL = dict(arch="swinunetr", num_classes=7, num_lands=14, proj_unet_dim=64, feature_size=12)
REF_CFG = dict(swin_heads=[3, 6, 12, 24], window_size=7)
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


def seeded(cfg: TrainConfig, seed: int = 0) -> SwinUNETR:
    """A Swin UNETR of ``cfg`` with every float parameter drawn from
    ``seed``: weights uniform in +-1/sqrt(fan_in), LayerNorm scales in
    [0.5, 1.5], the rest (biases, shifts, bias tables) in +-0.3."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if not v.is_floating_point():
                continue
            u = torch.rand(v.shape, generator=gen)
            if k.endswith(".weight") and v.ndim == 1:
                v.copy_(0.5 + u)
            elif k.endswith(".weight"):
                v.copy_((2 * u - 1) / v[0].numel() ** 0.5)
            else:
                v.copy_(0.6 * u - 0.3)
    return model


def as64(model) -> dict:
    return {k: v.double() if v.is_floating_point() else v for k, v in model.state_dict().items()}


def frames(n=2, size=64, seed=1):
    return torch.randn(n, 1, size, size, generator=torch.Generator().manual_seed(seed))


def assert_close_to_reference(got, want, tol=TOL):
    seg, heats = got
    rseg, rheats = want
    assert seg.shape == rseg.shape and heats.shape == rheats.shape
    assert (seg.double() - rseg).abs().max() < tol
    assert (heats.double() - rheats).abs().max() < tol * rheats.abs().max()


def test_build_model_builds_the_configured_net():
    model = build_model(TrainConfig(**SMALL))
    assert isinstance(model, SwinUNETR)
    keys = set(model.state_dict())
    for k in ("swinViT.patch_embed.proj.bias", "swinViT.layers1.0.blocks.0.norm1.weight",
              "swinViT.layers2.0.blocks.1.attn.qkv.bias", "swinViT.layers3.0.blocks.1.attn.proj.weight",
              "swinViT.layers4.0.blocks.1.attn.relative_position_bias_table",
              "swinViT.layers4.0.blocks.0.attn.relative_position_index", "swinViT.layers1.0.blocks.1.mlp.linear2.bias",
              "swinViT.layers4.0.downsample.reduction.weight", "swinViT.layers2.0.downsample.norm.bias",
              "encoder1.layer.conv3.conv.weight", "encoder10.layer.conv2.conv.weight",
              "decoder5.transp_conv.conv.weight", "decoder1.conv_block.conv3.conv.weight", "out.conv.conv.bias",
              "lands_1x1.1.weight"):
        assert k in keys, k
    assert "encoder2.layer.conv3.conv.weight" not in keys and "swinViT.layers1.0.downsample.reduction.bias" not in keys
    assert model.swinViT.layers2[0].blocks[0].attn.relative_position_bias_table.shape == (169, 6)
    assert isinstance(build_model(TrainConfig(num_classes=7)), UNet)
    with pytest.raises(ValueError, match="float32 without remat"):
        build_model(TrainConfig(**SMALL, remat=True))
    with pytest.raises(ValueError, match="multiple of 32"):
        build_model(TrainConfig(**dict(SMALL, proj_unet_dim=48)))


def test_the_published_net_has_25_1_million_parameters():
    with torch.device("meta"):
        model = build_model(TrainConfig(arch="swinunetr", num_classes=7, num_lands=14, proj_unet_dim=736))
    assert sum(p.numel() for p in model.parameters()) == 25_139_674


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_matches_the_reference(size, dtype):
    """The padded grids, the shifted blocks' masks and the clamped last
    stage at both sizes, the landmark head included."""
    model = seeded(TrainConfig(**SMALL)).eval().to(dtype)
    x = frames(size=size)
    with torch.no_grad():
        got = model(x.to(dtype))
    assert_close_to_reference(got, ref.forward(as64(model), x.double(), REF_CFG), TOL64 if dtype == torch.float64
                              else TOL)


def test_without_landmarks_the_forward_returns_the_probabilities():
    model = seeded(TrainConfig(**dict(SMALL, num_lands=0))).eval().double()
    x = frames().double()
    with torch.no_grad():
        seg = model(x)
    want, _ = ref.forward(as64(model), x, REF_CFG)
    assert (seg - want).abs().max() < TOL64


@pytest.mark.parametrize("size,sides,padded_sides", [(64, [32, 16, 8, 4], [35, 21, 14, 4]),
                                                     (96, [48, 24, 12, 6], [49, 28, 14, 6])])
def test_the_stage_grids_pad_shift_and_clamp(size, sides, padded_sides):
    """Each stage's shift mask is MONAI's ``compute_mask`` of its padded
    grid, made once and held; the last stage's grid clamps the window to
    itself, unshifted."""
    model = seeded(TrainConfig(**dict(SMALL, proj_unet_dim=size))).eval()
    layers = [getattr(model.swinViT, "layers{}".format(i + 1))[0] for i in range(4)]
    for layer, side, full in zip(layers[:3], sides, padded_sides):
        mask = layer.mask(side, "cpu")
        want = ref.compute_mask(full, full, 7, 3, "cpu")
        assert mask.shape == (want.shape[0], 49, 56) and torch.equal(mask[..., :49], want)
        assert mask[..., 49:].abs().max() == 0 and (want != 0).any()
        assert layer.mask(side, "cpu") is mask
    assert layers[3].mask(sides[3], "cpu") is None


def test_a_clamped_window_takes_the_first_rows_of_the_full_index():
    """MONAI cuts the 7x7 window's relative-position index to the clamped
    window's n tokens (``[:n, :n]``) rather than using the n-token
    window's own index; the port does as published."""
    attn = seeded(TrainConfig(**SMALL)).swinViT.layers4[0].blocks[0].attn
    table = attn.relative_position_bias_table
    index = ref.relative_position_index(7)[:16, :16].reshape(-1)
    assert torch.equal(attn.bias(16), table[index].reshape(16, 16, -1).permute(2, 0, 1))
    assert not torch.equal(ref.relative_position_index(7)[:16, :16], ref.relative_position_index(4))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_attention_matches_the_explicit_softmax(shifted, dtype):
    """``F.scaled_dot_product_attention`` with the padded float mask
    against softmax(q k^T / sqrt(d) + B + M) v written out, on the two
    frames' 25 windows of a 35^2 grid."""
    gen = torch.Generator().manual_seed(4)
    attn = WindowAttention(24, 6, 7)
    with torch.no_grad():
        attn.relative_position_bias_table.uniform_(-0.3, 0.3, generator=gen)
    attn = attn.to(dtype)
    windows = torch.randn(2 * 25, 49, 24, generator=gen, dtype=dtype)
    mask = shift_mask(35, 7, 3, "cpu") if shifted else None
    p = {"a." + k: v.double() for k, v in attn.state_dict().items() if v.is_floating_point()}
    want = ref.window_attention(p, "a", windows.double(), 6, 7, None if mask is None else mask[..., :49])
    with torch.no_grad():
        got = attn(windows, 2, mask)
    assert (got.double() - want).abs().max() < (TOL64 if dtype == torch.float64 else 1e-6)


def test_padded_masks_keep_their_values_and_align_their_rows():
    m = torch.randn(3, 2, 49, 49)
    p = padded(m.permute(0, 1, 3, 2))
    assert p.shape == (3, 2, 49, 56) and p.is_contiguous() and p.stride(-2) % 8 == 0
    assert torch.equal(p[..., :49], m.permute(0, 1, 3, 2)) and p[..., 49:].abs().max() == 0


def test_checkpoint_meta_round_trips_and_a_meta_without_arch_is_a_unet(tmp_path):
    cfg = TrainConfig(**SMALL)
    meta = cfg.to_checkpoint_meta()
    assert meta["arch"] == "swinunetr" and meta["swin-feature-size"] == 12 and meta["swin-num-heads"] == [3, 6, 12, 24]
    assert meta["swin-depths"] == [2, 2, 2, 2] and meta["swin-window-size"] == 7
    assert not any(k.startswith(("vit-", "resnet-")) for k in meta)
    back = TrainConfig.from_checkpoint_meta(meta)
    assert back == cfg
    assert TrainConfig.from_checkpoint_meta(TrainConfig(num_classes=7).to_checkpoint_meta(), base=cfg).arch == "unet"
    model = seeded(cfg)
    path = str(tmp_path / "swin.pt")
    save_checkpoint(path, cfg, model, epoch=3)
    loaded, got = load_net_from_checkpoint(path, device="cpu", verbose=False)
    assert isinstance(loaded, SwinUNETR) and not loaded.training and got == back
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _reference_ensemble(models, projs, rots, factor, pad):
    """JAX's prep, then the float64 reference's forward, center crop,
    per-image min-max heats, member mean and argmax."""
    jp, hw = jax_prep(factor, pad, projs.shape[-2:])
    x = torch.from_numpy(np.asarray(jp(jnp.asarray(projs), jnp.asarray(rots))).transpose(0, 3, 1, 2).copy()).double()
    seg_sum = heat_sum = 0
    for m in models:
        seg, heats = ref.forward(as64(m), x, REF_CFG)
        seg, heats = center_crop(seg, hw), center_crop(heats, hw)
        lo, hi = heats.amin(dim=(1, 2, 3), keepdim=True), heats.amax(dim=(1, 2, 3), keepdim=True)
        seg_sum, heat_sum = seg_sum + seg, heat_sum + (heats - lo) / (hi - lo)
    seg, heats = seg_sum / len(models), heat_sum / len(models)
    return seg, heats, seg.argmax(dim=1)


def _assert_served_like_the_reference(labels, heats, want):
    seg, want_heats, want_labels = want
    assert np.abs(heats - want_heats.numpy()).max() < 1e-5
    top2 = seg.sort(dim=1).values[:, -2:]
    clear = ((top2[:, 1] - top2[:, 0]) > 1e-4).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], want_labels.numpy()[clear])


def test_fullres_batches_serves_swinunetr_members_like_the_reference():
    """Raw 212^2 frames at 2x (56^2 padded to 64), two members, batch 2
    over five frames (the last batch padded); a Swin member is not offered
    for a CUDA graph and runs eager."""
    models = [seeded(TrainConfig(**SMALL), seed=s).eval() for s in (5, 6)]
    assert not may_capture(models) and not may_capture(models[:1])
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=212, seed=7)[0]
    times = []
    batches = list(fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (212, 212), models,
                                   2, 14, times, 2, 64))
    assert [(s, l.shape, h.shape) for s, l, h in batches][-1] == (4, (1, 56, 56), (1, 14, 56, 56))
    assert len(times) == 5
    labels = np.concatenate([l for _, l, _ in batches])
    heats = np.concatenate([h for _, _, h in batches])
    _assert_served_like_the_reference(labels, heats, _reference_ensemble(models, spec["projs"], spec["rots"], 2, 64))


def test_seg_fullres_serves_a_swinunetr_checkpoint(tmp_path):
    archive = write_synthetic_fullres_dataset(str(tmp_path / "full.h5"), num_projs=3, seed=3)
    model = seeded(TrainConfig(**SMALL), seed=8)
    net = str(tmp_path / "swin.pt")
    save_checkpoint(net, TrainConfig(**SMALL), model)
    out = str(tmp_path / "out.h5")
    port_cli.main([archive, out, "--ds-factor", "2", "--nets", net, "--batch-size", "2", "--no-gpu"])
    with h5py.File(archive, "r") as src:
        keys = sorted(src["17-1882"]["projections"].keys())
        projs = np.stack([src["17-1882"]["projections"][k]["image/pixels"][:] for k in keys]).astype(np.float32)
        rots = np.array([bool(np.asarray(src["17-1882"]["projections"][k]["rot-180-for-up"][()])) for k in keys])
    with h5py.File(out, "r") as f:
        labels, heats = f["nn-segs"][:], f["nn-heats"][:]
    assert labels.shape == (3, 24, 24) and heats.shape == (3, 14, 24, 24)
    _assert_served_like_the_reference(labels, heats, _reference_ensemble([model.eval()], projs, rots, 2, 64))


def test_fit_steps_a_swinunetr_and_writes_its_checkpoint(tmp_path):
    """Two epochs of one step each (4 frames of 32^2 padded to 64, split
    0.5, batch 2, augmentation on), on one device; the bias tables learn;
    the checkpoint reloads the net."""
    cfg = TrainConfig(**SMALL, batch_size=2, train_valid_split=0.5, data_aug=True, max_num_epochs=2,
                      checkpoint_freq=1, init_lr=0.01)
    paths = {k: str(tmp_path / v) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        before = build_model(cfg).state_dict()
    out = fit(make_synthetic_data(num_specimens=2, num_projs=2, img_dim=32, seed=1), [1, 2], cfg, verbose=False,
              device="cpu", **paths)
    assert isinstance(out["model"], SwinUNETR) and len(out["train_losses"]) == 2
    assert np.isfinite(out["train_losses"]).all() and np.isfinite(out["valid_losses"]).all()
    after = out["model"].state_dict()
    for k in ("swinViT.layers1.0.blocks.1.attn.relative_position_bias_table", "swinViT.layers1.0.blocks.0.attn.qkv.weight",
              "decoder1.conv_block.conv1.conv.weight"):
        assert (after[k] - before[k]).abs().max() > 0, k
    assert load_checkpoint(paths["checkpoint_filename"])["arch"] == "swinunetr"
    loaded, got = load_net_from_checkpoint(paths["checkpoint_filename"], device="cpu", verbose=False)
    assert isinstance(loaded, SwinUNETR) and got.arch == "swinunetr"
    for k, v in after.items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_mesh_int8_and_sharded_training_refuse_a_swinunetr(tmp_path):
    model = seeded(TrainConfig(**SMALL)).eval()
    projs = np.ones((2, 212, 212), np.float32)
    rots = np.zeros(2, bool)
    read = lambda i0, i1: (projs[i0:i1], rots[i0:i1])  # noqa: E731
    with pytest.raises(ValueError, match="U-Net members only; SwinUNETR runs on one device"):
        next(fullres_batches(read, 2, (212, 212), [model], 2, 14, None, 2, 64, mesh=Mesh({"data": 1}, 0, {})))
    with pytest.raises(ValueError, match="int8 inference quantizes U-Net members only; SwinUNETR"):
        next(fullres_batches(read, 2, (212, 212), [model], 2, 14, None, 2, 64, quantized=True))
    data = make_synthetic_data(num_specimens=2, num_projs=2, img_dim=32, seed=1)
    cfg = TrainConfig(**SMALL, batch_size=2, train_valid_split=0.5, max_num_epochs=1)
    for axes, spatial in (({"data": 1, "spatial": 2}, True), ({"data": 1, "model": 2}, False)):
        with pytest.raises(ValueError, match="shard the U-Net only; swinunetr"):
            fit(data, [1, 2], cfg, verbose=False, device="cpu", mesh=Mesh(axes, 0, {}), shard_spatial=spatial,
                checkpoint_filename=str(tmp_path / "ck.pt"))


def test_a_profiled_forward_records_its_spans_and_eight_window_attentions():
    model = seeded(TrainConfig(**SMALL)).eval()
    x = frames()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model(x)
        model(x)
    spans, counts = profiling.recorded()
    profiling.reset()
    assert [s.name for s in sorted(spans, key=lambda s: s.start_ns)] == ["swinunetr.swin", "swinunetr.decoder"] * 2
    assert counts == {"window_attention_calls": 16}
    with torch.no_grad():
        model(x)
    assert profiling.recorded() == ([], {})
