"""TransUNet R50-ViT on the port's normal path (``models/transunet.py``,
``train/config.py``'s ``arch``, ``load_net_from_checkpoint``,
``fullres_batches``, ``seg_fullres``, ``fit``) against the plain
reference ``tests/transunet_reference.py`` in float64, on the CPU. The
JAX package has no TransUNet, so the reference is the published code's
equations written out; the full-res prep is held against the JAX
package's.

Sizes: widths, depth, units and GroupNorm groups cut (hidden 32, 4
heads, MLP 64, 2 blocks, ResNet units (1, 2, 1) at width 8, 4 groups,
decoder (16, 8, 8, 4)) on 48^2 inputs: a 3^2 grid of 9 tokens, and an
11^2 quarter map that the skip quirk pads to 12^2. Weights are seeded,
with norm scales, shifts, BatchNorm statistics and the position table
drawn too, so that no parameter is at a value that hides its use.
Tolerances: the float32 port against the float64 reference within 1e-5
(probabilities, which lie in [0, 1]) and 1e-5 of the heatmaps' largest
magnitude: float32 rounding through some forty layers at these widths
reads 4e-8 and 4e-7 in eval mode, 2e-6 and 3e-6 in train mode (the batch
statistics of two small frames amplify it)."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transunet_reference as ref
from deepfluoro_tpu.data.preprocess import make_fullres_prep as jax_prep
from deepfluoro_tpu_torch.cli import seg_fullres as port_cli
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, make_synthetic_fullres_data
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.models.transunet import Attention, TransUNet
from deepfluoro_tpu_torch.models.unet import UNet
from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.parallel.mesh import Mesh
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit
from deepfluoro_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

SMALL = dict(arch="transunet", num_classes=7, num_lands=14, proj_unet_dim=48, hidden_size=32, num_heads=4, mlp_dim=64,
             num_layers=2, resnet_units=(1, 2, 1), resnet_width=8, gn_groups=4, decoder_channels=(16, 8, 8, 4))
REF_CFG = dict(num_heads=4, gn_groups=4, n_skip=3)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded(cfg: TrainConfig, seed: int = 0) -> TransUNet:
    """A TransUNet of ``cfg`` with every float parameter and buffer drawn
    from ``seed``: weights uniform in +-1/sqrt(fan_in), norm scales and
    BatchNorm variances in [0.5, 1.5], the rest in +-0.3."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if not v.is_floating_point():
                continue
            u = torch.rand(v.shape, generator=gen)
            if k.endswith(".running_var") or (k.endswith(".weight") and v.ndim == 1):
                v.copy_(0.5 + u)
            elif k.endswith(".weight"):
                v.copy_((2 * u - 1) / v[0].numel() ** 0.5)
            else:
                v.copy_(0.6 * u - 0.3)
    return model


def as64(model) -> dict:
    return {k: v.double() if v.is_floating_point() else v for k, v in model.state_dict().items()}


def frames(n=2, size=48, seed=1):
    return torch.randn(n, 1, size, size, generator=torch.Generator().manual_seed(seed))


def assert_close_to_reference(got, want):
    seg, heats = got
    rseg, rheats = want
    assert seg.shape == rseg.shape and heats.shape == rheats.shape
    assert (seg.double() - rseg).abs().max() < TOL
    assert (heats.double() - rheats).abs().max() < TOL * rheats.abs().max()


def test_build_model_builds_the_configured_net():
    model = build_model(TrainConfig(**SMALL))
    assert isinstance(model, TransUNet)
    keys = set(model.state_dict())
    for k in ("transformer.embeddings.hybrid_model.root.conv.weight",
              "transformer.embeddings.hybrid_model.body.block2.unit1.gn_proj.weight",
              "transformer.embeddings.position_embeddings", "transformer.encoder.layer.1.attn.query.weight",
              "transformer.encoder.layer.1.ffn.fc2.bias", "transformer.encoder.encoder_norm.weight",
              "decoder.conv_more.1.running_var", "decoder.blocks.3.conv2.0.weight", "segmentation_head.0.bias",
              "lands_1x1.1.weight"):
        assert k in keys, k
    assert model.transformer.embeddings.position_embeddings.shape == (1, 9, 32)
    assert len(model.transformer.encoder.layer) == 2
    assert isinstance(build_model(TrainConfig(num_classes=7)), UNet)
    with pytest.raises(ValueError, match="arch"):
        build_model(TrainConfig(arch="vit"))
    with pytest.raises(ValueError, match="float32 without remat"):
        build_model(TrainConfig(**SMALL, remat=True))
    with pytest.raises(ValueError, match="multiple of 16"):
        build_model(TrainConfig(**dict(SMALL, proj_unet_dim=40)))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_the_reference(mode):
    """Eval mode takes the BatchNorm statistics; train mode the batch's
    (dropout at 0: the reference has none), and moves the running
    statistics as torch does (momentum 0.1, unbiased variance)."""
    model = seeded(TrainConfig(**SMALL))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    x = frames()
    p = as64(model)
    stats = {}
    want = ref.forward(p, x.double(), REF_CFG, train=mode == "train", stats=stats)
    model.train(mode == "train")
    got = model(x)
    assert_close_to_reference(got, want)
    bn = model.decoder.blocks[1].conv1[1]
    if mode == "train":
        mean, var = stats["decoder.blocks.1.conv1.1"]
        n = x.shape[0] * 12 * 12  # the second block works at 12^2
        assert torch.allclose(bn.running_mean.double(), 0.9 * p["decoder.blocks.1.conv1.1.running_mean"] + 0.1 * mean,
                              atol=1e-6)
        assert torch.allclose(bn.running_var.double(),
                              0.9 * p["decoder.blocks.1.conv1.1.running_var"] + 0.1 * var * n / (n - 1), atol=1e-6)
    else:
        assert torch.equal(bn.running_mean, model.state_dict()["decoder.blocks.1.conv1.1.running_mean"])


def test_dropout_is_on_in_training_and_off_in_eval():
    model = seeded(TrainConfig(**SMALL))
    x = frames()
    model.train()
    torch.manual_seed(1)
    a = model(x)[0]
    torch.manual_seed(2)
    b = model(x)[0]
    assert (a - b).abs().max() > 1e-3
    model.eval()
    assert torch.equal(model(x)[0], model(x)[0])
    assert_close_to_reference(model(x), ref.forward(as64(model), x.double(), REF_CFG))


def test_the_skip_of_an_odd_quarter_map_is_zero_padded():
    """48^2: the root gives 24^2 and the pool 11^2; the first stage's 11^2
    skip is padded to 48 / 4 = 12 at the bottom and right, the second
    stage runs on the unpadded 11^2 map (6^2, 48 / 8) and the third gives
    the 3^2 grid."""
    model = seeded(TrainConfig(**SMALL)).eval()
    resnet = model.transformer.embeddings.hybrid_model
    x = frames().repeat(1, 3, 1, 1)
    with torch.no_grad():
        last, features = resnet(x)
        inner = resnet.body[0](F.max_pool2d(resnet.root(x), 3, 2))
    assert [tuple(f.shape[1:]) for f in features] == [(64, 6, 6), (32, 12, 12), (8, 24, 24)]
    assert tuple(last.shape[1:]) == (128, 3, 3) and tuple(inner.shape[-2:]) == (11, 11)
    quarter = features[1]
    assert torch.equal(quarter[..., :11, :11], inner)
    assert quarter[..., 11, :].abs().max() == 0 and quarter[..., :, 11].abs().max() == 0
    _, want = ref.encoder(as64(model), x.double(), REF_CFG)
    for f, w in zip(features, want):
        assert (f.double() - w).abs().max() < TOL * w.abs().max()


def test_sdpa_attention_matches_the_explicit_softmax():
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 4, 37, 8, generator=gen) for _ in range(3))
    got = F.scaled_dot_product_attention(q, k, v).double()
    assert (got - ref.attention(q.double(), k.double(), v.double())).abs().max() < 1e-6
    attn = Attention(32, 4).eval()
    tokens = torch.randn(2, 9, 32, generator=gen)
    p = {"attn." + k: w.double() for k, w in attn.state_dict().items()}
    b, n, d = tokens.shape
    q, k, v = (ref._linear(p, "attn." + w, tokens.double()).reshape(b, n, 4, d // 4).transpose(1, 2)
               for w in ("query", "key", "value"))
    want = ref._linear(p, "attn.out", ref.attention(q, k, v).transpose(1, 2).reshape(b, n, d))
    with torch.no_grad():
        assert (attn(tokens).double() - want).abs().max() < 1e-6


def test_checkpoint_meta_round_trips_and_a_meta_without_arch_is_a_unet(tmp_path):
    cfg = TrainConfig(**SMALL)
    meta = cfg.to_checkpoint_meta()
    assert meta["arch"] == "transunet" and meta["resnet-units"] == [1, 2, 1] and meta["vit-num-heads"] == 4
    back = TrainConfig.from_checkpoint_meta(meta)
    assert back == cfg
    unet_meta = TrainConfig(num_classes=7).to_checkpoint_meta()
    assert "arch" not in unet_meta and not any(k.startswith(("vit-", "resnet-")) for k in unet_meta)
    assert TrainConfig.from_checkpoint_meta(unet_meta, base=cfg).arch == "unet"
    model = seeded(cfg)
    path = str(tmp_path / "tu.pt")
    save_checkpoint(path, cfg, model, epoch=3)
    loaded, got = load_net_from_checkpoint(path, device="cpu", verbose=False)
    assert isinstance(loaded, TransUNet) and not loaded.training and got == back
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    upath = str(tmp_path / "unet.pt")
    ucfg = TrainConfig(num_classes=7, depth=2, init_feats_exp=2, batch_norm=True, padding=True, num_lands=14)
    save_checkpoint(upath, ucfg, build_model(ucfg))
    assert "arch" not in load_checkpoint(upath)
    unet, _ = load_net_from_checkpoint(upath, device="cpu", verbose=False)
    assert isinstance(unet, UNet)


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


def test_fullres_batches_serves_transunet_members_like_the_reference():
    """Raw 148^2 frames at 2x (24^2 padded to 48), two members, batch 2
    over five frames (the last batch padded)."""
    models = [seeded(TrainConfig(**SMALL), seed=s).eval() for s in (5, 6)]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    times = []
    batches = list(fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (148, 148), models,
                                   2, 14, times, 2, 48))
    assert [(s, l.shape, h.shape) for s, l, h in batches][-1] == (4, (1, 24, 24), (1, 14, 24, 24))
    assert len(times) == 5
    labels = np.concatenate([l for _, l, _ in batches])
    heats = np.concatenate([h for _, _, h in batches])
    _assert_served_like_the_reference(labels, heats, _reference_ensemble(models, spec["projs"], spec["rots"], 2, 48))


def test_seg_fullres_serves_a_transunet_checkpoint(tmp_path):
    archive = write_synthetic_fullres_dataset(str(tmp_path / "full.h5"), num_projs=3, seed=3)
    model = seeded(TrainConfig(**SMALL), seed=8)
    net = str(tmp_path / "tu.pt")
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
    _assert_served_like_the_reference(labels, heats, _reference_ensemble([model.eval()], projs, rots, 2, 48))


def test_fit_steps_a_transunet_and_writes_its_checkpoint(tmp_path):
    """Two epochs of one step each (4 frames of 32^2, split 0.5, batch 2,
    augmentation on), on one device; the checkpoint reloads the net."""
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
    assert isinstance(out["model"], TransUNet) and len(out["train_losses"]) == 2
    assert np.isfinite(out["train_losses"]).all() and np.isfinite(out["valid_losses"]).all()
    after = out["model"].state_dict()
    assert (after["transformer.encoder.layer.0.attn.query.weight"] - before[
        "transformer.encoder.layer.0.attn.query.weight"]).abs().max() > 0
    assert load_checkpoint(paths["checkpoint_filename"])["arch"] == "transunet"
    loaded, got = load_net_from_checkpoint(paths["checkpoint_filename"], device="cpu", verbose=False)
    assert isinstance(loaded, TransUNet) and got.arch == "transunet"
    for k, v in after.items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_mesh_int8_and_sharded_training_refuse_a_transunet(tmp_path):
    model = seeded(TrainConfig(**SMALL)).eval()
    projs = np.ones((2, 148, 148), np.float32)
    rots = np.zeros(2, bool)
    read = lambda i0, i1: (projs[i0:i1], rots[i0:i1])  # noqa: E731
    with pytest.raises(ValueError, match="U-Net members only"):
        next(fullres_batches(read, 2, (148, 148), [model], 2, 14, None, 2, 48, mesh=Mesh({"data": 1}, 0, {})))
    with pytest.raises(ValueError, match="int8 inference quantizes U-Net members only"):
        next(fullres_batches(read, 2, (148, 148), [model], 2, 14, None, 2, 48, quantized=True))
    data = make_synthetic_data(num_specimens=2, num_projs=2, img_dim=32, seed=1)
    cfg = TrainConfig(**SMALL, batch_size=2, train_valid_split=0.5, max_num_epochs=1)
    for axes, spatial in (({"data": 1, "spatial": 2}, True), ({"data": 1, "model": 2}, False)):
        with pytest.raises(ValueError, match="shard the U-Net only"):
            fit(data, [1, 2], cfg, verbose=False, device="cpu", mesh=Mesh(axes, 0, {}), shard_spatial=spatial,
                checkpoint_filename=str(tmp_path / "ck.pt"))
