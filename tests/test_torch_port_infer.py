"""The port's ensemble inference (deepfluoro_tpu_torch.infer and its
test_ensemble CLI) against the JAX package's, on the same weights and
frames, on the CPU.

Weights are drawn from a numpy seed for the flax net and carried to the
port by compat.from_jax, or written as a reference-layout .pt by the JAX
package's export_torch_checkpoint, which both packages'
load_net_from_checkpoint read. Frames come from the synthetic fixture.
Tolerances: member-mean seg and heats within 1e-5 (float32 on both sides,
convolutions summed in another order); labels equal wherever JAX's top two
mean probabilities differ by more than 1e-4 (an argmax can flip inside
that margin)."""

import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluoro_tpu.compat.torch_import import export_torch_checkpoint
from deepfluoro_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from deepfluoro_tpu.data.augment import prepare_batch as jax_prepare_batch
from deepfluoro_tpu.data.hdf5 import load_dataset as jax_load_dataset
from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint as jax_load_net
from deepfluoro_tpu.infer.ensemble import make_ensemble_forward, stack_variables
from deepfluoro_tpu.infer.ensemble import test_dataset_ensemble as jax_ensemble_eval
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.config import build_model as jax_build_model
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, write_synthetic_dataset
from deepfluoro_tpu_torch.data.hdf5 import load_dataset
from deepfluoro_tpu_torch.infer import ensemble_batches, ensemble_forward, load_net_from_checkpoint
from deepfluoro_tpu_torch.infer import test_dataset_ensemble as ensemble_eval
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model

ATOL = 1e-5
MARGIN = 1e-4
CFG = dict(num_classes=7, depth=3, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14)


def _jax_members(jcfg, k, seed=0):
    """k flax variable trees drawn from a seed: kernels ~ N(0, 1/fan_in),
    biases and BatchNorm affine ~ N(0, 0.1), running variances in [0.5, 1.5)."""
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    members = []
    for _ in range(k):
        params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
        stats = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])
        members.append({"params": params, "batch_stats": stats})
    return model, members


def _port_members(cfg, members):
    out = []
    for v in members:
        model = build_model(cfg)
        model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], model))
        out.append(model.eval())
    return out


def _export(jcfg, variables, path, epoch=1):
    """A reference-layout .pt from the JAX package's exporter; the plateau
    scheduler state holds numpy scalars, as a restored JAX checkpoint's does."""
    payload = {
        "meta": jcfg.to_checkpoint_meta(), "epoch": epoch, "loss": 0.25, "best-valid-loss": -0.5,
        "lrs-num-restarts": 0, "model-state-dict": variables, "optimizer-state-dict": {},
        "scheduler-state-dict": {"lr": np.float32(0.1), "best": np.float64(-0.5), "num_bad_epochs": np.int64(1)},
        "train-idx": [0, 1], "valid-idx": [2],
    }
    return export_torch_checkpoint(payload, str(path))


def _assert_labels_match(got, want, avg_seg_jax_nhwc):
    top2 = np.sort(avg_seg_jax_nhwc, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("frame,pad_dim", [(32, 36), (31, 36)], ids=["even-delta", "odd-delta"])
def test_ensemble_forward_matches_jax(k, frame, pad_dim):
    """The member mean of softmax segs and of per-image min-max heats, and
    the uint8 argmax; 31 -> 36 rounds the pad up to 37, as 179 -> 193."""
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=pad_dim)
    jmodel, members = _jax_members(jcfg, k, seed=k)
    projs = make_synthetic_data(num_specimens=1, num_projs=3, img_dim=frame, seed=5).projs

    jproj = jax_prepare_batch(JaxAugmentConfig(proj_pad_dim=pad_dim, prob_of_aug=0.0, include_heat_map=False),
                              jax.random.PRNGKey(0), jnp.asarray(projs))["proj"]
    fwd = make_ensemble_forward(jmodel, 14, (frame, frame))
    want_seg, want_heats, want_labels = (np.asarray(a) for a in fwd(stack_variables(members), jproj))

    proj = prepare_batch(AugmentConfig(proj_pad_dim=pad_dim, prob_of_aug=0.0), None, torch.from_numpy(projs))["proj"]
    assert proj.shape[-1] == (37 if frame == 31 else 36)
    seg, heats, labels = ensemble_forward(_port_members(TrainConfig(**CFG, proj_unet_dim=pad_dim), members), proj,
                                          (frame, frame), 14)
    assert labels.dtype == torch.uint8 and tuple(labels.shape) == (3, frame, frame)
    np.testing.assert_allclose(seg.numpy(), want_seg.transpose(0, 3, 1, 2), atol=ATOL)
    np.testing.assert_allclose(heats.numpy(), want_heats.transpose(0, 3, 1, 2), atol=ATOL)
    assert heats.amin() >= 0.0 and heats.amax() <= 1.0
    _assert_labels_match(labels.numpy(), want_labels, want_seg)


def test_ensemble_batches_keep_order_partial_batch_and_times():
    """Batches of 2 over 5 frames: every frame once, in order, the last
    batch partial; one time per frame, each its batch's time over its size;
    the outputs equal one ensemble_forward over all frames."""
    cfg = TrainConfig(**CFG, proj_unet_dim=36)
    _, members = _jax_members(JaxTrainConfig(**CFG, proj_unet_dim=36), 2)
    models = _port_members(cfg, members)
    data = make_synthetic_data(num_specimens=1, num_projs=5, img_dim=32, seed=1)
    times = []
    batches = list(ensemble_batches(data, models, 14, times, batch_size=2, pad_img_dim=36))
    assert [(s, l.shape[0]) for s, l, _ in batches] == [(0, 2), (2, 2), (4, 1)]
    assert len(times) == 5 and times[0] == times[1] and all(t > 0 for t in times)
    proj = prepare_batch(AugmentConfig(proj_pad_dim=36, prob_of_aug=0.0), None, torch.from_numpy(data.projs))["proj"]
    _, heats, labels = ensemble_forward(models, proj, (32, 32), 14)
    np.testing.assert_array_equal(np.concatenate([l for _, l, _ in batches]), labels.numpy())
    np.testing.assert_allclose(np.concatenate([h for _, _, h in batches]), heats.numpy(), atol=1e-6)


@pytest.mark.parametrize("dice_only", [False, True], ids=["joint", "dice-only"])
def test_test_dataset_ensemble_matches_jax(tmp_path, dice_only):
    """Ensemble validation loss (mean, std) over a fixture specimen, heats
    not min-max normalized, batches of 4 over 6 frames."""
    path = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=1, num_projs=6, img_dim=32, seed=2)
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    jmodel, members = _jax_members(jcfg, 2, seed=7)
    kw = dict(num_lands=14, dice_only=dice_only, batch_size=4, pad_img_dim=36, heat_coeff=0.3)
    want = jax_ensemble_eval(jax_load_dataset(path, [1]), [(jmodel, v) for v in members], **kw)
    got = ensemble_eval(load_dataset(path, [1]), _port_members(TrainConfig(**CFG, proj_unet_dim=36), members), **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_load_net_reads_a_jax_export_and_the_ports_own_checkpoint(tmp_path, capsys):
    """A .pt written by the JAX package's export_torch_checkpoint loads into
    the port with the JAX loader's configuration and forward; a checkpoint
    the port saved loads back into both packages."""
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    jmodel, (variables,) = _jax_members(jcfg, 1, seed=3)
    exported = _export(jcfg, variables, tmp_path / "exported.pt")

    model, cfg = load_net_from_checkpoint(exported, device="cpu")
    printed = capsys.readouterr().out
    assert "loading unet params from torch (reference) checkpoint..." in printed
    assert "num. lands.: 14" in printed and "reflect pad img. dim.: 36" in printed
    jmodel2, jvars, jcfg2 = jax_load_net(exported, verbose=False)
    for f in ("num_classes", "depth", "init_feats_exp", "batch_norm", "padding", "no_max_pool", "proj_unet_dim",
              "num_lands", "use_res", "block_depth"):
        assert getattr(cfg, f) == getattr(jcfg2, f), f
    assert not model.training and next(model.parameters()).device.type == "cpu"

    x = np.random.default_rng(0).standard_normal((2, 36, 36, 1)).astype(np.float32)
    want = jmodel2.apply(jvars, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=1e-4)

    own = str(tmp_path / "own.pt")
    save_checkpoint(own, cfg, model, epoch=4)
    model3, _ = load_net_from_checkpoint(own, device="cpu", verbose=False)
    jmodel3, jvars3, _ = jax_load_net(own, verbose=False)
    with torch.no_grad():
        again = model3(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for g, a, w in zip(got, again, jmodel3.apply(jvars3, jnp.asarray(x), train=False)):
        np.testing.assert_array_equal(a.numpy(), g.numpy())
        np.testing.assert_allclose(a.numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=1e-4)


@pytest.mark.parametrize("block_depth,num_1x1", [(0, 2), (2, 1), (1, 3)])
def test_load_net_infers_the_landmark_head_from_the_keys(tmp_path, block_depth, num_1x1):
    """Checkpoints do not store the head's depth; the loader counts the
    lands_block and lands_1x1 keys and rebuilds the same net."""
    torch.manual_seed(block_depth)
    cfg = TrainConfig(num_classes=3, depth=2, init_feats_exp=2, padding=True, num_lands=4, proj_unet_dim=16)
    src = UNet(n_classes=3, depth=2, wf=2, padding=True, num_lands=4, lands_block_depth=block_depth,
               lands_num_1x1=num_1x1).eval()
    path = str(tmp_path / "head.pt")
    save_checkpoint(path, cfg, src)
    model, _ = load_net_from_checkpoint(path, device="cpu", verbose=False)
    assert len(model.lands_block) == block_depth and len(model.lands_1x1) == num_1x1
    x = torch.randn(1, 1, 16, 16)
    with torch.no_grad():
        for g, w in zip(model(x), src(x)):
            assert torch.equal(g, w)


def test_load_net_without_a_card_refuses_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot happen")
    cfg = TrainConfig(num_classes=3, depth=2, init_feats_exp=2, padding=True, proj_unet_dim=16)
    path = str(tmp_path / "net.pt")
    save_checkpoint(path, cfg, build_model(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_net_from_checkpoint(path, verbose=False)


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """The JAX and the port's test_ensemble CLIs on one fixture archive and
    the same two exported nets, batches of 4 over 6 frames (the final batch
    partial), each writing its nn-file."""
    from deepfluoro_tpu.cli import test_ensemble as jax_cli
    from deepfluoro_tpu_torch.cli import test_ensemble as port_cli

    d = tmp_path_factory.mktemp("te")
    ds = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=2, num_projs=6, img_dim=32, seed=3)
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    _, members = _jax_members(jcfg, 2, seed=11)
    nets = [_export(jcfg, v, d / "net{}.pt".format(i)) for i, v in enumerate(members)]
    args = [ds, None, "--pats", "2", "--nets", *nets, "--batch-size", "4", "--no-gpu"]
    out = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        args[1] = out[name] = str(d / "{}.h5".format(name))
        cli.main(args + ["--times", str(d / "{}_times.txt".format(name))])
    return d, ds, nets, out


def test_test_ensemble_cli_matches_jax(cli_outputs):
    """Same datasets, shapes, dtypes, chunks and gzip-9 compression as the
    JAX file, the land-names group, and the arrays within tolerance; one
    time per frame."""
    d, ds, nets, out = cli_outputs
    with h5py.File(out["jax"], "r") as fj, h5py.File(out["port"], "r") as fp:
        for name in ("nn-segs", "nn-heats"):
            a, b = fj[name], fp[name]
            assert (b.shape, b.dtype, b.chunks, b.compression, b.compression_opts) == (
                a.shape, a.dtype, a.chunks, a.compression, a.compression_opts), name
        assert fp["nn-segs"].shape == (6, 32, 32) and fp["nn-heats"].chunks == (1, 1, 32, 32)
        assert fp["nn-segs"].dtype == np.uint8 and fp["nn-segs"].compression_opts == 9
        for key in fj["land-names"]:
            assert fj["land-names"][key][()] == fp["land-names"][key][()], key
        np.testing.assert_allclose(fp["nn-heats"][:], fj["nn-heats"][:], atol=ATOL)
        labels_p, labels_j = fp["nn-segs"][:], fj["nn-segs"][:]
    # the margins come from JAX's member mean on the same nets and frames
    members = [jax_load_net(p, verbose=False) for p in nets]
    jproj = jax_prepare_batch(JaxAugmentConfig(proj_pad_dim=36, prob_of_aug=0.0, include_heat_map=False),
                              jax.random.PRNGKey(0), jnp.asarray(jax_load_dataset(ds, [2], no_seg=True).projs))["proj"]
    fwd = make_ensemble_forward(members[0][0], 14, (32, 32))
    avg_seg, _, want_labels = (np.asarray(a) for a in fwd(stack_variables([v for _, v, _ in members]), jproj))
    np.testing.assert_array_equal(labels_j, want_labels)
    _assert_labels_match(labels_p, labels_j, avg_seg)
    times = [float(t) for t in open(d / "port_times.txt")]
    assert len(times) == 6 and all(t > 0 for t in times)


def test_cli_chain_on_the_jax_nn_file_writes_the_same_csvs(cli_outputs):
    """est_lands_csv and compute_actual_dice_on_test of both packages, fed
    the JAX CLI's nn-file: the same Dice CSV bytes, and the same landmark
    CSV in every column but time."""
    from deepfluoro_tpu.cli import compute_actual_dice_on_test as jax_dice
    from deepfluoro_tpu.cli import est_lands_csv as jax_lands
    from deepfluoro_tpu_torch.cli import compute_actual_dice_on_test as port_dice
    from deepfluoro_tpu_torch.cli import est_lands_csv as port_lands

    d, ds, _, out = cli_outputs
    csv = {}
    for name, lands, dice, extra in (("jax", jax_lands, jax_dice, []), ("port", port_lands, port_dice, ["--no-gpu"])):
        csv[name] = (str(d / "{}_lands.csv".format(name)), str(d / "{}_dice.csv".format(name)))
        lands.main([out["jax"], "nn-heats", "--use-seg", "nn-segs", "--pat", "2", "--out", csv[name][0], *extra])
        dice.main([ds, out["jax"], "nn-segs", csv[name][1], "2", *extra])
    assert open(csv["port"][1], "rb").read() == open(csv["jax"][1], "rb").read()
    strip = lambda p: [ln.rsplit(",", 1)[0] for ln in open(p).read().splitlines()]  # noqa: E731
    assert strip(csv["port"][0]) == strip(csv["jax"][0])
    assert len(strip(csv["port"][0])) == 1 + 6 * 14


def test_test_ensemble_cli_refuses_mixed_members_and_a_missing_card(cli_outputs, tmp_path):
    from deepfluoro_tpu_torch.cli import test_ensemble as port_cli

    _, ds, nets, _ = cli_outputs
    jcfg = dataclasses.replace(JaxTrainConfig(**CFG), proj_unet_dim=44)
    _, (v,) = _jax_members(jcfg, 1)
    other = _export(jcfg, v, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="proj_unet_dim"):
        port_cli.main([ds, str(tmp_path / "o.h5"), "--pats", "2", "--nets", nets[0], other, "--no-gpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main([ds, str(tmp_path / "o.h5"), "--pats", "2", "--nets", *nets])
