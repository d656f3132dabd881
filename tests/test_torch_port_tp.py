"""The port's tensor parallelism (``parallel/tensor.py``, the U-Net's
'model' axis, ``fit`` on {'data', 'model'} meshes and ``cli/train.py
--tp-devices``) against the JAX package's ``make_tp_train_step`` on the
conftest's virtual CPU devices and against one process. Ranks are gloo
processes on the CPU with one torch thread each (``tests/
torch_port_ranks.py``): one spawn of two ranks and one of four carry the
steps and fits.

Tolerances: a TP step on {'model': 2}, {'model': 4} and {'data': 2,
'model': 2} against JAX's TP step on the same mesh from the same weights
at JAX's own (``tests/test_parallel.py``'s TP cases: loss within 1e-4
relative, parameters within 5e-5); against the port's one process the
forward is exact (each output channel is one rank's, the gathers add
zeros), so the loss within 1e-6 relative; backward sums each input
gradient's partial sums over the ranks in another order: parameters
within 1e-5 after a step of LR 0.1 (measured 2.2e-6). ``fit`` and the CLI against
one process's loss files at ``tests/test_train_mesh.py``'s rtol 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from deepfluoro_tpu.compat.torch_import import import_torch_state_dict
from deepfluoro_tpu.parallel import make_mesh as jax_make_mesh
from deepfluoro_tpu.parallel.sharding import _tp_leaf_sharding, make_tp_train_step
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.config import build_model as jax_build_model
from deepfluoro_tpu.train.step import TrainState as JaxTrainState
from deepfluoro_tpu.train.step import make_optimizer as jax_make_optimizer
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.compat.from_jax import _param_sources
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.tensor import channel_dims, is_cut
from deepfluoro_tpu_torch.train import TrainConfig, fit
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

# tests/test_parallel.py's TP cases: 14 landmarks on {'model': T}, 4 on DP x TP
STEP_CFG = dict(num_classes=7, depth=2, init_feats_exp=3, batch_norm=True, padding=True, no_max_pool=True,
                num_lands=14, proj_unet_dim=32, optim_type="sgd", init_lr=0.1, momentum=0.9, nesterov=True,
                wgt_decay=1e-4)
STEP_FLAGS = dict(n_classes=7, depth=2, wf=3, padding=True, batch_norm=True, max_pool=False, num_lands=14)
LAYOUTS = {"model2": ({"model": 2}, 14), "model4": ({"model": 4}, 14), "data2_model2": ({"data": 2, "model": 2}, 4)}

FIT_RECIPE = dict(
    num_classes=7, batch_size=4, proj_unet_dim=36, optim_type="sgd", init_lr=0.05, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=3, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=1,
    data_aug=True,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test files run at once under pytest-xdist; torch's OpenMP
    threads in each would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _flags(lands):
    return dict(STEP_FLAGS, num_lands=lands)


def _files(d, tag):
    return {k: os.path.join(str(d), "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


def _inputs():
    """Per layout: a seeded port state dict and a batch of 4 frames at
    32^2 (the ranks start on these at once)."""
    out = {}
    rng = np.random.default_rng(0)
    for name, (axes, lands) in LAYOUTS.items():
        torch.manual_seed(0)
        sd = _np(UNet(**_flags(lands)).state_dict())
        for k in ("weight", "bias"):  # the dead deepest conv, which flax never makes (zeros, as imported)
            sd["downsample_convs.{}.{}".format(STEP_CFG["depth"] - 1, k)][...] = 0
        proj = rng.random((4, 32, 32, 1)).astype(np.float32)
        seg = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4, 32, 32))]
        heats = rng.random((4, 32, 32, lands)).astype(np.float32)
        out[name] = {"sd": sd, "jax_batch": (proj, seg, heats),
                     "batch": tuple(np.ascontiguousarray(a.transpose(0, 3, 1, 2)) for a in (proj, seg, heats)),
                     "axes": axes, "lands": lands}
    return out


def _jax_tp_step(case):
    """JAX's TP step on the case's mesh from the case's weights (the JAX
    package's own importer): (loss, the state after it as a port state
    dict)."""
    cfg = JaxTrainConfig(**dict(STEP_CFG, num_lands=case["lands"]))
    params, stats = import_torch_state_dict(case["sd"], cfg)
    tx = jax_make_optimizer(cfg)
    state = JaxTrainState(params=params, batch_stats=stats, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    axes = case["axes"]
    mesh = jax_make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])
    step, place = make_tp_train_step(cfg, jax_build_model(cfg), tx, mesh, state)
    after, loss = step(place(state), *(jnp.asarray(a) for a in case["jax_batch"]), 0.1)
    return float(loss), _np(state_dict_from_jax(jax.tree.map(np.asarray, after.params),
                                                jax.tree.map(np.asarray, after.batch_stats),
                                                UNet(**_flags(case["lands"]))))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("tp") / "ds.h5"), num_specimens=2, num_projs=4,
                                   img_dim=32, seed=1)


@pytest.fixture(scope="module")
def one_fit(tmp_path_factory, archive):
    files = _files(tmp_path_factory.mktemp("tp_one"), "one")
    out = fit(archive, [1, 2], TrainConfig(**FIT_RECIPE), device="cpu", verbose=False, **files)
    return {"files": files, "state": _np(out["model"].state_dict()), "train": out["train_losses"],
            "valid": out["valid_losses"]}


def _one_step(case):
    from deepfluoro_tpu_torch.train.step import make_optimizer, update_step

    m = UNet(**_flags(case["lands"]))
    m.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()})
    cfg = TrainConfig(**dict(STEP_CFG, num_lands=case["lands"]))
    proj, seg, heats = (torch.from_numpy(a) for a in case["batch"])
    loss = update_step(m, make_optimizer(cfg, m.parameters()), cfg, {"proj": proj, "seg": seg, "heats": heats}, 0.1)
    return float(loss), _np(m.state_dict())


def _step_call(case):
    return ("tp_step", (_flags(case["lands"]), dict(STEP_CFG, num_lands=case["lands"]), case["sd"], *case["batch"],
                        0.1, case["axes"]))


def _fit_call(tmp, archive, axes, tag):
    files = _files(tmp, tag)
    return files, ("tp_fits", ([{"source": archive, "pats": [1, 2], "axes": axes, "cfg_kw": FIT_RECIPE,
                                 "files": files}],))


@pytest.fixture(scope="module")
def runs(archive, tmp_path_factory):
    """The ranks (one spawn of two, one of four: the TP steps and fits)
    start, then JAX's TP steps run here while they work."""
    from deepfluoro_tpu_torch.parallel.multihost import Ranks

    cases = _inputs()
    files2, call2 = _fit_call(tmp_path_factory.mktemp("tp_two"), archive, {"model": 2}, "m2")
    files4, call4 = _fit_call(tmp_path_factory.mktemp("tp_four"), archive, {"data": 2, "model": 2}, "d2m2")
    spawned = [Ranks(ranks.run_all, 2, args=([_step_call(cases["model2"]), call2],), device="cpu"),
               Ranks(ranks.run_all, 4, args=([_step_call(cases["model4"]), _step_call(cases["data2_model2"]),
                                              call4],), device="cpu")]
    try:
        for case in cases.values():
            case["loss"], case["want"] = _jax_tp_step(case)
        got2, got4 = (r.results(timeout=600) for r in spawned)
    finally:
        for r in spawned:
            r.close()
    return {"cases": cases,
            "two": {"step": [r[0] for r in got2], "fit": [r[1][0] for r in got2], "files": files2},
            "four": {"model4": [r[0] for r in got4], "data2_model2": [r[1] for r in got4],
                     "fit": [r[2][0] for r in got4], "files": files4}}


@pytest.fixture(scope="module")
def step_cases(runs):
    return runs["cases"]


@pytest.fixture(scope="module")
def two(runs):
    return runs["two"]


@pytest.fixture(scope="module")
def four(runs):
    return runs["four"]


def _steps(two, four, name):
    return two["step"] if name == "model2" else four[name]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tp_step_equals_jax_tp_step(two, four, step_cases, name):
    case = step_cases[name]
    for r in _steps(two, four, name):
        assert r["loss"] == pytest.approx(case["loss"], rel=1e-4)
        for k, v in case["want"].items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(r["state"][k], v, rtol=0, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tp_step_equals_one_process(two, four, step_cases, name):
    loss, state = _one_step(step_cases[name])
    results = _steps(two, four, name)
    for r in results:
        assert r["loss"] == pytest.approx(loss, rel=1e-6)
        for k, v in state.items():
            np.testing.assert_allclose(r["state"][k], v, rtol=0, atol=1e-5, err_msg=k)
        # every rank gathers the same whole state
        for k in state:
            np.testing.assert_array_equal(r["state"][k], results[0]["state"][k], err_msg=k)


@pytest.mark.parametrize("size", [2, 4])
def test_shard_rule_is_jax_rule_leaf_for_leaf(size):
    """Every port leaf is cut over T ranks exactly where JAX's
    ``_tp_leaf_sharding`` shards its flax counterpart: the 7-class head and
    the 21-channel first landmark 1x1 stay whole, the 14-channel last one
    is cut at T = 2 and not at 4, the first convolution (cin 1) is cut."""
    model = UNet(**STEP_FLAGS)
    params, _ = import_torch_state_dict(_np(model.state_dict()), JaxTrainConfig(**STEP_CFG))
    mesh = jax_make_mesh({"model": size}, devices=jax.devices()[:size])
    dims = channel_dims(model)
    sources = _param_sources(model, params)
    assert sources
    for key, (path, _) in sources.items():
        leaf = params
        for p in path:
            leaf = leaf[p]
        jax_cut = _tp_leaf_sharding(mesh, "model", leaf).spec != P()
        assert is_cut(dims[key], size) == jax_cut, key
    assert not is_cut(dims["seg_conv.weight"], size) and not is_cut(dims["lands_1x1.0.weight"], size)
    assert is_cut(dims["lands_1x1.1.weight"], size) == (size == 2)
    assert is_cut(dims["down_path.0.block.0.weight"], size)
    assert dims["up_path.0.up.weight"][0] == 1  # a transposed convolution cuts its output channels, dim 1


def test_tp_cuts_leaves_on_every_rank(two, four):
    for r in two["step"] + four["model4"]:
        assert "down_path.0.block.0.weight" in r["cut"] and "seg_conv.weight" not in r["cut"]
    assert "lands_1x1.1.weight" in two["step"][0]["cut"] and "lands_1x1.1.weight" not in four["model4"][0]["cut"]


@pytest.mark.parametrize("name", ["two", "four"])
def test_fit_on_a_model_mesh_equals_one_process(two, four, one_fit, name):
    got = {"two": two, "four": four}[name]
    for r in got["fit"]:
        np.testing.assert_allclose(r["train_losses"], one_fit["train"], rtol=1e-5)
        np.testing.assert_allclose(r["valid_losses"], one_fit["valid"], rtol=1e-5)
        for k, v in one_fit["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(read_floats_from_txt(got["files"]["train_loss_txt"]), one_fit["train"], rtol=1e-5)
    np.testing.assert_allclose(read_floats_from_txt(got["files"]["valid_loss_txt"]), one_fit["valid"], rtol=1e-5)


@pytest.mark.parametrize("name", ["two", "four"])
def test_model_ranks_draw_their_data_slice_augmentation(two, four, name):
    """Every 'model' rank of a data slice prepares the same inputs (the
    generator keyed by the data index only); data slices differ."""
    fits = {"two": two, "four": four}[name]["fit"]
    by_slice = {}
    for r in fits:
        by_slice.setdefault(r["coords"].get("data", 0), []).append(r["drawn"])
    for drawn in by_slice.values():
        assert len(drawn[0]) > 0 and all(d == drawn[0] for d in drawn)
    if len(by_slice) > 1:
        assert by_slice[0] != by_slice[1]


def test_gathered_checkpoint_loads_as_one_process_net(four, one_fit):
    model, cfg = load_net_from_checkpoint(four["files"]["checkpoint_filename"], device="cpu", verbose=False)
    assert cfg.num_lands == 14
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), four["fit"][0]["state"][k], err_msg=k)
    ck = torch.load(four["files"]["checkpoint_filename"], map_location="cpu", weights_only=False)
    # whole momentum buffers, keyed by the whole model's parameters
    params = dict(UNet(**STEP_FLAGS).named_parameters())
    for i, (k, p) in enumerate(params.items()):
        entry = ck["optimizer-state-dict"]["state"].get(i)
        if entry is not None:
            assert entry["momentum_buffer"].shape == p.shape, k


def test_cli_tp_devices_equal_one_process(tmp_path, archive):
    common = [archive, "--train-pats", "1,2", "--num-classes", "7", "--batch-size", "4", "--unet-img-dim", "36",
              "--unet-num-lvls", "2", "--unet-init-feats-exp", "3", "--unet-batch-norm", "--unet-padding",
              "--unet-no-max-pool", "--use-lands", "--train-valid-split", "0.75", "--max-num-epochs", "1",
              "--lr-sched", "plateau", "--init-lr", "0.05", "--momentum", "0.9", "--nesterov", "--wgt-decay", "1e-4",
              "--data-aug", "--no-gpu"]
    out = {}
    for tag, extra in (("plain", []), ("tp", ["--tp-devices", "2"])):
        files = _files(tmp_path, tag)
        cli_train.main(common + extra + ["--checkpoint-net", files["checkpoint_filename"], "--best-net",
                                         files["best_valid_filename"], "--train-loss-txt", files["train_loss_txt"],
                                         "--valid-loss-txt", files["valid_loss_txt"]])
        out[tag] = (read_floats_from_txt(files["train_loss_txt"]), read_floats_from_txt(files["valid_loss_txt"]))
    assert len(out["tp"][0]) == len(out["plain"][0]) > 0
    np.testing.assert_allclose(out["tp"][0], out["plain"][0], rtol=1e-5)
    np.testing.assert_allclose(out["tp"][1], out["plain"][1], rtol=1e-5)


def test_spatial_tp_rejected(tmp_path):
    """'spatial' x 'model' is refused by the CLI and by ``fit``, naming
    'spatial', as the JAX package refuses it."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(SystemExit, match="spatial"):
        cli_train.main(["x.h5", "--train-pats", "1,2", "--num-classes", "7", "--batch-size", "4", "--no-gpu",
                        "--spatial-devices", "2", "--tp-devices", "2"])
    data = make_synthetic_data(num_specimens=1, num_projs=2, img_dim=32, seed=0)
    with pytest.raises(NotImplementedError, match="'spatial'"):
        fit(data, [1], TrainConfig(**FIT_RECIPE), device="cpu", verbose=False, mesh=Mesh({"model": 2, "spatial": 2},
                                                                                          0, {}),
            shard_spatial=True, **_files(tmp_path, "x"))


def test_one_rank_axis_cuts_nothing():
    from deepfluoro_tpu_torch.parallel.tensor import shard_channels

    model = UNet(**STEP_FLAGS)
    before = _np(model.state_dict())
    dims = shard_channels(model, Axis())
    assert model.channel_axis.size == 1 and dims == channel_dims(UNet(**STEP_FLAGS))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k])
