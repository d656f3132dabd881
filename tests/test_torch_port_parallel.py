"""The port's process layer (``parallel/multihost.py``, ``parallel/mesh.py``)
and synchronized BatchNorm (``models/unet.py::BatchNorm2d`` with a group,
``parallel/sharding.py``) against the JAX package and against one process.
Two gloo ranks on the CPU, one torch thread each; depth-3 nets.

Tolerances: synchronized BatchNorm on 2 ranks against one process on the
whole batch differs only by the order of float32 sums (the statistics
are combined in float64): outputs within 1e-6, gradients within 1e-5 of
each tensor's largest, running means and variances within 1e-6. Against
flax over the global batch the existing U-Net tolerances hold (outputs
1e-4, running statistics 1e-5: the CPU's and XLA's convolutions sum in
other orders).

Member- and batch-sharded ensemble inference, float and int8, from the
same exported members: against the port's one process, mean seg and heats
within 1e-5 (the member sums are added in another order); against the
JAX package's mesh runs, float within 1e-5 with labels equal wherever
JAX's top two mean probabilities differ by more than 1e-4, and int8 at
``test_torch_port_quantized.py``'s port-against-JAX tolerances for
nn-files (seg and heats within 2e-2 everywhere and 1e-3 on >= 99.9 % of
values, labels >= 99.9 % equal: each package calibrates on its own float
replay, and an activation one rounding apart can quantize to the next
integer; measured here 7.4e-4 on 0.1 % of the seg values, 2.5e-3 on
0.02 % of the heats)."""

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_ranks as ranks
from deepfluoro_tpu.compat.torch_import import export_torch_checkpoint
from deepfluoro_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from deepfluoro_tpu.data.augment import prepare_batch as jax_prepare_batch
from deepfluoro_tpu.data.hdf5 import FluoroData as JaxFluoroData
from deepfluoro_tpu.infer import quantized as jq
from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint as jax_load_net
from deepfluoro_tpu.infer.ensemble import seg_dataset_ensemble as jax_seg_dataset_ensemble
from deepfluoro_tpu.infer.ensemble import stack_variables
from deepfluoro_tpu.models import UNet as JaxUNet
from deepfluoro_tpu.parallel.sharding import make_sharded_ensemble_forward, make_sharded_quantized_ensemble_forward
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.config import build_model as jax_build_model
from deepfluoro_tpu.parallel import make_mesh as jax_make_mesh
from deepfluoro_tpu.parallel import multihost as jax_multihost
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
from deepfluoro_tpu_torch.infer import ensemble_forward, load_net_from_checkpoint
from deepfluoro_tpu_torch.infer.quantized import int8_forwards
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.parallel import local_batch_slice, local_shard_indices, make_mesh, run_ranks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test files run at once under pytest-xdist; torch's OpenMP
    threads in each would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,seed,epoch,world", [(10, 0, 0, 2), (37, 5, 3, 4), (64, 123, 7, 8), (9, 2, 1, 3), (5, 1, 0, 1)])
def test_shards_and_batch_slices_equal_jax(monkeypatch, n, seed, epoch, world):
    """Every rank's shard and its slice of a global batch, bit for bit."""
    monkeypatch.setattr(jax, "process_count", lambda: world)
    batch = np.random.default_rng(seed).permutation(100)[: 2 * world]
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        np.testing.assert_array_equal(local_shard_indices(n, seed, epoch, rank, world),
                                      jax_multihost.local_shard_indices(n, seed, epoch))
        np.testing.assert_array_equal(local_batch_slice(batch, rank, world), jax_multihost.local_batch_slice(batch))
    shards = np.concatenate([local_shard_indices(n, seed, epoch, r, world) for r in range(world)])
    assert len(set(shards.tolist())) == len(shards) == (n // world) * world


def test_make_mesh_factorization_and_error():
    with pytest.raises(AssertionError, match="must cover 8 devices"):
        jax_make_mesh({"data": 3})
    with pytest.raises(ValueError, match=r"mesh axes \{'data': 3\} must cover 1 devices"):
        make_mesh({"data": 3})
    mesh = make_mesh()
    assert mesh.axes == {"data": 1} and mesh.axis("data").size == 1 and mesh.axis("ensemble").size == 1
    assert mesh.axis("data").group is None and mesh.axis("data").rows(6) == slice(0, 6)


FLAGS = dict(n_classes=7, depth=3, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=4)
SIZE = 32
GLOBAL_BATCH = 4
N_FORWARDS = 2


@pytest.fixture(scope="module")
def bn_case():
    """Flax variables drawn from a seed, two global batches, per-sample
    loss weights; the port's one-process run on them; the 2-rank run; and
    flax's train-mode forwards over the global batches."""
    jmodel = JaxUNet(**FLAGS)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])
    model = UNet(**FLAGS)
    sd = state_dict_from_jax(params, stats, model)
    model.load_state_dict(sd)
    x = rng.standard_normal((N_FORWARDS, GLOBAL_BATCH, 1, SIZE, SIZE)).astype(np.float32)
    weights = (rng.standard_normal((GLOBAL_BATCH, 7, SIZE, SIZE)).astype(np.float32),
               rng.standard_normal((GLOBAL_BATCH, 4, SIZE, SIZE)).astype(np.float32))

    model.train()
    for xi in x:
        out = model(torch.from_numpy(xi))
    ranks.unet_loss(out, tuple(torch.from_numpy(w) for w in weights)).backward()
    one = {
        "out": [o.detach().numpy() for o in out],
        "grads": {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None},
        "state": {k: v.numpy() for k, v in model.state_dict().items()},
    }
    two = run_ranks(ranks.sync_bn_unet, 2, args=(FLAGS, {k: v.numpy() for k, v in sd.items()}, x, weights, N_FORWARDS),
                    device="cpu", timeout=300)
    for xi in x:
        jout, mutated = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(xi.transpose(0, 2, 3, 1)),
                                     train=True, mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    flax = {"out": [np.asarray(o).transpose(0, 3, 1, 2) for o in jout],
            "state": {k: v.numpy() for k, v in state_dict_from_jax(params, stats, model).items()}}
    return one, two, flax


def test_sync_batchnorm_outputs_equal_one_process(bn_case):
    one, two, _ = bn_case
    for i, want in enumerate(one["out"]):
        got = np.concatenate([r["out"][i] for r in two])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sync_batchnorm_gradients_equal_one_process(bn_case):
    one, two, _ = bn_case
    assert set(two[0]["grads"]) == set(two[1]["grads"]) == set(one["grads"])
    bn_weights = [n for n in one["grads"] if ".block." in n and one["grads"][n].ndim == 1]
    assert bn_weights  # BatchNorm's weights and biases get their gradients through the synchronized backward
    for name, want in one["grads"].items():
        scale = float(np.abs(want).max())
        for r in two:
            np.testing.assert_allclose(r["grads"][name], want, rtol=0, atol=1e-5 * scale, err_msg=name)


def test_sync_batchnorm_running_stats_equal_one_process_and_each_other(bn_case):
    one, two, _ = bn_case
    keys = [k for k in one["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 2 * (2 * FLAGS["depth"] - 1)
    for k in keys:
        np.testing.assert_array_equal(two[0]["state"][k], two[1]["state"][k], err_msg=k)
        np.testing.assert_allclose(two[0]["state"][k], one["state"][k], rtol=0, atol=1e-6, err_msg=k)
    for k in one["state"]:
        if k.endswith("num_batches_tracked"):
            assert int(two[0]["state"][k]) == int(one["state"][k]) == N_FORWARDS


def test_sync_batchnorm_equals_flax_over_the_global_batch(bn_case):
    _, two, flax = bn_case
    for i, want in enumerate(flax["out"]):
        np.testing.assert_allclose(np.concatenate([r["out"][i] for r in two]), want, atol=1e-4)
    for k, want in flax["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(two[1]["state"][k], want, atol=1e-5, err_msg=k)


def test_mesh_layouts_over_two_ranks():
    got = run_ranks(ranks.mesh_layouts, 2, device="cpu", timeout=120)
    for rank, out in enumerate(got):
        assert out["data"] == {"data": (2, rank, True), "ensemble": (1, 0, False)}
        assert out["ens_data"] == {"data": (2, rank, True), "ensemble": (1, 0, False)}
        assert out["default"] == out["data"]
        assert out["error"] == "mesh axes {'ensemble': 2, 'data': 2} must cover 2 devices"


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(ranks.fail_on_rank, 2, args=(1,), device="cpu", timeout=120)


ENS_CFG = dict(num_classes=7, depth=3, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
               proj_unet_dim=36)
ENS_K = 4
ENS_BATCH = 4
CALIB_BATCHES = 2
LAYOUTS = {"members": {"ensemble": 2}, "rows": {"ensemble": 1, "data": 2}}


def _export_members(jcfg, k, d, seed=0):
    """k members drawn from a seed (kernels ~ N(0, 1/fan_in), biases and
    BatchNorm affine ~ N(0, 0.1), running variances in [0.5, 1.5)),
    written by the JAX package's exporter as reference-layout .pt files."""
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

    paths = []
    for i in range(k):
        variables = {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"]),
                     "batch_stats": jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])}
        payload = {"meta": jcfg.to_checkpoint_meta(), "epoch": 1, "loss": 0.25, "best-valid-loss": -0.5,
                   "lrs-num-restarts": 0, "model-state-dict": variables, "optimizer-state-dict": {},
                   "scheduler-state-dict": {}, "train-idx": [0], "valid-idx": [1]}
        paths.append(export_torch_checkpoint(payload, str(d / "member{}.pt".format(i))))
    return paths


@pytest.fixture(scope="module")
def ens_case(tmp_path_factory):
    """Four exported members over six 32^2 frames at batch 4 (the final
    batch of 2 padded); for each layout and mode the JAX package's
    seg_dataset_ensemble and sharded forward on a mesh of 2 of the forced
    CPU devices, and the port's on 2 ranks, all in one spawn."""
    d = tmp_path_factory.mktemp("ens")
    paths = _export_members(JaxTrainConfig(**ENS_CFG), ENS_K, d)
    projs = make_synthetic_data(num_specimens=1, num_projs=6, img_dim=32, seed=5).projs
    runs = [(axes, q, str(d / "port_{}_{}.h5".format(name, q))) for name, axes in LAYOUTS.items() for q in (False, True)]
    port = run_ranks(ranks.ensemble_runs, 2, args=(paths, projs, ENS_BATCH, CALIB_BATCHES, runs), device="cpu",
                     timeout=300)[0]

    members = [jax_load_net(p, verbose=False) for p in paths]
    models_and_vars = [(m, v) for m, v, _ in members]
    jmodel = members[0][0]
    aug = JaxAugmentConfig(proj_pad_dim=36, prob_of_aug=0.0, include_heat_map=False)
    jprep = [jax_prepare_batch(aug, jax.random.PRNGKey(0), jnp.asarray(projs[i : i + ENS_BATCH]))["proj"]
             for i in range(0, len(projs), ENS_BATCH)]
    data = JaxFluoroData(projs=projs, segs=None, lands=None, orig_img_shape=(32, 32))
    models = [load_net_from_checkpoint(p, device="cpu", verbose=False)[0] for p in paths]
    aug = AugmentConfig(proj_pad_dim=36, prob_of_aug=0.0, include_heat_map=False)
    prep = [prepare_batch(aug, None, torch.from_numpy(projs[i : i + ENS_BATCH]))["proj"]
            for i in range(0, len(projs), ENS_BATCH)]
    one = {q: [a.numpy() for a in ensemble_forward(int8_forwards(models, prep[:CALIB_BATCHES]) if q else models,
                                                    prep[0], (32, 32), 14)] for q in (False, True)}
    out = {}
    for (axes, q, port_path), (seg, heats) in zip(runs, port):
        mesh = jax_make_mesh(axes, devices=jax.devices()[:2])
        jax_path = port_path.replace("port_", "jax_")
        with h5py.File(jax_path, "w") as f:
            jax_seg_dataset_ensemble(data, models_and_vars, f, num_lands=14, batch_size=ENS_BATCH, pad_img_dim=36,
                                     mesh=mesh, quantized=q, calib_batches=CALIB_BATCHES)
        if q:
            fwd, place = make_sharded_quantized_ensemble_forward(jmodel, 14, (32, 32), mesh)
            stacked = jq.prepare_quantized_ensemble(models_and_vars, jprep[:CALIB_BATCHES])
        else:
            fwd, place = make_sharded_ensemble_forward(jmodel, 14, (32, 32), mesh)
            stacked = stack_variables([v for _, v in models_and_vars])
        want = [np.asarray(a) for a in fwd(place(stacked), jprep[0])]
        out[axes_name(axes), q] = dict(port=(seg, heats, port_path), jax=(want, jax_path), one=one[q])
    return out


def axes_name(axes):
    return next(name for name, a in LAYOUTS.items() if a == axes)


def _assert_int8_close(got, want):
    d = np.abs(got - want)
    assert d.max() <= 2e-2 and (d > 1e-3).mean() <= 1e-3, (d.max(), (d > 1e-3).mean())


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_ensemble_forward_matches_one_process_and_jax_mesh(ens_case, layout, quantized):
    case = ens_case[layout, quantized]
    seg, heats, _ = case["port"]
    one_seg, one_heats, one_labels = case["one"]
    np.testing.assert_allclose(seg, one_seg, rtol=0, atol=1e-5)
    np.testing.assert_allclose(heats, one_heats, rtol=0, atol=1e-5)
    (want_seg, want_heats, want_labels), _ = case["jax"]
    want_seg, want_heats = want_seg.transpose(0, 3, 1, 2), want_heats.transpose(0, 3, 1, 2)
    if quantized:
        _assert_int8_close(seg, want_seg)
        _assert_int8_close(heats, want_heats)
        assert (seg.argmax(1) == want_labels).mean() >= 0.999
        return
    np.testing.assert_allclose(seg, want_seg, rtol=0, atol=1e-5)
    np.testing.assert_allclose(heats, want_heats, rtol=0, atol=1e-5)
    top2 = np.sort(want_seg, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(seg.argmax(1)[clear], want_labels[clear])


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_seg_dataset_ensemble_file_matches_jax(ens_case, layout, quantized):
    case = ens_case[layout, quantized]
    _, _, port_path = case["port"]
    _, jax_path = case["jax"]
    with h5py.File(port_path, "r") as fp, h5py.File(jax_path, "r") as fj:
        for name in ("nn-segs", "nn-heats"):
            a, b = fj[name], fp[name]
            assert (b.shape, b.dtype, b.chunks, b.compression_opts) == (a.shape, a.dtype, a.chunks, a.compression_opts)
        if quantized:
            _assert_int8_close(fp["nn-heats"][:], fj["nn-heats"][:])
        else:
            np.testing.assert_allclose(fp["nn-heats"][:], fj["nn-heats"][:], rtol=0, atol=1e-5)
        assert (fp["nn-segs"][:] == fj["nn-segs"][:]).mean() >= 0.999
