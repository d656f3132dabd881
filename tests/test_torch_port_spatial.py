"""The port's spatial axis (``parallel/halo.py``, ``parallel/mesh.py::
row_layout``/``RowShard``, the row-sharded U-Net, losses, step, ``fit(
shard_spatial=True)``, ``cli/train.py --spatial-devices`` and sharded
full-res inference) against the JAX package on the conftest's virtual CPU
devices and against one process; and the repair of ``launch``'s one-hour
deadline. Ranks are gloo processes on the CPU with one torch thread each
(``tests/torch_port_ranks.py``): one spawn of four ranks and one of two
carry most cases.

Tolerances: the halo rows are copies (equal); a sharded convolution
against the whole frame's, and its gradients, within 1e-5 of their
largest. A depth-6
train step on {'spatial': 2} and {'data': 2, 'spatial': 2} against JAX's
single-device step from the same weights at JAX's own tolerances
(``tests/test_parallel.py``'s depth-6 case: loss within 1e-4 relative,
parameters within 5e-5). Uneven bands against one process, with zero
and circular padding and with remat (whose recompute trades the halos
again), differ by the order of sums only: loss within 1e-6 relative,
parameters and BatchNorm buffers within 1e-6 after a step; at bf16 with
remat the synchronized BatchNorm rounds at other points than the plain
one: loss within 5e-3 relative (``test_torch_port_bf16_remat.py``'s bf16
fit tolerance), parameters within 5e-3 after a step of LR 0.1. ``fit`` resumed from one JAX checkpoint on both
sides: per-step losses within 1e-4 relative (validation 1e-3,
``test_torch_port_resume.py``'s). Sharded full-res inference against
JAX's ``make_sharded_fullres_infer``: labels equal, heats within 1e-5
(``tests/test_infer_more.py``'s)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_ranks as ranks
from deepfluoro_tpu.data.preprocess import make_fused_fullres_infer as jax_fused_fullres
from deepfluoro_tpu.data.preprocess import make_sharded_fullres_infer as jax_sharded_fullres
from deepfluoro_tpu.models import UNet as JaxUNet
from deepfluoro_tpu.parallel import make_mesh as jax_make_mesh
from deepfluoro_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from deepfluoro_tpu.parallel.halo import sharded_conv2d as jax_sharded_conv2d
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import fit as jax_fit
from deepfluoro_tpu.train.step import make_optimizer as jax_make_optimizer
from deepfluoro_tpu.train.step import make_train_state, make_train_step
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset, write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.parallel import make_mesh, multihost, run_ranks
from deepfluoro_tpu_torch.parallel.mesh import Axis, RowShard, row_layout
from deepfluoro_tpu_torch.train import TrainConfig, fit
from deepfluoro_tpu_torch.train.step import make_optimizer, update_step
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

HALO_X = (2, 3, 32, 16)
MODES = ("reflect", "zeros", "circular")

STEP_CFG = dict(num_classes=7, batch_size=2, proj_unet_dim=192, depth=6, init_feats_exp=1, batch_norm=True,
                padding=True, no_max_pool=True, num_lands=2, optim_type="sgd", init_lr=0.1, momentum=0.9,
                nesterov=True, wgt_decay=1e-4)
STEP_FLAGS = dict(n_classes=7, depth=6, wf=1, padding=True, batch_norm=True, max_pool=False, num_lands=2)

UNEVEN_FLAGS = dict(n_classes=7, depth=4, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=4)
UNEVEN_CFG = dict(num_classes=7, num_lands=4, optim_type="sgd", init_lr=0.1, momentum=0.9, nesterov=True,
                  wgt_decay=1e-4, depth=4)
# the U-Net's pad modes, and remat (the recompute inside backward trades
# the halos again)
UNEVEN_MODES = {"zeros": dict(pad_mode="zeros"), "circular": dict(pad_mode="circular"),
                "zeros-remat": dict(pad_mode="zeros", remat=True),
                "zeros-bf16-remat": dict(pad_mode="zeros", remat=True, dtype=torch.bfloat16)}

FIT_RECIPE = dict(
    num_classes=7, batch_size=2, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=1,
)

FULLRES_CFG = dict(num_classes=7, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True,
                   num_lands=4, proj_unet_dim=28)
FULLRES_FLAGS = dict(n_classes=7, depth=2, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=4)


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


def _files(d, tag):
    return {k: os.path.join(str(d), "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


# ----- the repair: launch's local ranks have no deadline ---------------------

def test_launch_runs_local_ranks_without_a_deadline(monkeypatch):
    seen = {}

    def fake_run_ranks(fn, nprocs, args=(), device="cuda", backend=None, timeout=3600.0):
        seen.update(nprocs=nprocs, timeout=timeout, device=device)
        return ["rank 0's"]

    monkeypatch.setattr(multihost, "run_ranks", fake_run_ranks)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.launch(print, "args", 3, device="cpu") == "rank 0's"
    assert seen == {"nprocs": 3, "timeout": None, "device": "cpu"}


def test_no_deadline_still_stops_on_a_dead_rank():
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3 and no result"):
        run_ranks(ranks.die_on_rank, 2, args=(1,), device="cpu", timeout=None)


# ----- layouts -----------------------------------------------------------------

@pytest.mark.parametrize("rows,parts,multiple,want", [
    (1440, 2, 32, (736, 704)), (736, 2, 32, (384, 352)), (40, 2, 8, (24, 16)), (192, 2, 32, (96, 96)),
    (1440, 4, 32, (384, 352, 352, 352)), (28, 2, 2, (14, 14)), (32, 4, 1, (8, 8, 8, 8))])
def test_row_layout(rows, parts, multiple, want):
    assert row_layout(rows, parts, multiple) == want
    assert sum(want) == rows and all(r % multiple == 0 for r in want)


@pytest.mark.parametrize("rows,parts,multiple,match", [(193, 2, 32, "multiple of 32"), (64, 3, 32, "too few")])
def test_row_layout_refuses_what_cannot_be_cut(rows, parts, multiple, match):
    with pytest.raises(ValueError, match=match):
        row_layout(rows, parts, multiple)


def test_row_shard_window_is_the_center_crop_in_frame_coordinates():
    axis = Axis(2, 0, None, (0, 1))
    top, bottom = (RowShard(Axis(2, i, None, (0, 1)), axis, a, b, 192, ()) for i, (a, b) in
                   enumerate(((0, 96), (96, 192))))
    # 192 -> 180: rows 6..185 of the frame; the top band holds 6..95, the bottom 96..185
    assert top.window(180) == (slice(6, 96), slice(0, 90))
    assert bottom.window(180) == (slice(0, 90), slice(90, 180))
    whole = RowShard(Axis(), Axis(), 0, 192, 192, ())
    assert whole.window(180) == (slice(6, 186), slice(0, 180))


# ----- the four-rank spawn: halos, meshes, a depth-6 step, full-res ------------

@pytest.fixture(scope="module")
def step_case():
    """A depth-6 wf-1 state of the JAX package at 192^2, a batch of 2, and
    JAX's single-device step on it."""
    cfg = JaxTrainConfig(**STEP_CFG)
    model, state = make_train_state(cfg, jax.random.PRNGKey(0), (192, 192))
    rng = np.random.default_rng(0)
    proj = rng.random((2, 192, 192, 1)).astype(np.float32)
    seg = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 192, 192))]
    heats = rng.random((2, 192, 192, 2)).astype(np.float32)
    sd = _np(state_dict_from_jax(jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats),
                                 UNet(**STEP_FLAGS)))
    step = make_train_step(cfg, model, jax_make_optimizer(cfg))
    after, loss = step(state, jnp.asarray(proj), jnp.asarray(seg), jnp.asarray(heats), 0.1)
    want = _np(state_dict_from_jax(jax.tree.map(np.asarray, after.params), jax.tree.map(np.asarray, after.batch_stats),
                                   UNet(**STEP_FLAGS)))
    nchw = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))  # noqa: E731
    return {"sd": sd, "batch": (nchw(proj), nchw(seg), nchw(heats)), "loss": float(loss), "want": want}


@pytest.fixture(scope="module")
def fullres_case():
    """test_infer_more.py's sharded full-res case: a depth-2 net at 28^2,
    two raw 148^2 frames at 2x; a second net for the ensemble."""
    cfg = JaxTrainConfig(**FULLRES_CFG)
    rng = np.random.default_rng(0)
    nets = []
    for seed in (0, 1):
        model, state = make_train_state(cfg, jax.random.PRNGKey(seed), (28, 28))
        nets.append((model, {"params": state.params, "batch_stats": state.batch_stats}))
    projs = np.asarray(rng.random((2, 148, 148)), np.float32) + 0.1
    rots = np.array([True, False])
    model, variables = nets[0]
    mesh = jax_make_mesh({"data": 2, "spatial": 4})
    infer, place = jax_sharded_fullres(model, variables, 2, 28, (148, 148), mesh)
    labels, heats = infer(*place(projs, rots))
    one_labels, one_heats = jax_fused_fullres(model, variables, 2, 28, (148, 148))(jnp.asarray(projs), jnp.asarray(rots))
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(one_labels))
    sds = [_np(state_dict_from_jax(jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["batch_stats"]),
                                   UNet(**FULLRES_FLAGS))) for _, v in nets]
    return {"sds": sds, "projs": projs, "rots": rots, "labels": np.asarray(labels),
            "heats": np.asarray(heats).transpose(0, 3, 1, 2)}


@pytest.fixture(scope="module")
def halo_inputs():
    rng = np.random.default_rng(1)
    x = rng.random(HALO_X).astype(np.float32)
    w = rng.standard_normal((2, 3, 32 + 2 * 4, 16)).astype(np.float32)
    k = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    return x, w, k


@pytest.fixture(scope="module")
def four(step_case, fullres_case, halo_inputs):
    proj, seg, heats = step_case["batch"]
    calls = [
        ("halo_cases", (*halo_inputs, MODES)),
        ("mesh_axes", ([{"data": 2, "spatial": 2}, {"spatial": 2, "data": 2}, {"spatial": 4}],)),
        ("spatial_step", (STEP_FLAGS, STEP_CFG, step_case["sd"], proj, seg, heats, 0.1, {"data": 2, "spatial": 2})),
        ("sharded_fullres", (FULLRES_FLAGS, fullres_case["sds"], fullres_case["projs"], fullres_case["rots"], 2, 28,
                             {"data": 2, "spatial": 2}, 2)),
    ]
    return run_ranks(ranks.run_all, 4, args=(calls,), device="cpu", timeout=600)


def _halo_sources(h, bands, mode):
    """For each band (start, stop) the source row of each haloed row, None
    for a zero."""
    out = []
    for a, b in bands:
        top = a - 1 if a > 0 else {"reflect": 1, "zeros": None, "circular": h - 1}[mode]
        bot = b if b < h else {"reflect": h - 2, "zeros": None, "circular": 0}[mode]
        out.append([top] + list(range(a, b)) + [bot])
    return out


@pytest.mark.parametrize("mode", MODES)
def test_halo_exchange_rows_and_gradients(four, halo_inputs, mode):
    x, w, _ = halo_inputs
    bands = [(8 * i, 8 * i + 8) for i in range(4)]
    grad = np.zeros_like(x)
    offset = 0
    for r, src in enumerate(_halo_sources(32, bands, mode)):
        got, got_grad = four[r][0][mode]
        want = np.stack([x[:, :, s] if s is not None else np.zeros_like(x[:, :, 0]) for s in src], axis=2)
        np.testing.assert_array_equal(got, want)
        for j, s in enumerate(src):
            if s is not None:
                grad[:, :, s] += w[:, :, offset + j]
        offset += len(src)
    np.testing.assert_allclose(np.concatenate([four[r][0][mode][1] for r in range(4)], axis=2), grad, atol=1e-6)


def test_halo_exchange_equals_jax(four, halo_inputs):
    x = halo_inputs[0]
    mesh = jax_make_mesh({"spatial": 4}, devices=jax.devices()[:4])
    want = np.asarray(jax_halo_exchange(mesh, jnp.asarray(x.transpose(0, 2, 3, 1)), halo=1, axis="spatial"))
    got = np.concatenate([four[r][0]["reflect"][0] for r in range(4)], axis=2)
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_sharded_conv2d_equals_jax_and_whole_frame(four, halo_inputs):
    x, _, k = halo_inputs
    mesh = jax_make_mesh({"spatial": 4}, devices=jax.devices()[:4])
    want_jax = np.asarray(jax_sharded_conv2d(mesh, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                             jnp.asarray(k.transpose(2, 3, 1, 0)))).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    whole = F.conv2d(F.pad(xt, (1, 1, 1, 1), mode="reflect"), kt)
    (whole * xt.detach()[:, :1]).sum().backward()
    got = np.concatenate([four[r][0]["conv"][0] for r in range(4)], axis=2)
    np.testing.assert_allclose(got, want_jax, atol=1e-5)
    np.testing.assert_allclose(got, whole.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(np.concatenate([four[r][0]["conv"][1] for r in range(4)], axis=2), xt.grad.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(sum(four[r][0]["conv"][2] for r in range(4)), kt.grad.numpy(),
                               atol=1e-5 * float(kt.grad.abs().max()))


def test_mesh_axes_and_joint_groups(four):
    for rank in range(4):
        d_s, s_d, s4 = four[rank][1]
        d, s = divmod(rank, 2)
        assert d_s["data"][:2] == (2, d) and d_s["spatial"][:2] == (2, s)
        assert d_s["joint"] == (4, rank, (0, 1, 2, 3), True)
        s, d = divmod(rank, 2)
        assert s_d["spatial"][:2] == (2, s) and s_d["data"][:2] == (2, d) and s_d["joint"][:3] == (4, rank, (0, 1, 2, 3))
        assert s4["spatial"] == (4, rank, (0, 1, 2, 3), True) and s4["joint"] == s4["spatial"]
        assert s4["data"] == (1, 0, (), False)  # an axis the mesh does not have


def _check_step(results, step_case):
    want = step_case["want"]
    for r in results:
        assert r["loss"] == pytest.approx(step_case["loss"], rel=1e-4)
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(r["state"][k], v, atol=5e-5, err_msg=k)
    for k in want:
        np.testing.assert_array_equal(results[0]["state"][k], results[-1]["state"][k], err_msg=k)


def test_depth6_step_on_data_x_spatial_equals_jax(four, step_case):
    _check_step([four[r][2] for r in range(4)], step_case)
    assert [four[r][2]["layout"][:2] for r in range(4)] == [(0, 96), (96, 192)] * 2
    assert four[0][2]["layout"][2] == (96, 96, 96, 96)


def test_sharded_fullres_equals_jax(four, fullres_case):
    got = four[0][3]
    np.testing.assert_array_equal(got["labels"], fullres_case["labels"])
    np.testing.assert_allclose(got["heats"], fullres_case["heats"], atol=1e-5)
    for r in range(1, 4):
        np.testing.assert_array_equal(four[r][3]["labels"], got["labels"])
        assert all(b[1] is None for b in four[r][3]["batches"])


def test_sharded_fullres_ensemble_batches_equal_one_process(four, fullres_case):
    nets = []
    for sd in fullres_case["sds"]:
        m = UNet(**FULLRES_FLAGS)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        nets.append(m.eval())
    projs, rots = fullres_case["projs"], fullres_case["rots"]
    want = list(fullres_batches(lambda i0, i1: (projs[i0:i1], rots[i0:i1]), 2, (148, 148), nets, 2, num_lands=4,
                                batch_size=2, pad_img_dim=28))
    got = four[0][3]["batches"]
    assert [b[0] for b in got] == [b[0] for b in want] == [0]
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_allclose(got[0][2], want[0][2], atol=1e-5)


def test_sharded_fullres_refusals():
    with pytest.raises(NotImplementedError, match="--int8 under the spatial axis"):
        from deepfluoro_tpu_torch.data.preprocess import make_quantized_fullres_infer

        make_quantized_fullres_infer(None, 2, 28, (148, 148), torch.ones(1, 148, 148), torch.zeros(1, dtype=bool),
                                     mesh=make_mesh())
    with pytest.raises(NotImplementedError, match="--int8 under the spatial axis"):
        fullres_batches(None, 1, (148, 148), [UNet(**FULLRES_FLAGS)], 2, batch_size=1, pad_img_dim=28, quantized=True,
                        mesh=make_mesh())


# ----- the two-rank spawn: a depth-6 step, uneven bands, fit --------------------

@pytest.fixture(scope="module")
def uneven_case():
    rng = np.random.default_rng(3)
    model = UNet(**UNEVEN_FLAGS)
    sd = _np(model.state_dict())
    proj = rng.standard_normal((2, 1, 40, 40)).astype(np.float32)
    seg = np.ascontiguousarray(np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 36, 36))].transpose(0, 3, 1, 2))
    heats = rng.random((2, 4, 36, 36)).astype(np.float32)
    ones = {}
    for mode in UNEVEN_MODES:
        m = UNet(**dict(UNEVEN_FLAGS, **UNEVEN_MODES[mode]))
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        cfg = TrainConfig(**UNEVEN_CFG)
        prepared = {"proj": torch.from_numpy(proj), "seg": torch.from_numpy(seg), "heats": torch.from_numpy(heats)}
        loss = update_step(m, make_optimizer(cfg, m.parameters()), cfg, prepared, 0.1)
        ones[mode] = {"loss": float(loss), "state": _np(m.state_dict())}
    return {"sd": sd, "batch": (proj, seg, heats), "one": ones}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("spatial") / "ds.h5"), num_specimens=2, num_projs=4,
                                   img_dim=32, seed=1)


@pytest.fixture(scope="module")
def fit_case(tmp_path_factory, archive):
    """One JAX epoch writes a checkpoint; JAX ``fit`` on a {'spatial': 2}
    mesh of two virtual devices resumes a copy of it for two epochs."""
    d = tmp_path_factory.mktemp("spatial_fit")
    first = _files(d, "first")
    jax_fit(archive, [1, 2], JaxTrainConfig(**FIT_RECIPE), verbose=False, **first)
    jx, port = _files(d, "jax"), _files(d, "port")
    for files in (jx, port):
        shutil.copy(first["checkpoint_filename"], files["checkpoint_filename"])
    mesh = jax_make_mesh({"spatial": 2}, devices=jax.devices()[:2])
    jax_fit(archive, [1, 2], JaxTrainConfig(**dict(FIT_RECIPE, max_num_epochs=3)), verbose=False, mesh=mesh,
            shard_spatial=True, **jx)
    return {"jax": jx, "port": port}


@pytest.fixture(scope="module")
def two(step_case, uneven_case, fit_case, archive):
    proj, seg, heats = step_case["batch"]
    u_proj, u_seg, u_heats = uneven_case["batch"]
    calls = [("spatial_step", (STEP_FLAGS, STEP_CFG, step_case["sd"], proj, seg, heats, 0.1, {"spatial": 2}))]
    for mode in UNEVEN_MODES:
        calls.append(("spatial_step", (dict(UNEVEN_FLAGS, **UNEVEN_MODES[mode]), UNEVEN_CFG, uneven_case["sd"], u_proj,
                                       u_seg, u_heats, 0.1, {"spatial": 2})))
    calls.append(("spatial_fits", ([{"source": archive, "pats": [1, 2], "axes": {"spatial": 2},
                                     "cfg_kw": dict(FIT_RECIPE, max_num_epochs=3), "files": fit_case["port"]}],)))
    return run_ranks(ranks.run_all, 2, args=(calls,), device="cpu", timeout=600)


def test_depth6_step_on_spatial_equals_jax(two, step_case):
    _check_step([two[r][0] for r in range(2)], step_case)


@pytest.mark.parametrize("i,mode", [(1, "zeros"), (2, "circular"), (3, "zeros-remat"), (4, "zeros-bf16-remat")])
def test_uneven_bands_equal_one_process(two, uneven_case, i, mode):
    one = uneven_case["one"][mode]
    assert [two[r][i]["layout"][:2] for r in range(2)] == [(0, 24), (24, 40)]
    # bfloat16: the synchronized BatchNorm and cuDNN's round at other
    # points; the bf16 fit tolerance, and a step of LR 0.1 on it
    loss_rel, atol = (5e-3, 5e-3) if "bf16" in mode else (1e-6, 1e-6)
    for r in range(2):
        assert two[r][i]["loss"] == pytest.approx(one["loss"], rel=loss_rel)
        for k, v in one["state"].items():
            np.testing.assert_allclose(two[r][i]["state"][k], v, rtol=0, atol=atol, err_msg=k)


def test_circular_differs_from_zeros(uneven_case):
    """The two pad modes are different functions, so the circular case
    checks its wrap-around exchange."""
    assert uneven_case["one"]["zeros"]["loss"] != uneven_case["one"]["circular"]["loss"]


def test_fit_shard_spatial_resumed_from_jax_tracks_jax_fit_on_a_spatial_mesh(two, fit_case):
    got = two[0][5][0]
    jx = fit_case["jax"]
    assert got["epoch"] == 3
    np.testing.assert_allclose(got["train_losses"], read_floats_from_txt(jx["train_loss_txt"]), rtol=1e-4)
    np.testing.assert_allclose(got["valid_losses"], read_floats_from_txt(jx["valid_loss_txt"]), rtol=1e-3)
    np.testing.assert_allclose(read_floats_from_txt(fit_case["port"]["train_loss_txt"]), got["train_losses"], rtol=1e-6)
    for k, v in got["state"].items():
        np.testing.assert_array_equal(two[1][5][0]["state"][k], v, err_msg=k)


def test_fit_refuses_what_the_bands_cannot_take(tmp_path):
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data

    data = make_synthetic_data(num_specimens=1, num_projs=2, img_dim=32, seed=0)
    with pytest.raises(ValueError, match="'data' and 'spatial' axes only"):
        fit(data, [1], TrainConfig(**FIT_RECIPE), device="cpu", verbose=False, mesh=make_mesh({"ensemble": 1}),
            **_files(tmp_path, "e"))
    model = UNet(**dict(UNEVEN_FLAGS, padding=False))
    from deepfluoro_tpu_torch.parallel.sharding import shard_rows

    shard = RowShard(Axis(2, 0, None, (0, 1)), Axis(2, 0, None, (0, 1)), 0, 16, 40, (16, 24))
    with pytest.raises(ValueError, match="padded convolutions"):
        shard_rows(model, shard)
    with pytest.raises(ValueError, match="up_mode 'upconv'"):
        shard_rows(UNet(**dict(UNEVEN_FLAGS, up_mode="upsample")), shard)


# ----- the CLI ---------------------------------------------------------------------

def test_cli_spatial_devices_equal_one_process(tmp_path, archive):
    common = [archive, "--train-pats", "1,2", "--num-classes", "7", "--unet-img-dim", "36", "--unet-num-lvls", "2",
              "--unet-init-feats-exp", "2", "--batch-size", "2", "--max-num-epochs", "1", "--unet-batch-norm",
              "--unet-padding", "--unet-no-max-pool", "--use-lands", "--train-valid-split", "0.75", "--no-gpu",
              "--init-lr", "0.1", "--nesterov", "--data-aug"]
    out = {}
    for tag, extra in (("one", []), ("sp", ["--spatial-devices", "2"])):
        files = _files(tmp_path, tag)
        cli_train.main(common + extra + ["--checkpoint-net", files["checkpoint_filename"], "--best-net",
                                         files["best_valid_filename"], "--train-loss-txt", files["train_loss_txt"],
                                         "--valid-loss-txt", files["valid_loss_txt"]])
        out[tag] = read_floats_from_txt(files["train_loss_txt"])
    assert len(out["sp"]) == len(out["one"]) > 0
    np.testing.assert_allclose(out["sp"], out["one"], rtol=1e-5)


@pytest.mark.parametrize("flags,match", [(["--tp-devices", "2"], "not ported"),
                                         (["--tp-devices", "2", "--spatial-devices", "2"], "nor does it compose"),
                                         (["--spatial-devices", "0"], "at least 1")])
def test_cli_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        cli_train.main(["x.h5", "--train-pats", "1", "--num-classes", "7", "--no-gpu"] + flags)
