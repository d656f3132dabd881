"""The ladder's modes under the parallel axes: data-parallel ``fit`` and
fold-sharded ``fit_multifold`` with ``compute_dtype="bfloat16"`` and
``remat=True`` on two gloo ranks (one torch thread each) against the JAX
package's mesh runs on the conftest's virtual CPU devices, both resumed
from one JAX checkpoint (bf16 and remat: the msgpack file carries both);
and the synchronized BatchNorm under remat, whose recompute inside
backward runs the global statistics again but moves the running
statistics once. Depth-2 nets on 32^2 frames.

Tolerances: ``tests/test_torch_port_bf16_remat.py``'s for bf16 training
(per-step and validation losses within 5e-3 relative: torch's autocast
and XLA round to bfloat16 at other points). The BatchNorm buffers of a
remat step equal the plain step's within 1e-6, and each is updated once
(``num_batches_tracked`` 1)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from deepfluoro_tpu.parallel import make_mesh as jax_make_mesh
from deepfluoro_tpu.train import multifold as jmf
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import fit as jax_fit
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.parallel import run_ranks
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

MODES = dict(compute_dtype="bfloat16", remat=True)
RECIPE = dict(
    num_classes=7, batch_size=4, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=1, **MODES,
)
FOLD_RECIPE = dict(RECIPE, batch_size=3, train_valid_split=0.8)
FLAGS = dict(n_classes=7, depth=2, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test files run at once under pytest-xdist; torch's OpenMP
    threads in each would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(d, tag):
    return {k: os.path.join(str(d), "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX package's first epochs (one process) and its mesh runs
    resumed from them; the port's two ranks resume copies of the same
    files in one spawn."""
    d = tmp_path_factory.mktemp("bf16_parallel")
    archive = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=2, num_projs=8, img_dim=32, seed=2)
    first = _files(d, "first")
    jax_fit(archive, [1, 2], JaxTrainConfig(**RECIPE), verbose=False, **first)
    jx, port = _files(d, "jax"), _files(d, "port")
    for files in (jx, port):
        shutil.copy(first["checkpoint_filename"], files["checkpoint_filename"])
    two = jax.devices()[:2]
    jax_fit(archive, [1, 2], JaxTrainConfig(**dict(RECIPE, max_num_epochs=3)), verbose=False,
            mesh=jax_make_mesh({"data": 2}, devices=two), **jx)

    pats = [1, 2]
    jmf.fit_multifold(archive, pats, JaxTrainConfig(**FOLD_RECIPE), checkpoint_prefix=str(d / "ffirst"),
                      best_prefix=str(d / "ffirst_best"), verbose=False)
    for tag in ("fjax", "fport"):
        for p in pats:
            shutil.copy(str(d / "ffirst_spec{:02d}.pt".format(p)), str(d / "{}_spec{:02d}.pt".format(tag, p)))
    jmf.fit_multifold(archive, pats, JaxTrainConfig(**dict(FOLD_RECIPE, max_num_epochs=2)),
                      checkpoint_prefix=str(d / "fjax"), best_prefix=str(d / "fjax_best"),
                      train_loss_txt_prefix=str(d / "fjax_loss"), mesh=jax_make_mesh({"ensemble": 2}, devices=two),
                      verbose=False)

    model = UNet(**FLAGS)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    x = np.random.default_rng(5).standard_normal((4, 1, 32, 32)).astype(np.float32)
    calls = [
        ("dp_fits", ([{"source": archive, "pats": [1, 2], "cfg_kw": dict(RECIPE, max_num_epochs=3), "files": port}],)),
        ("folds_fit", (archive, pats, dict(FOLD_RECIPE, max_num_epochs=2),
                       {"checkpoint_prefix": str(d / "fport"), "best_prefix": str(d / "fport_best")},
                       str(d / "fport_loss"))),
        ("remat_bn_counts", (FLAGS, sd, x)),
    ]
    got = run_ranks(ranks.run_all, 2, args=(calls,), device="cpu", timeout=600)
    return {"d": d, "jax": jx, "port": port, "ranks": got, "pats": pats}


def test_dp_fit_bf16_remat_tracks_the_jax_mesh_run(case):
    for r in case["ranks"]:
        (got,) = r[0]
        assert got["epoch"] == 3
        np.testing.assert_allclose(got["train_losses"], read_floats_from_txt(case["jax"]["train_loss_txt"]), rtol=5e-3)
        np.testing.assert_allclose(got["valid_losses"], read_floats_from_txt(case["jax"]["valid_loss_txt"]), rtol=5e-3)
    a, b = (r[0][0]["state"] for r in case["ranks"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fold_sharded_bf16_remat_tracks_the_jax_mesh_run(case):
    d = case["d"]
    assert [r[1]["folds"] for r in case["ranks"]] == [[0], [1]]
    for p in case["pats"]:
        want = read_floats_from_txt(str(d / "fjax_loss_spec{:02d}.txt".format(p)))
        got = read_floats_from_txt(str(d / "fport_loss_spec{:02d}.txt".format(p)))
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=5e-3)


def test_checkpoints_keep_bf16_and_remat(case):
    from deepfluoro_tpu_torch.train import load_checkpoint

    ck = load_checkpoint(case["port"]["checkpoint_filename"])
    assert (ck["compute-dtype"], ck["remat"], ck["epoch"]) == ("bfloat16", True, 3)


def test_synchronized_batchnorm_moves_once_under_remat(case):
    for r in case["ranks"]:
        plain, remat = r[2][False], r[2][True]
        assert set(plain) == set(remat)
        for k, v in remat.items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == int(plain[k]) == 1, k
            else:
                np.testing.assert_allclose(v, plain[k], rtol=0, atol=1e-6, err_msg=k)
    a, b = (r[2][True] for r in case["ranks"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
