"""The port's training path (deepfluoro_tpu_torch.train, .data, .cli)
against the JAX package's: three SGD-Nesterov steps from the same bridged
weights on the same batches against JAX grad_and_update (augmentation off,
so both sides see the same inputs; losses within 1e-4 relative, float32
with another summation order in the convolutions and their gradients),
then fit end to end on a tiny archive on the CPU, whose checkpoint the JAX
package's reference-checkpoint importer must read and the port resumes."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepfluoro_tpu.compat.torch_import import import_torch_checkpoint
from deepfluoro_tpu.data import augment as jaug
from deepfluoro_tpu.data.fixtures import write_synthetic_dataset as jax_write_synthetic_dataset
from deepfluoro_tpu.data.hdf5 import load_dataset as jax_load_dataset
from deepfluoro_tpu.train import step as jstep
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.config import build_model as jax_build_model
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data import augment as taug
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, write_synthetic_dataset
from deepfluoro_tpu_torch.data.hdf5 import load_dataset
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit, load_checkpoint, make_optimizer, train_step
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

RECIPE = dict(
    num_classes=7, batch_size=2, proj_unet_dim=48, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=3, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5,
)


def _numpy_variables(model, size, seed):
    """flax variables of ``model`` drawn with numpy (tracing init only)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if path[-1].key in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)

    return (jax.tree_util.tree_map_with_path(draw, shapes["params"]),
            jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"]))


def test_three_steps_match_jax_grad_and_update():
    data = make_synthetic_data(num_specimens=1, num_projs=6, img_dim=40, seed=2)
    jcfg, tcfg = JaxTrainConfig(**RECIPE), TrainConfig(**RECIPE)
    jmodel = jax_build_model(jcfg)
    params, stats = _numpy_variables(jmodel, 48, seed=0)
    tx = jstep.make_optimizer(jcfg)
    state = jstep.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    loss_fn = jstep.make_loss_fn(jcfg, jmodel)
    # one compiled program for the three steps (eager autodiff compiles op by op)
    update = jax.jit(lambda st, *batch: jstep.grad_and_update(loss_fn, tx, st, *batch))
    jaug_cfg = jaug.AugmentConfig(num_classes=7, proj_pad_dim=48, prob_of_aug=0.0)

    model = build_model(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, model))
    optimizer = make_optimizer(tcfg, model.parameters())
    taug_cfg = taug.AugmentConfig(num_classes=7, proj_pad_dim=48, prob_of_aug=0.0)

    for idx in ([0, 1], [2, 3], [4, 5]):
        p, s, l = data.projs[idx], data.segs[idx], data.lands[idx]
        prep = jaug.prepare_batch(jaug_cfg, jax.random.PRNGKey(0), jnp.asarray(p), jnp.asarray(s), jnp.asarray(l))
        state, jloss = update(state, prep["proj"], prep["seg"], prep["heats"], 0.1)
        tloss = train_step(model, optimizer, tcfg, taug_cfg, None, (torch.from_numpy(p), torch.from_numpy(s), torch.from_numpy(l)), 0.1)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-4)


def test_synthetic_data_in_memory_equals_archive(tmp_path):
    kw = dict(num_specimens=2, num_projs=3, img_dim=24, seed=4)
    mem = make_synthetic_data(**kw)
    ours = load_dataset(write_synthetic_dataset(str(tmp_path / "port.h5"), **kw), [1, 2])
    theirs = jax_load_dataset(jax_write_synthetic_dataset(str(tmp_path / "jax.h5"), **kw), [1, 2])
    for a in (ours, theirs):
        np.testing.assert_array_equal(mem.projs, a.projs)
        np.testing.assert_array_equal(mem.segs, a.segs)
        np.testing.assert_array_equal(mem.lands, a.lands)
    np.testing.assert_array_equal(mem.pat_inds, ours.pat_inds)
    np.testing.assert_array_equal(mem.select_pats([2]).projs, mem.projs[3:])


def _tiny_cfg(**kw):
    base = dict(RECIPE, depth=2, proj_unet_dim=36, data_aug=True, lr_sched_meth="plateau", train_valid_split=0.75,
                checkpoint_freq=1, max_num_epochs=2)
    base.update(kw)
    return TrainConfig(**base)


def test_fit_end_to_end_and_jax_reads_the_checkpoint(tmp_path):
    archive = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=2, num_projs=4, img_dim=32, seed=1)
    cfg = _tiny_cfg()
    paths = {k: str(tmp_path / v) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt", valid_loss_txt="valid.txt"
    ).items()}
    out = fit(archive, [1, 2], cfg, verbose=False, device="cpu", **paths)
    n_steps = len(out["train_losses"])
    assert n_steps == 2 * 3  # 6 of 8 frames train, batch 2, 2 epochs
    assert read_floats_from_txt(paths["train_loss_txt"]) == pytest.approx(out["train_losses"], abs=1e-6)
    assert len(read_floats_from_txt(paths["valid_loss_txt"])) == 2
    assert all(np.isfinite(out["train_losses"] + out["valid_losses"]))
    assert os.path.exists(paths["best_valid_filename"])

    ck = load_checkpoint(paths["checkpoint_filename"])
    assert ck["epoch"] == 2 and ck["num-lands"] == 14 and ck["pad-img-size"] == 36
    assert sorted(ck["train-idx"] + ck["valid-idx"]) == list(range(8))

    jcfg, params, stats = import_torch_checkpoint(paths["checkpoint_filename"])
    for field in ("num_classes", "depth", "init_feats_exp", "batch_norm", "no_max_pool", "num_lands", "proj_unet_dim", "init_lr"):
        assert getattr(jcfg, field) == getattr(cfg, field), field
    model = out["model"]
    back = state_dict_from_jax(params, stats, model)
    for k, v in model.state_dict().items():
        if k.startswith("downsample_convs.1.") or k.endswith("num_batches_tracked"):
            continue  # the dead conv (dropped by the importer) and BN's step counts
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)

    # an existing checkpoint resumes: one more epoch, the stored split reused
    resumed = fit(archive, [1, 2], _tiny_cfg(max_num_epochs=3), verbose=False, device="cpu", **paths)
    assert resumed["epoch"] == 3 and len(resumed["train_losses"]) == 3
    assert resumed["train_idx"] == out["train_idx"] == ck["train-idx"]
    assert load_checkpoint(paths["checkpoint_filename"])["epoch"] == 3


def test_checkpoint_meta_matches_the_jax_key_set():
    """The port writes every metadata key of the JAX package, the options it
    has not ported with the JAX defaults, and the JAX config reads them back."""
    meta = _tiny_cfg().to_checkpoint_meta()
    jax_meta = JaxTrainConfig().to_checkpoint_meta()
    assert set(meta) == set(jax_meta)
    for k in ("lrs-save-restart-net-prefix", "lrs-save-after-n-restarts", "light-best-nets", "compute-dtype",
              "remat", "dup-lr-flip"):
        assert meta[k] == jax_meta[k], k
    jcfg = JaxTrainConfig.from_checkpoint_meta(meta)
    assert jcfg.to_checkpoint_meta() == meta


def test_cli_trains_on_cpu_and_refuses_without_card(tmp_path, monkeypatch):
    archive = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=2, num_projs=2, img_dim=24, seed=3)
    monkeypatch.chdir(tmp_path)
    argv = [archive, "--train-pats", "1", "--valid-pats", "2", "--num-classes", "7", "--init-lr", "0.1",
            "--unet-batch-norm", "--unet-no-max-pool", "--unet-img-dim", "28", "--unet-num-lvls", "2",
            "--batch-size", "2", "--max-num-epochs", "1", "--unet-init-feats-exp", "2", "--wgt-decay", "0.0001",
            "--data-aug", "--unet-padding", "--nesterov", "--use-lands", "--lr-sched", "plateau"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_train.main(argv)
    cli_train.main(argv + ["--no-gpu"])
    ck = load_checkpoint("zz_checkpoint.pt")
    assert ck["epoch"] == 1 and ck["num-lands"] == 14 and ck["data-aug"] is True
    assert len(read_floats_from_txt("train_iter_loss.txt")) == 1
