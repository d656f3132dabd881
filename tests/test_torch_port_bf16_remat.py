"""bfloat16 compute and per-block rematerialization in the port
(models/unet.py ``dtype``/``remat``, TrainConfig ``compute_dtype``/
``remat``, ``fit``, the training CLIs and the inference loader) against
the JAX package's, on the CPU.

Tolerances, measured on these nets: a bf16 forward of the port and of the
JAX package differ by up to 0.8e-2 (softmax) and 0.8 % of the largest
heatmap value, as much as either differs from float32 (1.0e-2, 0.8 %):
the two round to bfloat16 at other points (torch's autocast rounds each
convolution's output, XLA each op's), so the tests allow 2e-2 and 2 %.
bf16 training losses of the two packages from one checkpoint differ by up
to 5.3e-4 relative over two epochs (the tests allow 5e-3); remat ones by
8.2e-7. Remat recomputes the same float32 ops: the
port's remat and plain steps agree to 1e-6 (losses) and 1e-5 (gradients)
with equal BatchNorm buffers, and its remat ``fit`` follows the JAX remat
``fit`` within 1e-4, as the float32 ``fit`` does."""

import contextlib
import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluoro_tpu.models import UNet as JaxUNet
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import fit as jax_fit
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.cli import train_folds as cli_folds
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.models.unet import BatchNorm2d
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit, load_checkpoint, save_checkpoint
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

BF16_ATOL = 2e-2
FLAGS = dict(n_classes=7, depth=3, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=14)
RECIPE = dict(
    num_classes=7, batch_size=2, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=1,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(size=36, seed=0):
    """FLAGS' flax net and numpy variables drawn from a seed: kernels
    ~ N(0, 1/fan_in), biases and BN affine ~ N(0, 0.1), running variances
    in [0.5, 1.5)."""
    model = JaxUNet(**FLAGS)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return model, {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"]),
                   "batch_stats": jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])}


def _port(variables, **kw):
    model = UNet(**FLAGS, **kw)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], model))
    return model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_forward_matches_jax_bf16(train):
    """Float32 outputs from bfloat16 compute, float32 weights and
    statistics; each package's bf16 forward against the other's, and the
    port's against its float32 forward within the same bound."""
    jmodel, variables = _jax_variables()
    x = np.random.default_rng(1).standard_normal((2, 36, 36, 1)).astype(np.float32)
    jbf = jmodel.clone(dtype=jnp.bfloat16)
    if train:
        want, _ = jbf.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jbf.apply(variables, jnp.asarray(x), train=False)
    model = _port(variables, dtype=torch.bfloat16).train(train)
    plain = _port(variables).train(train)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got, ref = model(xt), plain(xt)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())
    for g, w, r in zip(got, want, ref):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.dtype == torch.float32
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=BF16_ATOL * scale)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=BF16_ATOL * scale)
        assert float((g - r).abs().max()) > 0  # bfloat16 did run


def _step(model, x):
    """One train-mode forward and backward of a fixed loss: (loss,
    gradients, state_dict)."""
    model.train()
    seg, heats = model(x)
    loss = (seg[:, 1:] ** 2).mean() + heats.square().mean()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_remat_step_equals_plain_step(dtype):
    """Remat against no remat from the same weights: the loss, every
    gradient and every BatchNorm buffer. The recompute inside backward runs
    BatchNorm's train-mode forward again; without the guard the running
    statistics move twice and num_batches_tracked reaches 2."""
    torch.manual_seed(0)
    base = UNet(**FLAGS, dtype=dtype)
    x = torch.randn(2, 1, 36, 36)
    plain = _step(copy.deepcopy(base), x)
    remat_model = copy.deepcopy(base)
    remat_model.remat = True
    remat = _step(remat_model, x)
    assert remat[0] == pytest.approx(plain[0], rel=1e-6)
    assert remat[1].keys() == plain[1].keys()
    for k in plain[1]:
        torch.testing.assert_close(remat[1][k], plain[1][k], rtol=1e-5, atol=1e-5, msg=k)
    for k in plain[2]:
        assert torch.equal(remat[2][k], plain[2][k]), k
    assert int(remat[2]["down_path.0.block.2.num_batches_tracked"]) == 1

    unguarded = copy.deepcopy(base)
    unguarded.remat = True
    unguarded._recomputing = contextlib.nullcontext
    moved = _step(unguarded, x)[2]
    assert int(moved["down_path.0.block.2.num_batches_tracked"]) == 2
    assert not torch.equal(moved["down_path.0.block.2.running_mean"], plain[2]["down_path.0.block.2.running_mean"])


def test_remat_forward_matches_jax_remat():
    """A train-mode forward of the remat nets: outputs and running
    statistics as flax's nn.remat net gives them."""
    jmodel, variables = _jax_variables(seed=3)
    x = np.random.default_rng(2).standard_normal((2, 36, 36, 1)).astype(np.float32)
    want, mutated = jmodel.clone(remat=True).apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = _port(variables, remat=True).train()
    got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=1e-4)
    sum(o.sum() for o in got).backward()
    stats = state_dict_from_jax(variables["params"], jax.tree.map(np.asarray, mutated["batch_stats"]), model)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), atol=1e-5, err_msg=k)
    assert not any(m.recomputing for m in model.modules() if isinstance(m, BatchNorm2d))


def test_meta_round_trips_with_the_jax_config():
    cfg = TrainConfig(**RECIPE, compute_dtype="bfloat16", remat=True)
    jcfg = JaxTrainConfig(**RECIPE, compute_dtype="bfloat16", remat=True)
    assert cfg.to_checkpoint_meta() == jcfg.to_checkpoint_meta()
    assert list(cfg.to_checkpoint_meta()) == list(jcfg.to_checkpoint_meta())
    back = TrainConfig.from_checkpoint_meta(jcfg.to_checkpoint_meta())
    assert (back.compute_dtype, back.remat, back.dtype) == ("bfloat16", True, torch.bfloat16)
    jback = JaxTrainConfig.from_checkpoint_meta(cfg.to_checkpoint_meta())
    assert (jback.compute_dtype, jback.remat, jback.dtype) == ("bfloat16", True, jnp.bfloat16)
    model = build_model(back)
    assert model.dtype == torch.bfloat16 and model.remat
    with pytest.raises(ValueError, match="compute_dtype"):
        TrainConfig(compute_dtype="float16").dtype


def _files(tmp_path, tag):
    return {k: str(tmp_path / "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("bf16") / "ds.h5"), num_specimens=2, num_projs=4,
                                   img_dim=32, seed=1)


@pytest.mark.parametrize("mode,rtol", [(dict(compute_dtype="bfloat16"), 5e-3), (dict(remat=True), 1e-4)],
                         ids=["bf16", "remat"])
def test_fit_against_jax_fit(tmp_path, archive, mode, rtol):
    """One port epoch in the mode writes a checkpoint that asks for it; the
    JAX fit and the port fit each resume a copy for two more epochs in that
    mode, augmentation off; per-step train and validation losses agree."""
    first = _files(tmp_path, "first")
    fit(archive, [1, 2], TrainConfig(**RECIPE, **mode), verbose=False, device="cpu", **first)
    ck = load_checkpoint(first["checkpoint_filename"])
    assert (ck["compute-dtype"], ck["remat"]) == (mode.get("compute_dtype", "float32"), mode.get("remat", False))
    port, jx = _files(tmp_path, "port"), _files(tmp_path, "jax")
    for f in (port, jx):
        shutil.copyfile(first["checkpoint_filename"], f["checkpoint_filename"])
    # the base configs are float32 without remat: the checkpoint's meta decides
    out = fit(archive, [1, 2], TrainConfig(**dict(RECIPE, max_num_epochs=3)), verbose=False, device="cpu", **port)
    jout = jax_fit(archive, [1, 2], JaxTrainConfig(**dict(RECIPE, max_num_epochs=3)), verbose=False, **jx)
    assert out["cfg"].compute_dtype == jout["cfg"].compute_dtype == ck["compute-dtype"]
    assert out["cfg"].remat == jout["cfg"].remat == ck["remat"]
    assert out["model"].dtype == out["cfg"].dtype and out["model"].remat == ck["remat"]
    assert all(p.dtype == torch.float32 for p in out["model"].parameters())
    jax_train = read_floats_from_txt(jx["train_loss_txt"])
    assert len(jax_train) == len(out["train_losses"]) == 6
    np.testing.assert_allclose(out["train_losses"], jax_train, rtol=rtol)
    np.testing.assert_allclose(out["valid_losses"], read_floats_from_txt(jx["valid_loss_txt"]), rtol=rtol)
    saved = load_checkpoint(port["checkpoint_filename"])
    assert (saved["compute-dtype"], saved["remat"]) == (ck["compute-dtype"], ck["remat"])


def test_bf16_checkpoint_loads_for_inference_in_bf16(tmp_path):
    cfg = TrainConfig(num_classes=7, depth=2, init_feats_exp=2, padding=True, batch_norm=True, num_lands=14,
                      proj_unet_dim=36, compute_dtype="bfloat16", remat=True)
    torch.manual_seed(1)
    path = str(tmp_path / "bf16.pt")
    save_checkpoint(path, cfg, build_model(cfg))
    model, loaded = load_net_from_checkpoint(path, device="cpu", verbose=False)
    assert loaded.compute_dtype == "bfloat16" and model.dtype == torch.bfloat16 and not model.training
    x = torch.randn(1, 1, 36, 36)
    with torch.no_grad():
        seg, heats = model(x)
        plain = copy.deepcopy(model)
        plain.dtype = torch.float32
        ref = plain(x)
    assert seg.dtype == heats.dtype == torch.float32
    assert 0 < float((seg - ref[0]).abs().max()) < BF16_ATOL


def test_training_clis_take_bf16_and_remat(tmp_path, monkeypatch):
    archive = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=3, num_projs=4, img_dim=24, seed=3)
    monkeypatch.chdir(tmp_path)
    common = ["--num-classes", "7", "--init-lr", "0.1", "--unet-batch-norm", "--unet-no-max-pool", "--unet-img-dim",
              "28", "--unet-num-lvls", "2", "--batch-size", "2", "--unet-init-feats-exp", "2", "--unet-padding",
              "--nesterov", "--use-lands", "--train-valid-split", "0.75", "--bf16", "--remat", "--no-gpu"]
    argv = [archive, "--train-pats", "1,2", "--max-num-epochs", "1", "--stream-data"] + common
    args = cli_train.build_parser().parse_args(argv)
    assert args.bf16 and args.remat
    cli_train.main(argv)
    ck = load_checkpoint("zz_checkpoint.pt")
    assert (ck["compute-dtype"], ck["remat"], ck["epoch"]) == ("bfloat16", True, 1)
    no_flags = [a for a in argv if a not in ("--bf16", "--remat")]
    no_flags[no_flags.index("--max-num-epochs") + 1] = "2"
    cli_train.main(no_flags)  # the resumed run keeps the checkpoint's modes
    ck = load_checkpoint("zz_checkpoint.pt")
    assert (ck["compute-dtype"], ck["remat"], ck["epoch"]) == ("bfloat16", True, 2)
    assert not cli_train.build_parser().parse_args(no_flags).bf16

    cli_folds.main([archive, "--pats", "1,2,3", "--epochs", "1", "--net-prefix", "fold"] + common)
    for p in (1, 2, 3):
        ck = load_checkpoint("zz_fold_checkpoint_spec{:02d}.pt".format(p))
        assert (ck["compute-dtype"], ck["remat"]) == ("bfloat16", True)
    assert np.isfinite(read_floats_from_txt("train_iter_loss.txt")).all()
