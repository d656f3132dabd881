"""The port's leave-one-specimen-out fold training (``train/multifold.py``,
``cli/train_folds.py``) against the JAX package's ``fit_multifold``: the
index streams and fold splits bit for bit, then the lockstep trainer from
the JAX initial weights (carried by ``compat.fold_state_dict_from_jax``),
resume, light best nets, the ensemble loaders and the CLI. Depth-2 nets on
32^2 frames of 3 specimens, on the CPU.

Tolerance: from the same weights and batches (augmentation off) the two
trainers differ only by float32 summation order; per-fold validation
losses after an epoch agree within 1e-3 relative, the first step's
per-fold train losses within 1e-4."""

import os
import signal

import numpy as np
import jax
import pytest
import torch

from deepfluoro_tpu.data.hdf5 import split_indices as jax_split_indices
from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint as jax_load_net
from deepfluoro_tpu.train import multifold as jmf
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import _padded_dim
from deepfluoro_tpu_torch.cli import train_folds as cli_folds
from deepfluoro_tpu_torch.compat import fold_state_dict_from_jax, state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, write_synthetic_dataset
from deepfluoro_tpu_torch.data.hdf5 import split_indices
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.train import TrainConfig, build_model, load_checkpoint
from deepfluoro_tpu_torch.train import multifold as tmf
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

RECIPE = dict(
    num_classes=7, batch_size=3, proj_unet_dim=36, depth=2, init_feats_exp=2, batch_norm=True, padding=True,
    no_max_pool=True, num_lands=14, optim_type="sgd", init_lr=0.05, momentum=0.9, nesterov=True, wgt_decay=1e-4,
    data_aug=False, seed=0, train_valid_split=0.8, lr_sched_meth="plateau", max_num_epochs=1, checkpoint_freq=1,
)
PATS = [1, 2, 3]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Under pytest-xdist several worker processes run test files at once;
    torch's OpenMP threads in each then spin against the others', and the
    many small operations of these tiny nets ran ten times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    return TrainConfig(**dict(RECIPE, **kw))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("folds") / "ds.h5"), num_specimens=3, num_projs=6,
                                   img_dim=32, seed=1)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_data(num_specimens=3, num_projs=6, img_dim=32, seed=1)


def _prefixes(tmp_path, tag):
    return dict(checkpoint_prefix=str(tmp_path / (tag + "_ck")), best_prefix=str(tmp_path / (tag + "_best")))


@pytest.mark.parametrize("n,seed,draws", [(10, 101, [3, 3, 3, 3, 7]), (24, 7, [5, 11, 30]), (3, 0, [2, 2, 2, 5])])
def test_fold_stream_equals_jax(n, seed, draws):
    idx = np.arange(40, 40 + n)
    ours, theirs = tmf._FoldStream(idx, seed), jmf._FoldStream(idx, seed)
    for d in draws:
        np.testing.assert_array_equal(ours.take(d), theirs.take(d))


@pytest.mark.parametrize("n,split,seed", [(12, 0.8, 0), (35, 0.85, 4), (30, 0.85, 5)])
def test_split_pool_equals_jax(n, split, seed):
    pool = np.concatenate([np.arange(0, n // 2), np.arange(n, n + n - n // 2)])
    for a, b in zip(tmf._split_pool(pool, split, seed), jmf._split_pool(pool, split, seed)):
        np.testing.assert_array_equal(a, b)
    assert split_indices(n, split, seed) == jax_split_indices(n, split, seed)


def test_fold_carrier_equals_fold_state():
    jcfg = JaxTrainConfig(**RECIPE)
    _, stacked = jmf.make_multifold_state(jcfg, 3, jax.random.PRNGKey(0), (36, 36))
    model = build_model(_cfg())
    for k in (0, 2):
        st = jmf.fold_state(stacked, k)
        want = state_dict_from_jax(jax.device_get(st.params), jax.device_get(st.batch_stats), model)
        got = fold_state_dict_from_jax(stacked.params, stacked.batch_stats, k, model)
        assert list(got) == list(want)
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_fit_multifold_against_jax(tmp_path, archive, data):
    """JAX's initial fold weights and splits go into epoch-0 port fold
    checkpoints (no optimizer state); the port resumes them for one epoch
    while the JAX fit_multifold runs one fresh epoch."""
    jcfg = JaxTrainConfig(**RECIPE)
    pad = _padded_dim(32, jcfg.proj_unet_dim)
    _, stacked = jmf.make_multifold_state(jcfg, len(PATS), jax.random.PRNGKey(jcfg.seed), (pad, pad))
    cfg = _cfg()
    models = [build_model(cfg) for _ in PATS]
    for k, m in enumerate(models):
        m.load_state_dict(fold_state_dict_from_jax(stacked.params, stacked.batch_stats, k, m))
    offsets = [0, 6, 12, 18]
    splits = [jmf._split_pool(np.concatenate([np.arange(offsets[j], offsets[j + 1]) for j in range(3) if j != k]),
                              cfg.train_valid_split, cfg.seed + k) for k in range(3)]
    port = _prefixes(tmp_path, "port")
    ck_paths = ["{}_spec{:02d}.pt".format(port["checkpoint_prefix"], p) for p in PATS]
    tmf.save_fold_checkpoints(cfg, models, ck_paths, train_idx=[t for t, _ in splits], valid_idx=[v for _, v in splits])
    assert not load_checkpoint(ck_paths[0])["optimizer-state-dict"]

    out = tmf.fit_multifold(data, PATS, cfg, train_loss_txt_prefix=str(tmp_path / "ptl"), verbose=False,
                            device="cpu", **port)
    jout = jmf.fit_multifold(archive, PATS, jcfg, train_loss_txt_prefix=str(tmp_path / "jtl"), verbose=False,
                             **_prefixes(tmp_path, "jax"))
    assert out["epoch"] == jout["epoch"] == 1
    for k in range(3):
        np.testing.assert_array_equal(out["train_idx"][k], splits[k][0])
        assert list(load_checkpoint(ck_paths[k])["valid-idx"]) == [int(i) for i in splits[k][1]]
    np.testing.assert_allclose(out["best_valid_losses"], jout["best_valid_losses"], rtol=1e-3)
    np.testing.assert_allclose(out["valid_losses"][0], jout["best_valid_losses"], rtol=1e-3)
    for k, p in enumerate(PATS):
        ours = read_floats_from_txt("{}_spec{:02d}.txt".format(tmp_path / "ptl", p))
        theirs = read_floats_from_txt("{}_spec{:02d}.txt".format(tmp_path / "jtl", p))
        assert len(ours) == len(theirs) == 4  # ceil(10 training rows / batch 3)
        assert ours[0] == pytest.approx(theirs[0], rel=1e-4)
        np.testing.assert_allclose(ours, theirs, rtol=1e-3)


def test_resume_reuses_the_splits_and_appends_the_logs(tmp_path, data):
    pre = _prefixes(tmp_path, "r")
    vl = str(tmp_path / "vl")
    out = tmf.fit_multifold(data, PATS, _cfg(data_aug=True), valid_loss_txt_prefix=vl, verbose=False, device="cpu",
                            **pre)
    assert out["epoch"] == 1 and len(out["train_losses"]) == 4
    first = load_checkpoint(pre["checkpoint_prefix"] + "_spec01.pt")
    assert all(i >= 6 for i in first["train-idx"] + first["valid-idx"])  # specimen 1 is rows 0-5
    out2 = tmf.fit_multifold(data, PATS, _cfg(max_num_epochs=3, init_feats_exp=3), valid_loss_txt_prefix=vl,
                             verbose=False, device="cpu", **pre)
    assert out2["epoch"] == 3 and out2["cfg"].init_feats_exp == 2 and len(out2["train_losses"]) == 8
    again = load_checkpoint(pre["checkpoint_prefix"] + "_spec01.pt")
    assert again["epoch"] == 3 and again["train-idx"] == first["train-idx"]
    assert len(read_floats_from_txt(vl + "_spec01.txt")) == 3
    assert all(next(m.parameters()).device.type == "cpu" for m in out2["models"])


def test_partial_set_and_reordered_pats_refused(tmp_path, data):
    pre = _prefixes(tmp_path, "p")
    tmf.fit_multifold(data, PATS, _cfg(), verbose=False, device="cpu", **pre)
    with pytest.raises(AssertionError, match="pool"):
        tmf.fit_multifold(data, [2, 1, 3], _cfg(max_num_epochs=2), verbose=False, device="cpu",
                          checkpoint_prefix=pre["checkpoint_prefix"], best_prefix=str(tmp_path / "b2"))
    os.remove(pre["checkpoint_prefix"] + "_spec02.pt")
    with pytest.raises(RuntimeError, match="partial"):
        tmf.fit_multifold(data, PATS, _cfg(max_num_epochs=2), verbose=False, device="cpu", **pre)


def test_light_best_nets(tmp_path, data):
    pre = _prefixes(tmp_path, "l")
    tmf.fit_multifold(data, PATS, _cfg(light_best_nets=True), verbose=False, device="cpu", **pre)
    for p in PATS:
        full = pre["checkpoint_prefix"] + "_spec{:02d}.pt".format(p)
        light = pre["best_prefix"] + "_spec{:02d}.pt".format(p)
        assert load_checkpoint(full)["optimizer-state-dict"] and not load_checkpoint(light)["optimizer-state-dict"]
        assert os.path.getsize(light) < 0.75 * os.path.getsize(full)


def test_best_nets_load_in_both_ensembles(tmp_path, data):
    pre = _prefixes(tmp_path, "e")
    out = tmf.fit_multifold(data, PATS, _cfg(), verbose=False, device="cpu", **pre)
    x = torch.randn(1, 1, 36, 36)
    for k, p in enumerate(PATS):
        path = pre["best_prefix"] + "_spec{:02d}.pt".format(p)
        model, cfg = load_net_from_checkpoint(path, device="cpu", verbose=False)
        out["models"][k].eval()
        with torch.no_grad():
            for a, b in zip(model(x), out["models"][k](x)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        jmodel, variables, jcfg = jax_load_net(path, verbose=False)
        assert jcfg.depth == cfg.depth == 2 and jcfg.num_lands == 14
        seg, heats = jmodel.apply(variables, np.transpose(x.numpy(), (0, 2, 3, 1)), train=False)
        with torch.no_grad():
            tseg, theats = model(x)
        np.testing.assert_allclose(np.transpose(np.asarray(seg), (0, 3, 1, 2)), tseg.numpy(), rtol=1e-4, atol=1e-4)


def test_stream_equals_resident(tmp_path, data):
    outs = [tmf.fit_multifold(data, PATS, _cfg(data_aug=True, max_num_epochs=2), stream_data=stream, verbose=False,
                              device="cpu", **_prefixes(tmp_path, str(stream))) for stream in (False, True)]
    np.testing.assert_allclose(np.array(outs[1]["train_losses"]), np.array(outs[0]["train_losses"]), rtol=1e-6)
    np.testing.assert_allclose(np.array(outs[1]["valid_losses"]), np.array(outs[0]["valid_losses"]), rtol=1e-6)


def test_cos_pre_restart_snapshots_per_fold(tmp_path, data):
    prefix = str(tmp_path / "rr")
    out = tmf.fit_multifold(data, PATS, _cfg(lr_sched_meth="cos", lrs_num_epochs=1, lrs_growth_factor=1,
                                             max_num_epochs=2, save_restart_net_prefix=prefix, light_best_nets=True),
                            verbose=False, device="cpu", **_prefixes(tmp_path, "c"))
    assert out["num_restarts"] == 2
    for p in PATS:
        for r in (0, 1):
            path = "{}_spec{:02d}_{:02d}.pt".format(prefix, p, r)
            assert load_checkpoint(path)["epoch"] == r + 1 and not load_checkpoint(path)["optimizer-state-dict"]


def test_dup_lr_flip_mirrors_training_rows_only(tmp_path, archive):
    out = tmf.fit_multifold(archive, PATS, _cfg(dup_lr_flip=True), verbose=False, device="cpu",
                            **_prefixes(tmp_path, "d"))
    for k in range(3):
        t, v = out["train_idx"][k], out["valid_idx"][k]
        assert len(t) == 20 and len(v) == 2
        np.testing.assert_array_equal(t[10:], t[:10] + 18)
        assert v.max() < 18
    assert len(out["train_losses"]) == 7  # ceil(20 / 3)


def test_sigterm_and_max_hours_stop_the_folds(tmp_path, data, monkeypatch):
    real_step = tmf.multifold_step
    calls = []

    def step_then_sigterm(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            assert callable(signal.getsignal(signal.SIGTERM))
            signal.raise_signal(signal.SIGTERM)
        return real_step(*args, **kwargs)

    monkeypatch.setattr(tmf, "multifold_step", step_then_sigterm)
    pre = _prefixes(tmp_path, "s")
    out = tmf.fit_multifold(data, PATS, _cfg(max_num_epochs=5, checkpoint_freq=10), verbose=False, device="cpu", **pre)
    assert out["epoch"] == 1 and load_checkpoint(pre["checkpoint_prefix"] + "_spec03.pt")["epoch"] == 1
    monkeypatch.setattr(tmf, "multifold_step", real_step)
    out = tmf.fit_multifold(data, PATS, _cfg(max_num_epochs=5, max_hours=1e-9), verbose=False, device="cpu",
                            **_prefixes(tmp_path, "h"))
    assert out["epoch"] == 1


def test_train_multifold_folds_diverge(data):
    folds = [data.select_pats([p for p in PATS if p != k]) for k in PATS]
    models, hist = tmf.train_multifold(folds, _cfg(), num_epochs=2, verbose=False, device="cpu")
    assert len(hist) == 2 and hist[-1].shape == (3,) and np.isfinite(hist).all()
    a, b = (next(m.parameters()).detach() for m in models[:2])
    assert not torch.allclose(a, b)


def test_cli_trains_the_folds_on_cpu_and_refuses_without_card(tmp_path, archive, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [archive, "--pats", "1,2,3", "--num-classes", "7", "--init-lr", "0.05", "--unet-batch-norm",
            "--unet-no-max-pool", "--unet-img-dim", "36", "--unet-num-lvls", "2", "--batch-size", "3", "--epochs", "1",
            "--unet-init-feats-exp", "2", "--unet-padding", "--nesterov", "--use-lands", "--train-valid-split", "0.8",
            "--net-prefix", "fold", "--valid-loss-prefix", "vl", "--light-best-nets"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_folds.main(argv)
    cli_folds.main(argv + ["--no-gpu"])
    for p in PATS:
        ck = load_checkpoint("zz_fold_checkpoint_spec{:02d}.pt".format(p))
        assert ck["epoch"] == 1 and ck["num-lands"] == 14 and ck["light-best-nets"] is True
        assert os.path.exists("fold_spec{:02d}.pt".format(p)) and len(read_floats_from_txt("vl_spec{:02d}.txt".format(p))) == 1
    cli_folds.main(argv[:argv.index("--epochs") + 1] + ["2"] + argv[argv.index("--epochs") + 2:] + ["--no-gpu"])
    assert load_checkpoint("zz_fold_checkpoint_spec02.pt")["epoch"] == 2
