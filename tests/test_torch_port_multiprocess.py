"""Data-parallel ``fit`` and fold-sharded ``fit_multifold`` of the port
over two gloo ranks on the CPU (one torch thread each), against the JAX
package's mesh runs on the conftest's forced CPU devices and against the
port's one process; the per-process streaming feed; the parallel CLIs.
Depth-2 nets on 32^2 frames.

Tolerances: from the same checkpoint and batches (augmentation off), the
2-rank ``fit`` and the JAX ``fit`` on a {'data': 2} mesh differ by the
order of float32 sums in convolutions and reductions: per-step train
losses within 1e-4 relative, validation losses within 1e-3 (as the
one-process resume test). Against the port's one process, with
augmentation on (each rank takes its rows of the same draws), the ranks
differ only by how the batch's sums split: per-step losses within 1e-5
relative. The streamed feed reads the same rows: equal to the resident
feed within 1e-6. Fold-sharded against JAX's 'ensemble' mesh, every fold
within 1e-3 relative (the first step's train loss 1e-4)."""

import os
import shutil

import numpy as np
import jax
import pytest
import torch

import torch_port_ranks as ranks
from deepfluoro_tpu.parallel import make_mesh as jax_make_mesh
from deepfluoro_tpu.train import multifold as jmf
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import _padded_dim
from deepfluoro_tpu.train.loop import fit as jax_fit
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.cli import train_folds as cli_folds
from deepfluoro_tpu_torch.compat import fold_state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.parallel import local_batch_slice, run_ranks
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit, load_checkpoint
from deepfluoro_tpu_torch.train import multifold as tmf
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

RECIPE = dict(
    num_classes=7, batch_size=4, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.8, checkpoint_freq=1, max_num_epochs=1,
)
PATS = [1, 2, 3]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test files run at once under pytest-xdist; torch's OpenMP
    threads in each would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(d, tag):
    return {k: str(d / "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """3 specimens of 5 frames: 12 training frames (3 global batches of 4,
    2 per rank) and 3 validation frames (one batch, padded to 4). One
    port epoch (augmentation off) writes a checkpoint that the JAX fit on
    a {'data': 2} mesh and the 2-rank fit each resume for a second epoch;
    then 2 fresh epochs with augmentation on, on 2 ranks resident and
    streamed and on one process."""
    d = tmp_path_factory.mktemp("dp")
    archive = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=3, num_projs=5, img_dim=32, seed=1)
    first = _files(d, "first")
    fit(archive, PATS, TrainConfig(**RECIPE), verbose=False, device="cpu", **first)
    jx, two = _files(d, "jax"), _files(d, "two")
    for f in (jx, two):
        shutil.copyfile(first["checkpoint_filename"], f["checkpoint_filename"])
    for key in ("train_loss_txt", "valid_loss_txt"):
        shutil.copyfile(first[key], two[key])
    jout = jax_fit(archive, PATS, JaxTrainConfig(**dict(RECIPE, max_num_epochs=2)), verbose=False,
                   mesh=jax_make_mesh({"data": 2}, devices=jax.devices()[:2]), **jx)

    aug = dict(RECIPE, data_aug=True, max_num_epochs=2)
    runs = [
        dict(source=archive, pats=PATS, cfg_kw=dict(RECIPE, max_num_epochs=2), files=two),
        dict(source=archive, pats=PATS, cfg_kw=aug, files=_files(d, "aug")),
        dict(source=archive, pats=PATS, cfg_kw=aug, files=_files(d, "stream"), stream_data=True),
    ]
    ranked = run_ranks(ranks.dp_fits, 2, args=(runs,), device="cpu", timeout=300)
    one = fit(archive, PATS, TrainConfig(**aug), verbose=False, device="cpu", **_files(d, "one"))
    return dict(d=d, first=first, jax=jx, jout=jout, two=two, ranked=ranked, one=one)


def test_dp_fit_resumes_a_one_process_checkpoint_and_matches_the_jax_mesh(dp):
    resumed = [r[0] for r in dp["ranked"]]
    first = load_checkpoint(dp["first"]["checkpoint_filename"])
    for r in resumed:
        assert r["epoch"] == dp["jout"]["epoch"] == 2
        assert r["train_idx"] == first["train-idx"] == list(dp["jout"]["train_idx"])
        assert r["train_losses"] == resumed[0]["train_losses"] and r["valid_losses"] == resumed[0]["valid_losses"]
    jax_train = read_floats_from_txt(dp["jax"]["train_loss_txt"])
    assert len(jax_train) == len(resumed[0]["train_losses"]) == 3
    np.testing.assert_allclose(resumed[0]["train_losses"], jax_train, rtol=1e-4)
    np.testing.assert_allclose(resumed[0]["valid_losses"], read_floats_from_txt(dp["jax"]["valid_loss_txt"]),
                               rtol=1e-3)
    # process 0 appended to the one-process logs and wrote the checkpoint
    assert len(read_floats_from_txt(dp["two"]["train_loss_txt"])) == 6
    ck = load_checkpoint(dp["two"]["checkpoint_filename"])
    assert ck["epoch"] == 2 and ck["train-idx"] == first["train-idx"]
    for k, v in ck["model-state-dict"].items():
        np.testing.assert_array_equal(v.numpy(), resumed[0]["state"][k], err_msg=k)


def test_dp_fit_with_augmentation_equals_one_process(dp):
    aug = [r[1] for r in dp["ranked"]]
    assert len(aug[0]["train_losses"]) == len(dp["one"]["train_losses"]) == 6
    for r in aug:
        np.testing.assert_allclose(r["train_losses"], dp["one"]["train_losses"], rtol=1e-5)
        np.testing.assert_allclose(r["valid_losses"], dp["one"]["valid_losses"], rtol=1e-5)
    # synchronized BatchNorm leaves the replicas' buffers equal
    for k, v in aug[0]["state"].items():
        np.testing.assert_array_equal(v, aug[1]["state"][k], err_msg=k)
    one_state = dp["one"]["model"].state_dict()
    for k in one_state:
        if k.endswith("running_var"):
            np.testing.assert_allclose(aug[0]["state"][k], one_state[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_streamed_feed_reads_only_each_ranks_rows_and_equals_resident(dp):
    resident = [r[1] for r in dp["ranked"]]
    streamed = [r[2] for r in dp["ranked"]]
    for s, r in zip(streamed, resident):
        np.testing.assert_allclose(s["train_losses"], r["train_losses"], rtol=1e-6)
        np.testing.assert_allclose(s["valid_losses"], r["valid_losses"], rtol=1e-6)
        assert r["read"] == []
    train_idx, valid_idx = streamed[0]["train_idx"], streamed[0]["valid_idx"]
    shuffle = np.random.default_rng(1)  # fit's shuffle stream: seed + 1
    expected = [list(valid_idx), list(valid_idx)]
    for _ in range(2):
        order = np.arange(len(train_idx))
        shuffle.shuffle(order)
        for start in range(0, len(order), RECIPE["batch_size"]):
            for rank in range(2):
                expected[rank] += [train_idx[i] for i in local_batch_slice(order[start : start + 4], rank, 2)]
    for rank in range(2):
        assert streamed[rank]["read"] == expected[rank]


FOLD_PATS = [1, 2, 3, 4]
FOLD_RECIPE = dict(RECIPE, batch_size=3, init_lr=0.05, train_valid_split=0.75, data_aug=False)


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """K = 4 folds of 4 specimens of 4 frames: JAX's initial fold weights
    and splits go into epoch-0 port fold checkpoints, which 2 ranks (2
    folds each) resume for one epoch while the JAX fit_multifold runs one
    fresh epoch on an {'ensemble': 2} mesh."""
    d = tmp_path_factory.mktemp("folds")
    archive = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=4, num_projs=4, img_dim=32, seed=2)
    jcfg = JaxTrainConfig(**FOLD_RECIPE)
    pad = _padded_dim(32, jcfg.proj_unet_dim)
    _, stacked = jmf.make_multifold_state(jcfg, 4, jax.random.PRNGKey(jcfg.seed), (pad, pad))
    cfg = TrainConfig(**FOLD_RECIPE)
    models = [build_model(cfg) for _ in FOLD_PATS]
    for k, m in enumerate(models):
        m.load_state_dict(fold_state_dict_from_jax(stacked.params, stacked.batch_stats, k, m))
    offsets = [0, 4, 8, 12, 16]
    splits = [jmf._split_pool(np.concatenate([np.arange(offsets[j], offsets[j + 1]) for j in range(4) if j != k]),
                              cfg.train_valid_split, cfg.seed + k) for k in range(4)]
    port = dict(checkpoint_prefix=str(d / "port_ck"), best_prefix=str(d / "port_best"))
    ck_paths = ["{}_spec{:02d}.pt".format(port["checkpoint_prefix"], p) for p in FOLD_PATS]
    tmf.save_fold_checkpoints(cfg, models, ck_paths, train_idx=[t for t, _ in splits],
                              valid_idx=[v for _, v in splits])
    ranked = run_ranks(ranks.folds_fit, 2, args=(archive, FOLD_PATS, FOLD_RECIPE, port, str(d / "ptl")),
                       device="cpu", timeout=300)
    jout = jmf.fit_multifold(archive, FOLD_PATS, jcfg, train_loss_txt_prefix=str(d / "jtl"), verbose=False,
                             mesh=jax_make_mesh({"ensemble": 2}, devices=jax.devices()[:2]),
                             checkpoint_prefix=str(d / "jax_ck"), best_prefix=str(d / "jax_best"))
    return dict(d=d, ranked=ranked, jout=jout, port=port, splits=splits)


def test_fold_sharded_fit_multifold_matches_the_jax_ensemble_mesh(folds):
    ranked, jout = folds["ranked"], folds["jout"]
    assert [r["folds"] for r in ranked] == [[0, 1], [2, 3]]
    for r in ranked:
        assert r["epoch"] == jout["epoch"] == 1
        np.testing.assert_array_equal(r["train_losses"], ranked[0]["train_losses"])
        np.testing.assert_allclose(r["best_valid_losses"], jout["best_valid_losses"], rtol=1e-3)
        np.testing.assert_allclose(r["valid_losses"][0], jout["best_valid_losses"], rtol=1e-3)
    for k, p in enumerate(FOLD_PATS):
        ours = read_floats_from_txt("{}_spec{:02d}.txt".format(folds["d"] / "ptl", p))
        theirs = read_floats_from_txt("{}_spec{:02d}.txt".format(folds["d"] / "jtl", p))
        assert len(ours) == len(theirs) == 3  # ceil(9 training rows / batch 3)
        assert ours[0] == pytest.approx(theirs[0], rel=1e-4)
        np.testing.assert_allclose(ours, theirs, rtol=1e-3)
        np.testing.assert_allclose(ours, ranked[0]["train_losses"][:, k], rtol=0, atol=1e-6)  # the log rounds


def test_fold_owners_write_each_folds_files(folds):
    for k, p in enumerate(FOLD_PATS):
        ck = load_checkpoint("{}_spec{:02d}.pt".format(folds["port"]["checkpoint_prefix"], p))
        assert ck["epoch"] == 1 and ck["train-idx"] == [int(i) for i in folds["splits"][k][0]]
        assert os.path.exists("{}_spec{:02d}.pt".format(folds["port"]["best_prefix"], p))


TRAIN_ARGV = ["--train-pats", "1,2,3", "--num-classes", "7", "--init-lr", "0.1", "--unet-batch-norm", "--unet-no-max-pool",
              "--unet-img-dim", "36", "--unet-num-lvls", "2", "--unet-init-feats-exp", "2", "--batch-size", "4",
              "--max-num-epochs", "2", "--unet-padding", "--nesterov", "--use-lands", "--train-valid-split", "0.8",
              "--data-aug", "--lr-sched", "plateau", "--no-gpu"]


def test_train_cli_dp_devices_equals_one_process(tmp_path):
    archive = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=3, num_projs=5, img_dim=32, seed=1)
    logs = {}
    for tag, extra in (("one", []), ("two", ["--dp-devices", "2"])):
        paths = ["--checkpoint-net", str(tmp_path / (tag + "_ck.pt")), "--best-net", str(tmp_path / (tag + "_b.pt")),
                 "--train-loss-txt", str(tmp_path / (tag + "_t.txt")), "--valid-loss-txt",
                 str(tmp_path / (tag + "_v.txt"))]
        cli_train.main([archive, *TRAIN_ARGV, *paths, *extra])
        logs[tag] = [read_floats_from_txt(str(tmp_path / (tag + s))) for s in ("_t.txt", "_v.txt")]
        assert load_checkpoint(str(tmp_path / (tag + "_ck.pt")))["epoch"] == 2
    assert len(logs["two"][0]) == 6
    for got, want in zip(logs["two"], logs["one"]):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(RuntimeError, match="must be divisible by the data axis 2"):
        cli_train.main([archive, *TRAIN_ARGV, "--dp-devices", "2", "--batch-size", "3",
                        "--checkpoint-net", str(tmp_path / "odd_ck.pt")])


def test_train_folds_cli_ensemble_devices_equals_one_process(tmp_path):
    archive = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=4, num_projs=4, img_dim=32, seed=2)
    argv = [archive, "--pats", "1,2,3,4", "--num-classes", "7", "--init-lr", "0.05", "--unet-batch-norm",
            "--unet-no-max-pool", "--unet-img-dim", "36", "--unet-num-lvls", "2", "--batch-size", "3", "--epochs", "1",
            "--unet-init-feats-exp", "2", "--unet-padding", "--nesterov", "--use-lands", "--train-valid-split", "0.75",
            "--data-aug", "--no-gpu"]
    for tag, extra in (("one", []), ("two", ["--ensemble-devices", "2"])):
        cli_folds.main([*argv, "--net-prefix", str(tmp_path / (tag + "_fold")), "--checkpoint-prefix",
                        str(tmp_path / (tag + "_ck")), "--train-loss-prefix", str(tmp_path / (tag + "_tl")), *extra])
    for p in (1, 2, 3, 4):
        got = read_floats_from_txt(str(tmp_path / "two_tl_spec{:02d}.txt".format(p)))
        want = read_floats_from_txt(str(tmp_path / "one_tl_spec{:02d}.txt".format(p)))
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert load_checkpoint(str(tmp_path / "two_fold_spec{:02d}.pt".format(p)))["epoch"] == 1


@pytest.fixture(scope="module")
def te_inputs(tmp_path_factory):
    """An archive of 6 frames and two saved depth-2 members, and the
    one-process test_ensemble CLI's file over them at batch 4."""
    from deepfluoro_tpu_torch.cli import test_ensemble as cli_te
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("te")
    archive = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=2, num_projs=6, img_dim=32, seed=3)
    cfg = TrainConfig(**RECIPE)
    nets = []
    for i in range(2):
        torch.manual_seed(i)
        nets.append(str(d / "net{}.pt".format(i)))
        save_checkpoint(nets[-1], cfg, build_model(cfg).eval())
    one = str(d / "one.h5")
    cli_te.main([archive, one, "--pats", "2", "--nets", *nets, "--batch-size", "4", "--no-gpu"])
    return d, archive, nets, one


@pytest.mark.parametrize("layout", [["--ensemble-devices", "2"], ["--dp-devices", "2"]], ids=["members", "rows"])
def test_test_ensemble_cli_over_two_processes_equals_one(te_inputs, layout):
    import h5py

    from deepfluoro_tpu_torch.cli import test_ensemble as cli_te

    d, archive, nets, one = te_inputs
    out, times = str(d / "two_{}.h5".format(layout[0])), str(d / "times_{}.txt".format(layout[0]))
    cli_te.main([archive, out, "--pats", "2", "--nets", *nets, "--batch-size", "4", "--no-gpu", "--times", times,
                 *layout])
    with h5py.File(out, "r") as a, h5py.File(one, "r") as b:
        assert set(a) == set(b) and a["nn-segs"].shape == (6, 32, 32)
        np.testing.assert_allclose(a["nn-heats"][:], b["nn-heats"][:], rtol=0, atol=1e-5)
        assert (a["nn-segs"][:] == b["nn-segs"][:]).mean() >= 0.999
    assert len(read_floats_from_txt(times)) == 6
