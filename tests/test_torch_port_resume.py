"""The rest of the port's ``fit`` against the JAX package's: resume (from
the port's own ``.pt`` files, which the JAX ``fit`` also resumes), the
split core, flip duplication, min-max scaling, the streaming feed, the
async checkpointer, light best nets, pre-restart snapshots, SIGTERM,
``max_hours`` and the CLI flags. Depth-2 nets on 32^2 frames, on the CPU.

Tolerances: the resumed JAX and port runs start from the same weights,
momentum and batch order (augmentation off) and may differ only by
float32 summation order in the convolutions: per-step train losses of the
first resumed epoch within 1e-4 relative, validation losses within 1e-3."""

import os
import shutil
import signal
import types

import numpy as np
import pytest
import torch

from deepfluoro_tpu.compat.torch_import import torch_checkpoint_to_native
from deepfluoro_tpu.data import hdf5 as jhdf5
from deepfluoro_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from deepfluoro_tpu.data.pipeline import PrefetchIterator as JaxPrefetchIterator
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import fit as jax_fit
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.data import hdf5 as thdf5
from deepfluoro_tpu_torch.data.fixtures import DEFAULT_LAND_NAMES, make_synthetic_data, write_synthetic_dataset
from deepfluoro_tpu_torch.data.pipeline import BatchIterator, PrefetchIterator
from deepfluoro_tpu_torch.train import TrainConfig, fit, load_checkpoint, save_checkpoint
from deepfluoro_tpu_torch.train import loop as loop_mod
from deepfluoro_tpu_torch.train.checkpoint import AsyncCheckpointer
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

RECIPE = dict(
    num_classes=7, batch_size=2, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=1,
)


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
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("resume") / "ds.h5"), num_specimens=2, num_projs=4,
                                   img_dim=32, seed=1)


def _files(tmp_path, tag):
    return {k: str(tmp_path / "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


def test_plateau_cut_lr_is_in_the_saved_param_groups(tmp_path):
    """After an epoch whose plateau step cut the LR, the checkpoint's param
    groups carry the cut LR, as torch's scheduler leaves them, so the JAX
    importer (which reads the LR there) resumes at the LR the run reached."""
    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1)
    paths = _files(tmp_path, "p")
    fit(data, [1, 2], _cfg(init_lr=1e-12, lr_patience=0, lr_cooldown=0, max_num_epochs=2), verbose=False,
        device="cpu", **paths)
    ck = load_checkpoint(paths["checkpoint_filename"])
    assert ck["scheduler-state-dict"]["lr"] == pytest.approx(1e-13, rel=1e-12)
    assert ck["optimizer-state-dict"]["param_groups"][0]["lr"] == ck["scheduler-state-dict"]["lr"]
    assert torch_checkpoint_to_native(paths["checkpoint_filename"])["scheduler-state-dict"]["lr"] == pytest.approx(
        1e-13, rel=1e-12)


@pytest.mark.parametrize("names", [DEFAULT_LAND_NAMES, None], ids=["land-names", "adjacent-pairs"])
def test_lr_flip_duplicate_equals_jax(names):
    d = make_synthetic_data(num_specimens=1, num_projs=3, img_dim=24, seed=5)
    ours = thdf5.lr_flip_duplicate(d, land_names=names)
    theirs = jhdf5.lr_flip_duplicate(jhdf5.FluoroData(d.projs, d.segs, d.lands, d.orig_img_shape), land_names=names)
    for a in ("projs", "segs", "lands"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(theirs, a), err_msg=a)
    np.testing.assert_array_equal(ours.pat_inds, np.concatenate([d.pat_inds, d.pat_inds]))
    with pytest.raises(ValueError, match="pairs"):
        thdf5.lr_flip_duplicate(d, land_names=["a{}".format(i) for i in range(14)])


@pytest.mark.parametrize("n,split,seed", [(8, 0.75, 0), (35, 0.85, 3), (42, 0.85, 5)])
def test_split_indices_equal_jax(n, split, seed):
    assert thdf5.split_indices(n, split, seed) == jhdf5.split_indices(n, split, seed)
    d = make_synthetic_data(num_specimens=1, num_projs=n, img_dim=8, seed=0)
    t_data, v_data, t, v = thdf5.split_train_valid(d, split, seed=seed)
    again = thdf5.split_train_valid(d, split, (t, v), seed=seed + 1)
    assert (again[2], again[3]) == (t, v)
    np.testing.assert_array_equal(again[0].projs, t_data.projs)


@pytest.mark.parametrize("minmax,dup", [(True, False), ((-1.0, 3.0), False), (None, True), (True, True)])
def test_load_dataset_minmax_and_flip_equal_jax(archive, minmax, dup):
    ours = thdf5.load_dataset(archive, [2, 1], minmax=minmax, dup_lr_flip=dup)
    theirs = jhdf5.load_dataset(archive, [2, 1], minmax=minmax, dup_lr_flip=dup)
    for a in ("projs", "segs", "lands"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(theirs, a), err_msg=a)
    assert ours.minmax == theirs.minmax
    assert thdf5.specimen_counts(archive, [2, 1]) == jhdf5.specimen_counts(archive, [2, 1])


def test_prefetch_order_equals_jax_and_batch_iterator():
    d = make_synthetic_data(num_specimens=2, num_projs=5, img_dim=8, seed=2)
    d.projs = np.arange(len(d), dtype=np.float32)[:, None, None] * np.ones((1, 8, 8), np.float32)
    jd = jhdf5.FluoroData(d.projs, d.segs, d.lands, d.orig_img_shape)

    def orders(it):
        return [[int(b[0][i, 0, 0]) for i in range(b[0].shape[0])] for e in range(3) for b in it.epoch()]

    ours = orders(PrefetchIterator(d, 3, "cpu", shuffle=True, seed=11))
    assert ours == orders(BatchIterator(d, 3, "cpu", shuffle=True, rng=np.random.default_rng(11)))
    assert ours == orders(JaxPrefetchIterator(jd, 3, shuffle=True, seed=11))
    assert ours == orders(JaxBatchIterator(jd, 3, shuffle=True, seed=11, device_resident=False))
    assert orders(PrefetchIterator(d, 4, "cpu", shuffle=False))[:3] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    batch = next(PrefetchIterator(d, 4, "cpu", shuffle=False).epoch())
    np.testing.assert_array_equal(batch[1].numpy(), d.segs[:4])
    np.testing.assert_array_equal(batch[2].numpy(), d.lands[:4])


def test_resume_against_jax_fit(tmp_path, archive):
    """One port epoch (augmentation off) writes a checkpoint; the JAX fit
    and the port fit each resume a copy of it for two more epochs."""
    first = _files(tmp_path, "first")
    fit(archive, [1, 2], _cfg(), verbose=False, device="cpu", **first)
    port, jx = _files(tmp_path, "port"), _files(tmp_path, "jax")
    for f in (port, jx):
        shutil.copyfile(first["checkpoint_filename"], f["checkpoint_filename"])
    for key in ("train_loss_txt", "valid_loss_txt"):
        shutil.copyfile(first[key], port[key])

    out = fit(archive, [1, 2], _cfg(max_num_epochs=3), verbose=False, device="cpu", **port)
    jout = jax_fit(archive, [1, 2], JaxTrainConfig(**dict(RECIPE, max_num_epochs=3)), verbose=False, **jx)
    assert out["epoch"] == jout["epoch"] == 3
    assert out["train_idx"] == jout["train_idx"] == load_checkpoint(first["checkpoint_filename"])["train-idx"]
    jax_train = read_floats_from_txt(jx["train_loss_txt"])
    assert len(jax_train) == len(out["train_losses"]) == 6
    np.testing.assert_allclose(out["train_losses"][:3], jax_train[:3], rtol=1e-4)
    np.testing.assert_allclose(out["valid_losses"], read_floats_from_txt(jx["valid_loss_txt"]), rtol=1e-3)
    # the port's loss logs were appended to, not truncated
    first_valid = read_floats_from_txt(first["valid_loss_txt"])
    assert read_floats_from_txt(port["valid_loss_txt"]) == pytest.approx(first_valid + out["valid_losses"], abs=1e-6)
    assert len(read_floats_from_txt(port["train_loss_txt"])) == 9


def test_resume_overrides_config_and_restores_state(tmp_path):
    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1)
    paths = _files(tmp_path, "r")
    out = fit(data, [1, 2], _cfg(data_aug=True), verbose=False, device="cpu", **paths)
    ck = load_checkpoint(paths["checkpoint_filename"])
    out2 = fit(data, [1, 2], _cfg(max_num_epochs=2, init_feats_exp=3, data_aug=False), verbose=False, device="cpu",
               **paths)
    assert out2["cfg"].init_feats_exp == 2 and out2["cfg"].data_aug is True  # the checkpoint's meta wins
    assert out2["epoch"] == 2 and out2["train_idx"] == out["train_idx"] == ck["train-idx"]
    assert len(out2["train_losses"]) == 3
    assert len(read_floats_from_txt(paths["train_loss_txt"])) == 6


@pytest.mark.parametrize("key,value", [("compute-dtype", "bfloat16"), ("remat", True)])
def test_resume_keeps_bf16_and_remat(tmp_path, key, value):
    """A checkpoint that asks for bfloat16 compute or remat resumes in that
    mode, whatever the caller's config says, and saves it again."""
    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1)
    paths = _files(tmp_path, "x")
    fit(data, [1, 2], _cfg(), verbose=False, device="cpu", **paths)
    ck = load_checkpoint(paths["checkpoint_filename"])
    ck[key] = value
    torch.save(ck, paths["checkpoint_filename"])
    out = fit(data, [1, 2], _cfg(max_num_epochs=2), verbose=False, device="cpu", **paths)
    attr = TrainConfig._META_KEYS[key]
    assert getattr(out["cfg"], attr) == value and out["epoch"] == 2
    model = out["model"]
    assert (model.dtype, model.remat) == (out["cfg"].dtype, out["cfg"].remat)
    assert np.isfinite(out["train_losses"]).all() and len(out["train_losses"]) == 3
    assert load_checkpoint(paths["checkpoint_filename"])[key] == value


def test_stream_equals_resident(tmp_path):
    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=3)
    outs = [fit(data, [1, 2], _cfg(max_num_epochs=2, data_aug=True), verbose=False, device="cpu",
                stream_data=stream, **_files(tmp_path, str(stream))) for stream in (False, True)]
    np.testing.assert_allclose(outs[1]["train_losses"], outs[0]["train_losses"], rtol=1e-6)
    np.testing.assert_allclose(outs[1]["valid_losses"], outs[0]["valid_losses"], rtol=1e-6)
    for a, b in zip(outs[0]["model"].state_dict().values(), outs[1]["model"].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_light_best_nets_and_resume_from_a_light_file(tmp_path):
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint

    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1)
    for freq in (3, 1):  # the best net saved on its own, and beside a checkpoint it must not copy
        paths = _files(tmp_path, "f{}".format(freq))
        fit(data, [1, 2], _cfg(max_num_epochs=2, light_best_nets=True, checkpoint_freq=freq), verbose=False,
            device="cpu", **paths)
        full, light = load_checkpoint(paths["checkpoint_filename"]), load_checkpoint(paths["best_valid_filename"])
        assert full["optimizer-state-dict"] and full["scheduler-state-dict"]
        assert not light["optimizer-state-dict"] and not light["scheduler-state-dict"]
        assert os.path.getsize(paths["best_valid_filename"]) < 0.75 * os.path.getsize(paths["checkpoint_filename"])
        assert light["light-best-nets"] is True
    model, cfg = load_net_from_checkpoint(paths["best_valid_filename"], device="cpu", verbose=False)
    assert cfg.init_feats_exp == 2 and not model.training
    # the JAX fit reads a light port file as weights without optimizer state
    assert torch_checkpoint_to_native(paths["best_valid_filename"])["torch-opt-moments"] is None
    resumed = dict(paths, checkpoint_filename=paths["best_valid_filename"],
                   best_valid_filename=str(tmp_path / "best2.pt"))
    out = fit(data, [1, 2], _cfg(max_num_epochs=3), verbose=False, device="cpu", **resumed)
    assert out["epoch"] == 3 and len(out["train_losses"]) == 3 * (3 - light["epoch"])


def test_cos_pre_restart_snapshot_names(tmp_path):
    data = make_synthetic_data(num_specimens=1, num_projs=4, img_dim=32, seed=1)
    prefix = str(tmp_path / "restart")
    out = fit(data, [1], _cfg(max_num_epochs=3, lr_sched_meth="cos", lrs_num_epochs=1, lrs_growth_factor=1,
                              save_restart_net_prefix=prefix, save_after_n_restarts=1),
              verbose=False, device="cpu", **_files(tmp_path, "c"))
    assert out["num_restarts"] == 3
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("restart"))
    assert names == ["restart_00.pt", "restart_01.pt", "restart_02.pt"]
    assert [load_checkpoint(str(tmp_path / n))["epoch"] for n in names] == [1, 2, 3]
    out = fit(data, [1], _cfg(max_num_epochs=50, lr_sched_meth="cos", lrs_num_epochs=1, lrs_growth_factor=1,
                              max_num_restarts=2), verbose=False, device="cpu", **_files(tmp_path, "m"))
    assert out["num_restarts"] == 2 and out["epoch"] == 2


def test_sigterm_stops_after_the_epoch_and_restores_the_handler(tmp_path, monkeypatch):
    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1)
    real_step = loop_mod.train_step
    calls = []

    def step_then_sigterm(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            handler = signal.getsignal(signal.SIGTERM)
            assert callable(handler) and handler is not sentinel  # fit's handler, never the default
            signal.raise_signal(signal.SIGTERM)
        return real_step(*args, **kwargs)

    def sentinel(signum, frame):
        raise AssertionError("the caller's handler ran during fit")

    monkeypatch.setattr(loop_mod, "train_step", step_then_sigterm)
    old = signal.signal(signal.SIGTERM, sentinel)
    try:
        paths = _files(tmp_path, "s")
        out = fit(data, [1, 2], _cfg(max_num_epochs=5, checkpoint_freq=10), verbose=False, device="cpu", **paths)
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["epoch"] == 1 and len(calls) == 3
    assert load_checkpoint(paths["checkpoint_filename"])["epoch"] == 1


def test_max_hours_with_a_patched_clock(tmp_path, monkeypatch):
    """Each epoch takes 0.3 h on the patched clock; with 1 h the run stops
    when the next epoch would overrun: after epoch 3 (0.9 + 0.3 > 1)."""
    data = make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1)
    now = [0.0]

    def clock():
        now[0] += 0.3 * 3600.0
        return now[0]

    monkeypatch.setattr(loop_mod, "time", types.SimpleNamespace(time=clock, perf_counter=loop_mod.time.perf_counter))
    paths = _files(tmp_path, "h")
    out = fit(data, [1, 2], _cfg(max_num_epochs=10, max_hours=1.0), verbose=False, device="cpu", **paths)
    assert out["epoch"] == 3
    assert load_checkpoint(paths["checkpoint_filename"])["epoch"] == 3


def test_dup_lr_flip_mirrors_the_training_side_only(tmp_path, archive):
    paths = _files(tmp_path, "d")
    out = fit(archive, [1, 2], _cfg(dup_lr_flip=True), verbose=False, device="cpu", **paths)
    assert len(out["train_idx"]) == 6 and len(out["valid_idx"]) == 2
    assert len(out["train_losses"]) == 6  # 12 training rows (6 and their mirrors), batch 2
    ck = load_checkpoint(paths["checkpoint_filename"])
    assert ck["dup-lr-flip"] is True and ck["train-idx"] == out["train_idx"]


class TestAsyncCheckpointer:
    def _net(self):
        from deepfluoro_tpu_torch.train import build_model, make_optimizer

        cfg = _cfg()
        model = build_model(cfg)
        return cfg, model, make_optimizer(cfg, model.parameters())

    def test_snapshot_survives_an_in_place_update(self, tmp_path):
        cfg, model, _ = self._net()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        ck = AsyncCheckpointer()
        path = str(tmp_path / "a.pt")
        ck.save(path, cfg, model, epoch=4)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        ck.wait()
        saved = load_checkpoint(path)
        assert saved["epoch"] == 4
        for k, v in before.items():
            torch.testing.assert_close(saved["model-state-dict"][k], v, rtol=0, atol=0)

    def test_copy_is_ordered_after_the_save_of_its_source(self, tmp_path):
        cfg, model, opt = self._net()
        ck = AsyncCheckpointer()
        src, dst = str(tmp_path / "ck.pt"), str(tmp_path / "best.pt")
        for e in range(3):
            ck.save(src, cfg, model, opt, epoch=e)
        ck.copy(src, dst)
        ck.wait()
        assert load_checkpoint(dst)["epoch"] == 2

    def test_worker_error_surfaces_and_stale_tasks_are_dropped(self, tmp_path):
        import threading

        cfg, model, _ = self._net()
        src, dst = str(tmp_path / "ck.pt"), str(tmp_path / "best.pt")
        save_checkpoint(src, cfg, model, epoch=0)
        ck = AsyncCheckpointer(max_pending=8)
        gate = threading.Event()
        real_worker = ck._worker

        def gated_worker():
            gate.wait()
            real_worker()

        ck._worker = gated_worker
        ck.save(str(tmp_path / "no_such_dir" / "x.pt"), cfg, model, epoch=9)
        ck.save(src, cfg, model, epoch=9)
        ck.copy(src, dst)
        gate.set()
        with pytest.raises(Exception):
            ck.wait()
        assert not os.path.exists(dst) and load_checkpoint(src)["epoch"] == 0
        ck.save(src, cfg, model, epoch=10)
        ck.copy(src, dst)
        ck.wait()
        assert load_checkpoint(dst)["epoch"] == 10


def test_cli_flags_reach_the_run(tmp_path, monkeypatch):
    archive = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=2, num_projs=4, img_dim=24, seed=3)
    monkeypatch.chdir(tmp_path)
    argv = [archive, "--train-pats", "1,2", "--num-classes", "7", "--init-lr", "0.1", "--unet-batch-norm",
            "--unet-no-max-pool", "--unet-img-dim", "28", "--unet-num-lvls", "2", "--batch-size", "2",
            "--max-num-epochs", "2", "--unet-init-feats-exp", "2", "--unet-padding", "--nesterov", "--use-lands",
            "--lr-sched", "cos", "--cos-anneal-epochs", "1", "--cos-growth", "1", "--train-valid-split", "0.75",
            "--light-best-nets", "--save-restart-net", "rr", "--save-after-n-restarts", "1", "--max-hours", "5",
            "--stream-data", "--dup-lr-flip", "--checkpoint-freq", "5", "--no-gpu"]
    args = cli_train.build_parser().parse_args(argv)
    assert args.stream_data and args.dup_lr_flip and args.light_best_nets and args.max_hours == 5.0
    cli_train.main(argv)
    ck = load_checkpoint("zz_checkpoint.pt")
    assert ck["epoch"] == 2 and ck["dup-lr-flip"] is True and ck["light-best-nets"] is True
    assert ck["lrs-save-restart-net-prefix"] == "rr" and ck["lrs-save-after-n-restarts"] == 1
    assert os.path.exists("rr_00.pt") and os.path.exists("rr_01.pt")
    assert not load_checkpoint("rr_00.pt")["optimizer-state-dict"]
    assert len(read_floats_from_txt("train_iter_loss.txt")) == 2 * 6  # 6 rows + 6 mirrors, batch 2
    argv[argv.index("--max-num-epochs") + 1] = "3"
    cli_train.main(argv)
    assert load_checkpoint("zz_checkpoint.pt")["epoch"] == 3
