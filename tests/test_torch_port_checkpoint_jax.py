"""The JAX package's checkpoints in the port, without JAX on the port's
side: the msgpack decoders (``compat/msgpack_lite.py``, and the
``msgpack`` package through the same extension hook) against flax's
``msgpack_restore``; ``train/checkpoint.py::is_torch_checkpoint`` against
the JAX package's; ``compat/from_jax.py::torch_checkpoint_from_jax``
against ``export_torch_checkpoint`` on the same files (a ``fit``
checkpoint under each optimizer and schedule, and ``fit_multifold``'s
fold files); ``load_net_from_checkpoint``, ``cli/export_torch_net`` (in a
process where JAX cannot import), and ``fit``/``fit_multifold`` resumed
from JAX checkpoints against the JAX package's resumes. Depth-2 nets on
32^2 frames, on the CPU.

Tolerances: the conversions are exact (tensors equal bit for bit, every
other value equal). A forward of a loaded member against flax's within
1e-4 (the U-Net tests' tolerance); resumed runs start from the same
weights, momentum, LR and batch order (augmentation off) and differ by
float32 summation order only: per-step train losses within 1e-4
relative, validation losses within 1e-3 (``test_torch_port_resume.py``'s
tolerances)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deepfluoro_tpu.compat.torch_import import export_torch_checkpoint
from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint as jax_load_net
from deepfluoro_tpu.train import multifold as jmf
from deepfluoro_tpu.train.checkpoint import is_torch_checkpoint as jax_is_torch_checkpoint
from deepfluoro_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.loop import fit as jax_fit
from deepfluoro_tpu.train.step import make_train_state
from deepfluoro_tpu_torch.cli import export_torch_net
from deepfluoro_tpu_torch.compat import msgpack_lite, torch_checkpoint_from_jax
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
from deepfluoro_tpu_torch.train import TrainConfig, fit, fit_multifold, load_checkpoint
from deepfluoro_tpu_torch.train.checkpoint import is_torch_checkpoint
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = dict(
    num_classes=7, batch_size=2, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14,
    heat_coeff=0.5, lr_sched_meth="plateau", train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=1,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test files run at once under pytest-xdist; torch's OpenMP
    threads in each would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("jaxck") / "ds.h5"), num_specimens=3, num_projs=4,
                                   img_dim=32, seed=1)


def _files(d, tag):
    return {k: os.path.join(str(d), "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, archive):
    """A JAX ``fit`` of one epoch (plateau, Nesterov SGD with weight
    decay, augmentation off): its msgpack checkpoint and file paths."""
    d = tmp_path_factory.mktemp("jaxfit")
    files = _files(d, "first")
    jax_fit(archive, [1, 2], JaxTrainConfig(**RECIPE), verbose=False, **files)
    return files


def _assert_same(a, b, where="ck"):
    """Equal trees: tensors bit for bit (dtype and shape too), lists and
    dicts item by item, every other value by ``==``."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(set(a) ^ set(b)))
        for k in a:
            _assert_same(a[k], b[k], "{}/{}".format(where, k))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, "{}[{}]".format(where, i))
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


def _assert_tree_equal(a, b, where="tree"):
    """Equal decoded msgpack trees, arrays by dtype, shape and value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_tree_equal(a[k], b[k], "{}/{}".format(where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, "{}[{}]".format(where, i))
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


def _exported(tmp_path, native):
    out = str(tmp_path / "exported.pt")
    export_torch_checkpoint(native, out)
    return torch.load(out, map_location="cpu", weights_only=False)


def _all_types_tree():
    rng = np.random.default_rng(0)
    big = {"k{:03d}".format(i): i for i in range(40)}  # map16
    return {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf"), float("nan")],
        "misc": [None, True, False, "", "x" * 31, "y" * 32, "z" * 300, "ü" * 40000, b"\x00\xff" * 200],
        "long_list": list(range(20)),
        "big_map": big,
        "arrays": {
            "f32": rng.standard_normal((3, 4)).astype(np.float32),
            "f64": rng.standard_normal((2,)),
            "i64": np.arange(5, dtype=np.int64),
            "u8": np.arange(7, dtype=np.uint8),
            "bool": np.array([True, False]),
            "empty": np.zeros((0, 3), np.float32),
            "scalar0d": np.asarray(3.5, np.float32),
        },
        "npscalar": np.float32(2.25),
        "npint": np.int64(-7),
        "complex": complex(1.5, -2.0),
    }


def test_msgpack_decoders_equal_flax_on_every_type():
    blob = serialization.msgpack_serialize(_all_types_tree())
    want = serialization.msgpack_restore(blob)
    lite = msgpack_lite.restore(blob, use_msgpack=False)
    pkg = msgpack_lite.restore(blob, use_msgpack=True)
    _assert_tree_equal(lite, want)
    _assert_tree_equal(pkg, want)
    _assert_tree_equal(lite, pkg)
    assert isinstance(lite["npscalar"], np.float32) and isinstance(lite["complex"], complex)


def test_msgpack_lite_bfloat16_and_chunks_and_errors():
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    blob = serialization.msgpack_serialize({"w": np.asarray(x)})
    got = msgpack_lite.restore(blob, use_msgpack=False)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x).astype(np.float32))
    chunked = {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3},
                     "chunks": {"0": np.arange(4.0), "1": np.arange(4.0, 6.0)}}}
    got = msgpack_lite.restore(serialization.msgpack_serialize(chunked), use_msgpack=False)
    np.testing.assert_array_equal(got["a"], np.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_lite.unpackb(b"\x92\x01")
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack_lite.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="starts no msgpack object"):
        msgpack_lite.unpackb(b"\xc1")


def test_msgpack_decoders_equal_flax_on_a_fit_checkpoint(jax_run):
    path = jax_run["checkpoint_filename"]
    want = serialization.msgpack_restore(open(path, "rb").read())
    lite = msgpack_lite.read(path, use_msgpack=False)
    _assert_tree_equal(lite, want)
    _assert_tree_equal(msgpack_lite.read(path, use_msgpack=True), lite)


def test_is_torch_checkpoint_equals_jax(tmp_path, jax_run):
    zipped, legacy = str(tmp_path / "z.pt"), str(tmp_path / "l.pt")
    torch.save({"a": torch.ones(2)}, zipped)
    torch.save({"a": torch.ones(2)}, legacy, _use_new_zipfile_serialization=False)
    for path, want in ((zipped, True), (legacy, True), (jax_run["checkpoint_filename"], False)):
        assert is_torch_checkpoint(path) == jax_is_torch_checkpoint(path) == want


def test_fit_checkpoint_equals_the_jax_exporter(tmp_path, jax_run):
    """Every key, tensor and value of the JAX exporter's file, including
    the momentum buffers, the plateau scheduler state, the metadata and
    the split indices; and the same through the CLI."""
    path = jax_run["checkpoint_filename"]
    want = _exported(tmp_path, path)
    got = torch_checkpoint_from_jax(path)
    _assert_same(got, want)
    momenta = want["optimizer-state-dict"]["state"]
    assert len(momenta) == len(want["optimizer-state-dict"]["param_groups"][0]["params"]) - 2  # all but the dead conv
    assert want["train-idx"] and want["scheduler-state-dict"]["min_lrs"] == [0.0]


@pytest.mark.parametrize("optim,sched,wd,mom", [("sgd", "cos", 0.0, 0.9), ("adam", "none", 1e-4, 0.0),
                                               ("rmsprop", "none", 0.0, 0.5), ("sgd", "plateau", 1e-4, 0.0)])
def test_optimizer_and_schedule_variants_equal_the_jax_exporter(tmp_path, optim, sched, wd, mom):
    """A JAX state after two optimizer steps of each optimizer, written by
    the JAX package's ``save_checkpoint`` with a scheduler state."""
    from deepfluoro_tpu.train.schedules import ReduceLROnPlateau as JaxPlateau
    from deepfluoro_tpu.train.schedules import WarmRestartLR as JaxWarmRestart
    from deepfluoro_tpu.train.step import make_optimizer as jax_make_optimizer
    from deepfluoro_tpu.train.step import make_train_step

    cfg = JaxTrainConfig(**dict(RECIPE, optim_type=optim, lr_sched_meth=sched, wgt_decay=wd, momentum=mom,
                                nesterov=optim == "sgd" and mom > 0))
    model, state = make_train_state(cfg, jax.random.PRNGKey(3), (36, 36))
    step = make_train_step(cfg, model, jax_make_optimizer(cfg))
    rng = np.random.default_rng(4)
    proj = jnp.asarray(rng.standard_normal((2, 36, 36, 1)), jnp.float32)
    seg = jax.nn.one_hot(rng.integers(0, 7, (2, 36, 36)), 7)
    heats = jnp.asarray(rng.random((2, 36, 36, 14)), jnp.float32)
    for lr in (0.1, 0.05):
        state, _ = step(state, proj, seg, heats, lr)
    sched_obj = {"cos": JaxWarmRestart(0.1, init_run_period_epochs=4), "plateau": JaxPlateau(0.1, patience=0, cooldown=0),
                 "none": None}[sched]
    if sched == "plateau":
        sched_obj.step(1.0)
        sched_obj.step(2.0)  # cut: the scheduler's LR is 0.01, the optimizer last ran 0.05
    elif sched == "cos":
        sched_obj.step()
    path = str(tmp_path / "state.pt")
    jax_save_checkpoint(path, cfg.to_checkpoint_meta(), state.params, state.batch_stats, state.opt_state,
                        sched_state=None if sched_obj is None else sched_obj.state_dict(), epoch=3,
                        best_valid_loss=None, last_loss=0.25, num_restarts=1, train_idx=[3, 1], valid_idx=[0])
    want = _exported(tmp_path, path)
    _assert_same(torch_checkpoint_from_jax(path), want)
    fields = {f for e in want["optimizer-state-dict"]["state"].values() for f in e}
    assert fields == {"sgd": {"momentum_buffer"} if mom else set(), "adam": {"exp_avg", "exp_avg_sq", "step"},
                      "rmsprop": {"square_avg", "momentum_buffer", "step"}}[optim]
    assert want["optimizer-state-dict"]["param_groups"][0]["lr"] == pytest.approx(0.05)
    if sched == "plateau":
        # a resume takes the cut LR the JAX run would go on with, not the
        # last one its optimizer ran with
        ck = load_checkpoint(path)
        assert ck["scheduler-state-dict"]["lr"] == ck["optimizer-state-dict"]["param_groups"][0]["lr"] == \
            pytest.approx(0.01)


def test_fold_checkpoints_equal_the_jax_exporter(tmp_path, archive):
    """``fit_multifold``'s ``_specXX.pt`` files are msgpack under a ``.pt``
    name; each converts as a ``fit`` checkpoint does."""
    prefix = str(tmp_path / "fold_ck")
    jmf.fit_multifold(archive, [1, 2, 3], JaxTrainConfig(**dict(RECIPE, batch_size=3, train_valid_split=0.8)),
                      checkpoint_prefix=prefix, best_prefix=str(tmp_path / "fold_best"), verbose=False)
    for p in (1, 2, 3):
        path = "{}_spec{:02d}.pt".format(prefix, p)
        assert not is_torch_checkpoint(path)
        want = _exported(tmp_path, path)
        _assert_same(torch_checkpoint_from_jax(path), want)
        assert want["train-idx"] and want["optimizer-state-dict"]["state"]


def test_resume_keeps_the_port_meta_and_the_plateau_lr(jax_run):
    """``load_checkpoint`` of a msgpack file: the exporter's dict plus the
    compute dtype, remat, light-best-nets and flip flags, and the plateau
    LR in the scheduler state and the param group."""
    ck = load_checkpoint(jax_run["checkpoint_filename"])
    assert (ck["compute-dtype"], ck["remat"], ck["light-best-nets"], ck["dup-lr-flip"]) == ("float32", False, False,
                                                                                           False)
    assert ck["scheduler-state-dict"]["lr"] == ck["optimizer-state-dict"]["param_groups"][0]["lr"] == 0.1


def test_load_net_from_msgpack_equals_flax_forward(jax_run, capsys):
    path = jax_run["checkpoint_filename"]
    model, cfg = load_net_from_checkpoint(path, device="cpu")
    assert "JAX (msgpack)" in capsys.readouterr().out
    jmodel, variables, _ = jax_load_net(path)
    x = np.random.default_rng(2).standard_normal((2, 36, 36, 1)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=1e-4)
    assert cfg.num_lands == 14 and cfg.proj_unet_dim == 36


def test_export_cli_runs_without_jax(tmp_path, jax_run):
    """The CLI in a fresh process in which ``import jax`` (and flax, optax,
    the JAX package) fails; its file equals the JAX exporter's."""
    out = str(tmp_path / "cli.pt")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'deepfluoro_tpu'): sys.modules[m] = None\n"
            "from deepfluoro_tpu_torch.cli import export_torch_net\n"
            "export_torch_net.main(sys.argv[1:])\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code, jax_run["checkpoint_filename"], out], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    _assert_same(torch.load(out, map_location="cpu", weights_only=False),
                 _exported(tmp_path, jax_run["checkpoint_filename"]))
    with pytest.raises(SystemExit, match="already a torch checkpoint"):
        export_torch_net.main([out, str(tmp_path / "again.pt")])


def test_fit_resumed_from_a_jax_checkpoint_tracks_jax(tmp_path, archive, jax_run):
    """The JAX package's and the port's ``fit`` each resume a copy of the
    JAX checkpoint for two more epochs."""
    port, jx = _files(tmp_path, "port"), _files(tmp_path, "jax")
    for files in (port, jx):
        shutil.copy(jax_run["checkpoint_filename"], files["checkpoint_filename"])
    jax_fit(archive, [1, 2], JaxTrainConfig(**dict(RECIPE, max_num_epochs=3)), verbose=False, **jx)
    out = fit(archive, [1, 2], TrainConfig(**dict(RECIPE, max_num_epochs=3)), verbose=False, device="cpu", **port)
    assert out["epoch"] == 3 and len(out["valid_losses"]) == 2
    want = read_floats_from_txt(jx["train_loss_txt"])
    np.testing.assert_allclose(out["train_losses"], want, rtol=1e-4)
    np.testing.assert_allclose(read_floats_from_txt(port["valid_loss_txt"]), read_floats_from_txt(jx["valid_loss_txt"]),
                               rtol=1e-3)
    assert not is_torch_checkpoint(jx["checkpoint_filename"]) and is_torch_checkpoint(port["checkpoint_filename"])


def test_fit_multifold_resumed_from_jax_fold_files_tracks_jax(tmp_path, archive):
    """One JAX fold epoch; the JAX package and the port each resume a copy
    of its three msgpack fold files for one more epoch."""
    cfg = dict(RECIPE, batch_size=3, train_valid_split=0.8)
    first = str(tmp_path / "first")
    jmf.fit_multifold(archive, [1, 2, 3], JaxTrainConfig(**cfg), checkpoint_prefix=first,
                      best_prefix=str(tmp_path / "fb"), verbose=False)
    runs = {}
    for tag in ("jax", "port"):
        for p in (1, 2, 3):
            shutil.copy("{}_spec{:02d}.pt".format(first, p), str(tmp_path / "{}_spec{:02d}.pt".format(tag, p)))
        kw = dict(checkpoint_prefix=str(tmp_path / tag), best_prefix=str(tmp_path / (tag + "_best")),
                  train_loss_txt_prefix=str(tmp_path / (tag + "_loss")),
                  valid_loss_txt_prefix=str(tmp_path / (tag + "_valid")), verbose=False)
        if tag == "jax":
            runs[tag] = jmf.fit_multifold(archive, [1, 2, 3], JaxTrainConfig(**dict(cfg, max_num_epochs=2)), **kw)
        else:
            runs[tag] = fit_multifold(archive, [1, 2, 3], TrainConfig(**dict(cfg, max_num_epochs=2)), device="cpu",
                                      **kw)
    for p in (1, 2, 3):
        want = read_floats_from_txt(str(tmp_path / "jax_loss_spec{:02d}.txt".format(p)))
        got = read_floats_from_txt(str(tmp_path / "port_loss_spec{:02d}.txt".format(p)))
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(read_floats_from_txt(str(tmp_path / "port_valid_spec{:02d}.txt".format(p))),
                                   read_floats_from_txt(str(tmp_path / "jax_valid_spec{:02d}.txt".format(p))), rtol=1e-3)
    assert runs["port"]["epoch"] == runs["jax"]["epoch"] == 2


# ----- the committed JAX fixture of chip_smoke.py's phase 11(a) ----------------

FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "torch_port")


def _fixture_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location("write_jax_ckpt_fixture",
                                                  os.path.join(REPO, "scripts", "write_jax_ckpt_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_paths(d):
    name = _fixture_script().NAME
    return os.path.join(d, name + ".msgpack"), os.path.join(d, name + ".npz")


def _assert_tree_close(a, b, where="tree"):
    """Equal trees, float arrays within 1e-5 relative (a regenerated run
    may sum in another order on another host's thread count)."""
    if isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_tree_close(a[k], b[k], "{}/{}".format(where, k))
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-7), where
    else:
        _assert_tree_equal(a, b, where)


def test_fixture_regenerates_equal_to_the_committed_files(tmp_path):
    ck_path, npz_path = _fixture_script().write(str(tmp_path))
    want_ck, want_npz = _fixture_paths(FIXTURE_DIR)
    assert os.path.getsize(want_ck) <= 2 * 1024 * 1024
    _assert_tree_close(msgpack_lite.read(ck_path), msgpack_lite.read(want_ck))
    got, want = np.load(npz_path), np.load(want_npz)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        _assert_tree_close(got[k], want[k], k)


def test_fixture_converts_to_the_exporters_state_dict_and_forward():
    ck_path, npz_path = _fixture_paths(FIXTURE_DIR)
    ref = np.load(npz_path)
    ck = torch_checkpoint_from_jax(ck_path)
    sd = ck["model-state-dict"]
    assert sorted("sd/" + k for k in sd) == sorted(k for k in ref.files if k.startswith("sd/"))
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref["sd/" + k], err_msg=k)
    state = ck["optimizer-state-dict"]["state"]
    assert sorted("mom/{}".format(i) for i in state) == sorted(k for k in ref.files if k.startswith("mom/"))
    for i, e in state.items():
        np.testing.assert_array_equal(e["momentum_buffer"].numpy(), ref["mom/{}".format(i)])
    assert ck["optimizer-state-dict"]["param_groups"][0]["lr"] == float(ref["param_group_lr"])
    model, cfg = load_net_from_checkpoint(ck_path, device="cpu", verbose=False)
    assert (cfg.depth, cfg.init_feats_exp, cfg.proj_unet_dim) == (6, 1, 192)
    with torch.no_grad():
        seg, heats = model(torch.from_numpy(ref["forward_input"]))
    s = int(ref["forward_subsample"])
    np.testing.assert_allclose(seg.numpy()[:, :, ::s, ::s], ref["forward_seg"], atol=1e-4)
    np.testing.assert_allclose(heats.numpy()[:, :, ::s, ::s], ref["forward_heats"], atol=1e-4)


def test_fit_resumed_from_the_fixture_tracks_the_jax_losses(tmp_path):
    """What phase 11(a) runs on the card, here on the CPU: the port's fit
    resumed from the committed msgpack file for one epoch, on the same
    data made in memory."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data

    mod = _fixture_script()
    ck_path, npz_path = _fixture_paths(FIXTURE_DIR)
    ref = np.load(npz_path)
    files = _files(tmp_path, "fx")
    shutil.copy(ck_path, files["checkpoint_filename"])
    data = make_synthetic_data(**mod.DATA)
    out = fit(data, mod.PATS, TrainConfig(**dict(mod.RECIPE, max_num_epochs=2)), verbose=False, device="cpu",
              **files)
    np.testing.assert_allclose(out["train_losses"], ref["resumed_train_losses"], rtol=1e-4)
    np.testing.assert_allclose(out["valid_losses"], ref["resumed_valid_losses"], rtol=1e-3)
