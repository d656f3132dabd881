"""The port's HDF5 chunk codec (deepfluoro_tpu_torch/native, the g++ build
of csrc/chunkzip.cpp) against the JAX package's (deepfluoro_tpu/native,
which builds its own copy of the same source) and against serial zlib, on
the CPU; and the ensemble writer and Dice CLI that go through it.

Both libraries link this machine's zlib, so their level-9 streams are
byte-identical, and equal to Python's ``zlib.compress``. The port never
falls back to serial zlib: a failed build raises with the compiler's
output. End to end, the port's and JAX's ensembles on the same members
write label chunks that are byte-identical; their heats differ in the last
float32 bits (the convolutions sum in another order, within 1e-5), so each
package's heat chunks are held to the other package's codec applied to its
own arrays, and JAX's arrays written through the port's writer give JAX's
file chunk for chunk."""

import zlib

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluoro_tpu.data.hdf5 import load_dataset as jax_load_dataset
from deepfluoro_tpu.infer.ensemble import seg_dataset_ensemble as jax_seg_dataset_ensemble
from deepfluoro_tpu.native import compress_chunks as jax_compress_chunks
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu.train.config import build_model as jax_build_model
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.data.hdf5 import load_dataset
from deepfluoro_tpu_torch.infer import seg_dataset_ensemble
from deepfluoro_tpu_torch.infer.ensemble import write_ensemble_outputs
from deepfluoro_tpu_torch.native import chunkzip
from deepfluoro_tpu_torch.native import (
    compress_chunks,
    compress_chunks_plain,
    decompress_chunks,
    decompress_chunks_plain,
    native_available,
    read_dataset_direct,
    write_dataset_direct,
)
from deepfluoro_tpu_torch.ops import _build
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model

CFG = dict(num_classes=7, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(rng):
    """The contract's two payloads at a small size: labels u1 (5, 24, 28)
    and heats float32 (5, 3, 24, 28), smooth as heatmaps are."""
    labels = rng.integers(0, 7, (5, 24, 28)).astype(np.uint8)
    yy, xx = np.mgrid[:24, :28]
    centers = rng.random((5, 3, 2)) * (24, 28)
    heats = np.exp(-((yy - centers[..., :1, None]) ** 2 + (xx - centers[..., 1:, None]) ** 2) / 20.0)
    return labels, heats.astype(np.float32)


@pytest.mark.parametrize("kind", ["u1", "float32"])
def test_streams_equal_jax_and_serial_zlib(kind):
    labels, heats = _arrays(np.random.default_rng(0))
    data = labels if kind == "u1" else heats.reshape(-1, 24, 28)
    ours = compress_chunks(data, level=9)
    assert ours == jax_compress_chunks(data.reshape(data.shape[0], -1), level=9)
    assert ours == compress_chunks_plain(data, level=9)
    assert ours == [zlib.compress(d.tobytes(), 9) for d in data]
    assert ours == compress_chunks(data, level=9, n_threads=1)


@pytest.mark.parametrize("n_threads", [None, 1, 3])
@pytest.mark.parametrize("kind", ["u1", "float32"])
def test_round_trip_native_and_plain(kind, n_threads):
    labels, heats = _arrays(np.random.default_rng(1))
    data = labels if kind == "u1" else heats
    blobs = compress_chunks(data, level=6, n_threads=n_threads)
    chunk_bytes = data[0].nbytes
    for flat in (decompress_chunks(blobs, chunk_bytes, n_threads=n_threads),
                 decompress_chunks_plain(blobs, chunk_bytes)):
        assert flat.shape == (data.shape[0], chunk_bytes) and flat.dtype == np.uint8
        np.testing.assert_array_equal(flat.view(data.dtype).reshape(data.shape), data)


def test_empty_and_size_mismatch():
    assert compress_chunks(np.zeros((0, 10), np.float32)) == []
    assert compress_chunks_plain(np.zeros((0, 10), np.float32)) == []
    assert decompress_chunks([], 40).shape == (0, 40)
    blobs = compress_chunks(np.ones((2, 10), np.float32))
    for inflate in (decompress_chunks, decompress_chunks_plain):
        with pytest.raises(chunkzip.InflateError):
            inflate(blobs, 39)
    with pytest.raises(chunkzip.InflateError):
        decompress_chunks([b"not a zlib stream"], 40)
    with pytest.raises(ValueError, match="chunk axis"):
        compress_chunks(np.float32(1.0))


def _gzip_file(path, labels):
    with h5py.File(path, "w") as f:
        d = f.create_dataset("nn-segs", labels.shape, dtype="u1", chunks=(1, *labels.shape[1:]), compression="gzip",
                             compression_opts=9)
        d[:] = labels
    return path


def _fresh_build(monkeypatch, tmp_path):
    """No library built or loaded: the next use compiles into ``tmp_path``."""
    monkeypatch.setattr(_build, "build_dir", lambda root=None: tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})


def test_missing_compiler_raises_and_nothing_goes_serial(monkeypatch, tmp_path):
    labels, _ = _arrays(np.random.default_rng(2))
    path = _gzip_file(str(tmp_path / "segs.h5"), labels)
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        compress_chunks(labels)
    with pytest.raises(RuntimeError, match="not found"):
        decompress_chunks([zlib.compress(b"x")], 1)
    with h5py.File(path, "r") as f:
        with pytest.raises(RuntimeError, match="not found"):
            read_dataset_direct(f["nn-segs"], force_direct=True)
    with h5py.File(str(tmp_path / "out.h5"), "w") as f:
        d = f.create_dataset("nn-segs", labels.shape, dtype="u1", chunks=(1, 24, 28), compression="gzip",
                             compression_opts=9)
        with pytest.raises(RuntimeError, match="not found"):
            write_dataset_direct(d, 0, labels)
    assert not native_available()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))


def test_failing_compile_raises_with_the_compilers_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "HOST_CXX_FLAGS", _build.HOST_CXX_FLAGS + ("-fno-such-option-here",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for chunkzip:(.|\n)*no-such-option-here"):
        compress_chunks(np.ones((2, 4), np.uint8))
    assert "no-such-option-here" in _build.build_logs["chunkzip"]


def test_library_is_built_by_g_plus_plus_and_keyed_by_source_and_flags(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    path = _build.library_path("chunkzip")
    assert path.parent == tmp_path / "build" and path.name.startswith("chunkzip_")
    assert _build.source_path("chunkzip").name == "chunkzip.cpp"
    assert native_available() and path.exists()
    monkeypatch.setattr(_build, "HOST_CXX_FLAGS", _build.HOST_CXX_FLAGS + ("-g",))
    assert _build.library_path("chunkzip") != path
    assert _build.source_path("affine_warp").name == "affine_warp.cu"


@pytest.mark.parametrize("rank", [3, 4])
def test_direct_write_reads_back_through_plain_h5py_and_the_direct_read(tmp_path, rank):
    labels, heats = _arrays(np.random.default_rng(3))
    data = labels if rank == 3 else heats
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data.shape, dtype=data.dtype, chunks=(1,) * (rank - 2) + data.shape[-2:],
                             compression="gzip", compression_opts=9)
        write_dataset_direct(d, 0, data[:2])
        write_dataset_direct(d, 2, data[2:])
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["x"][:], data)
        got = read_dataset_direct(f["x"], force_direct=True)
        assert got.dtype == data.dtype
        np.testing.assert_array_equal(got, data)


def test_direct_read_takes_dset_for_other_layouts_and_unwritten_chunks(tmp_path):
    labels, _ = _arrays(np.random.default_rng(4))
    path = str(tmp_path / "l.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("shuffled", data=labels, chunks=(1, 24, 28), compression="gzip", shuffle=True)
        f.create_dataset("big_chunks", data=labels, chunks=(2, 24, 28), compression="gzip")
        f.create_dataset("plain", data=labels)
        part = f.create_dataset("partial", labels.shape, dtype="u1", chunks=(1, 24, 28), compression="gzip")
        part[0] = labels[0]
    with h5py.File(path, "r") as f:
        for name in ("shuffled", "big_chunks", "plain"):
            np.testing.assert_array_equal(read_dataset_direct(f[name], force_direct=True), labels)
        want = np.zeros_like(labels)
        want[0] = labels[0]
        np.testing.assert_array_equal(read_dataset_direct(f["partial"], force_direct=True), want)


def test_direct_write_refuses_other_layouts_and_out_of_range_rows(tmp_path):
    labels, _ = _arrays(np.random.default_rng(5))
    with h5py.File(str(tmp_path / "w.h5"), "w") as f:
        big = f.create_dataset("big", labels.shape, dtype="u1", chunks=(2, 24, 28), compression="gzip")
        plain = f.create_dataset("plain", labels.shape, dtype="u1", chunks=(1, 24, 28))
        ok = f.create_dataset("ok", labels.shape, dtype="u1", chunks=(1, 24, 28), compression="gzip")
        for d in (big, plain):
            with pytest.raises(ValueError, match="per-image gzip"):
                write_dataset_direct(d, 0, labels)
        with pytest.raises(ValueError, match="does not fit"):
            write_dataset_direct(ok, 3, labels)
        with pytest.raises(ValueError, match="does not fit"):
            write_dataset_direct(ok, 0, labels[:, :12])


def _raw_chunks(dset):
    shape = dset.shape
    coords = [(i, 0, 0) for i in range(shape[0])] if len(shape) == 3 else \
        [(i, j, 0, 0) for i in range(shape[0]) for j in range(shape[1])]
    pairs = [dset.id.read_direct_chunk(c) for c in coords]
    assert all(mask == 0 for mask, _ in pairs)
    return [bytes(b) for _, b in pairs]


@pytest.fixture(scope="module")
def ensemble_files(tmp_path_factory):
    """Both packages' seg_dataset_ensemble on one fixture archive and the
    same two members (flax variables drawn from a seed, carried to the port
    by compat.from_jax), batches of 4 over 6 frames of 32^2 padded to 36."""
    d = tmp_path_factory.mktemp("nn")
    ds = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=2, num_projs=6, img_dim=32, seed=3)
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 36, 36, 1)), train=False))
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    members = [{"params": jax.tree_util.tree_map_with_path(draw, shapes["params"]),
                "batch_stats": jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])} for _ in range(2)]
    ports = []
    for v in members:
        model = build_model(TrainConfig(**CFG, proj_unet_dim=36))
        model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], model))
        ports.append(model.eval())
    out = {"jax": str(d / "jax.h5"), "port": str(d / "port.h5")}
    with h5py.File(out["jax"], "w") as f:
        jax_seg_dataset_ensemble(jax_load_dataset(ds, [2], no_seg=True), [(jmodel, v) for v in members], f,
                                 num_lands=14, batch_size=4, pad_img_dim=36)
    with h5py.File(out["port"], "w") as f:
        seg_dataset_ensemble(load_dataset(ds, [2], no_seg=True), ports, f, num_lands=14, batch_size=4,
                             pad_img_dim=36)
    return d, ds, out


def test_ensemble_writer_goes_through_the_codec(ensemble_files):
    """The port's file keeps the contract (shapes, dtypes, per-image chunks,
    gzip 9, plain h5py reads it); its label chunks are JAX's byte for byte;
    its heats are JAX's within 1e-5, and each heat chunk is the JAX codec's
    stream of the port's own array."""
    _, _, out = ensemble_files
    with h5py.File(out["jax"], "r") as fj, h5py.File(out["port"], "r") as fp:
        for name in ("nn-segs", "nn-heats"):
            a, b = fj[name], fp[name]
            assert (b.shape, b.dtype, b.chunks, b.compression, b.compression_opts) == (
                a.shape, a.dtype, a.chunks, a.compression, a.compression_opts), name
        assert fp["nn-segs"].shape == (6, 32, 32) and fp["nn-heats"].shape == (6, 14, 32, 32)
        np.testing.assert_array_equal(fp["nn-segs"][:], fj["nn-segs"][:])
        assert _raw_chunks(fp["nn-segs"]) == _raw_chunks(fj["nn-segs"])
        heats = fp["nn-heats"][:]
        np.testing.assert_allclose(heats, fj["nn-heats"][:], atol=ATOL)
        assert _raw_chunks(fp["nn-heats"]) == jax_compress_chunks(heats.reshape(6 * 14, -1), level=9)
        np.testing.assert_array_equal(read_dataset_direct(fp["nn-heats"], force_direct=True), heats)


def test_jax_arrays_through_the_port_writer_give_jaxs_chunks(ensemble_files, tmp_path):
    """The JAX file's arrays fed to write_ensemble_outputs in batches of 4
    (the last partial): every raw chunk of both datasets equals the JAX
    file's."""
    _, _, out = ensemble_files
    with h5py.File(out["jax"], "r") as fj:
        labels, heats = fj["nn-segs"][:], fj["nn-heats"][:]
        want = {name: _raw_chunks(fj[name]) for name in ("nn-segs", "nn-heats")}
    batches = ((s, labels[s:s + 4], heats[s:s + 4]) for s in range(0, 6, 4))
    with h5py.File(str(tmp_path / "w.h5"), "w") as f:
        write_ensemble_outputs(f, batches, 6, (32, 32), 14)
    with h5py.File(str(tmp_path / "w.h5"), "r") as f:
        for name in ("nn-segs", "nn-heats"):
            assert _raw_chunks(f[name]) == want[name], name


def test_dice_cli_reads_through_the_codec_and_matches_jax(ensemble_files, monkeypatch):
    """compute_actual_dice_on_test of both packages on the port's file: the
    same CSV bytes, and the port's CLI read nn-segs by the direct path."""
    from deepfluoro_tpu.cli import compute_actual_dice_on_test as jax_dice
    from deepfluoro_tpu_torch.cli import compute_actual_dice_on_test as port_dice

    d, ds, out = ensemble_files
    calls = []
    real = port_dice.read_dataset_direct
    monkeypatch.setattr(port_dice, "read_dataset_direct", lambda dset: calls.append(dset.name) or real(dset))
    csv = {name: str(d / "{}_dice.csv".format(name)) for name in ("jax", "port")}
    jax_dice.main([ds, out["port"], "nn-segs", csv["jax"], "2"])
    port_dice.main([ds, out["port"], "nn-segs", csv["port"], "2", "--no-gpu"])
    assert calls == ["/nn-segs"]
    assert open(csv["port"], "rb").read() == open(csv["jax"], "rb").read()
    assert len(open(csv["port"]).read().splitlines()) == 1 + 6 * 6  # classes 1-6 of 6 frames
