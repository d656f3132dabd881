"""The port's full-resolution preprocessing (deepfluoro_tpu_torch.data.
preprocess, the full-res fixture and the preprocess_full_res CLI) against
the JAX package's, on the CPU.

Raw frames come from the full-res fixture (148^2, seed-made) or from a
numpy generator. Tolerances: intensities within 1e-5 (both resize with
the same triangle filter; JAX computes its weights in float32, the port in
float64: 3.8e-6 apart at 1536 -> 179, 2.4e-7 at 148 -> 12), label maps and
the fixture archive exact, landmarks within 1e-5 (the same float64
formulas)."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import image as jimage

from deepfluoro_tpu.cli import preprocess_full_res as jax_cli
from deepfluoro_tpu.data import preprocess as jpre
from deepfluoro_tpu.data.fixtures import write_synthetic_fullres_dataset as jax_write_fullres
from deepfluoro_tpu.data.hdf5 import load_dataset as jax_load_dataset
from deepfluoro_tpu_torch.cli import preprocess_full_res as port_cli
from deepfluoro_tpu_torch.data import preprocess as tpre
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data, write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.data.hdf5 import load_dataset

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


@pytest.fixture(scope="module")
def raw():
    """Two specimens of the full-res fixture: raw frames, labels, landmarks
    and rot-180 flags."""
    return make_synthetic_fullres_data(num_specimens=2, num_projs=3, img_dim=148, seed=3)


# factors 2 and 4 divide the 48-pixel crop; 5 and 16 do not (9 and 3 px)
@pytest.mark.parametrize("factor", [2, 4, 5, 16])
@pytest.mark.parametrize("rot", [False, True], ids=["upright", "rot180"])
def test_preprocess_projection_matches_jax(raw, factor, rot):
    img, seg = raw[0]["projs"][1], raw[0]["segs"][1].astype(np.float32)
    want = np.asarray(jpre.preprocess_projection(jnp.asarray(img), factor, rot, False))
    got = tpre.preprocess_projection(torch.from_numpy(img), factor, rot, False).numpy()
    assert got.shape == want.shape == (48 // factor, 48 // factor)
    np.testing.assert_allclose(got, want, atol=ATOL)
    want = np.asarray(jpre.preprocess_projection(jnp.asarray(seg), factor, rot, True))
    got = tpre.preprocess_projection(torch.from_numpy(seg), factor, rot, True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst,exact_differs", [(1436, 179, False), (1336, 83, True)], ids=["8x", "16x"])
def test_resizes_match_jax_where_torchs_own_modes_do_not(src, dst, exact_differs):
    """jax.image.resize's linear method antialiases, which torch's plain
    bilinear does not. Its nearest index rule is not torch's "nearest",
    and at 1336 -> 83 not "nearest-exact" either."""
    rng = np.random.default_rng(src)
    img = rng.random((src, src)).astype(np.float32)
    labels = rng.integers(0, 7, (src, src)).astype(np.float32)
    want = np.asarray(jimage.resize(jnp.asarray(img), (dst, dst), "linear"))
    np.testing.assert_allclose(tpre.resize_linear(torch.from_numpy(img), (dst, dst)).numpy(), want, atol=ATOL)
    plain = F.interpolate(torch.from_numpy(img)[None, None], size=(dst, dst), mode="bilinear", align_corners=False)
    assert np.abs(plain[0, 0].numpy() - want).max() > 0.1

    want = np.asarray(jimage.resize(jnp.asarray(labels), (dst, dst), "nearest"))
    np.testing.assert_array_equal(tpre.resize_nearest(torch.from_numpy(labels), (dst, dst)).numpy(), want)
    for mode in ("nearest", "nearest-exact"):
        other = F.interpolate(torch.from_numpy(labels)[None, None], size=(dst, dst), mode=mode)[0, 0].numpy()
        if mode == "nearest" or exact_differs:
            assert (other != want).mean() > 0.01, mode


@pytest.mark.parametrize("factor", [2, 3, 16])
@pytest.mark.parametrize("rot", [False, True], ids=["upright", "rot180"])
def test_preprocess_landmarks_match_jax(raw, factor, rot):
    lands = raw[1]["lands"][0].astype(np.float64)
    want = jpre.preprocess_landmarks(lands, (148, 148), factor, rot)
    got = tpre.preprocess_landmarks(lands, (148, 148), factor, rot)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("factor,pad_dim", [(2, 36), (4, 20), (3, 26), (2, 24)])
def test_make_fullres_prep_matches_jax(raw, factor, pad_dim):
    """The fused prep over a batch with mixed rot-180 flags: (B, 1, P, P)
    against JAX's (B, P, P, 1); 3 does not divide the crop; at pad 24 the
    2x frame is already 24^2 and is not padded."""
    projs = np.concatenate([raw[0]["projs"], raw[1]["projs"][:1]])
    rots = np.array([True, False, True, False])
    jprep, jhw = jpre.make_fullres_prep(factor, pad_dim, (148, 148))
    want = np.asarray(jprep(jnp.asarray(projs), jnp.asarray(rots)))[..., 0]
    prep, hw = tpre.make_fullres_prep(factor, pad_dim, (148, 148))
    got = prep(torch.from_numpy(projs), torch.from_numpy(rots))
    assert hw == jhw and tuple(got.shape) == (4, 1) + want.shape[1:]
    np.testing.assert_allclose(got[:, 0].numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="square"):
        tpre.make_fullres_prep(factor, pad_dim, (148, 160))


def test_fullres_fixture_is_byte_equal_to_jax(tmp_path, raw):
    ours = write_synthetic_fullres_dataset(str(tmp_path / "ours.h5"), num_specimens=2, num_projs=3, seed=3)
    theirs = jax_write_fullres(str(tmp_path / "theirs.h5"), num_specimens=2, num_projs=3, seed=3)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with h5py.File(ours, "r") as f:
        np.testing.assert_array_equal(f["18-1109/projections/002/image/pixels"][:], raw[1]["projs"][2])
        assert int(f["18-1109/projections/002/rot-180-for-up"][()]) == 1


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    d = tmp_path_factory.mktemp("pre")
    return str(write_synthetic_fullres_dataset(str(d / "full.h5"), num_specimens=2, num_projs=3, seed=3))


def _assert_archives_match(ours, theirs):
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for spec in (k for k in b.keys() if k != "land-names"):
            assert sorted(a[spec].keys()) == sorted(b[spec].keys()) == ["lands", "projs", "segs"]
            np.testing.assert_allclose(a[spec]["projs"][:], b[spec]["projs"][:], atol=ATOL)
            assert a[spec]["segs"].dtype == b[spec]["segs"].dtype == np.uint8
            np.testing.assert_array_equal(a[spec]["segs"][:], b[spec]["segs"][:])
            np.testing.assert_allclose(a[spec]["lands"][:], b[spec]["lands"][:], atol=ATOL)
        names = lambda f: [f["land-names"]["land-{:02d}".format(i)][()] for i in range(f["land-names/num-lands"][()])]  # noqa: E731
        assert names(a) == names(b)


@pytest.mark.parametrize("factor", [2, 4])
def test_full_res_to_preprocessed_matches_jax_and_loads(tmp_path, archive, factor):
    ours = tpre.full_res_to_preprocessed(archive, str(tmp_path / "ours.h5"), factor, device="cpu")
    theirs = jpre.full_res_to_preprocessed(archive, str(tmp_path / "theirs.h5"), factor)
    _assert_archives_match(ours, theirs)
    got, want = load_dataset(ours, [1, 2]), jax_load_dataset(theirs, [1, 2])
    assert got.orig_img_shape == want.orig_img_shape == (48 // factor, 48 // factor)
    np.testing.assert_allclose(got.projs, want.projs, atol=ATOL)
    np.testing.assert_array_equal(got.segs, want.segs)
    np.testing.assert_allclose(got.lands, want.lands, atol=ATOL)  # out-of-view landmarks are inf in both
    assert np.isinf(got.lands).any()


def test_partial_ground_truth_is_refused(tmp_path, archive):
    import shutil

    path = str(tmp_path / "partial.h5")
    shutil.copyfile(archive, path)
    with h5py.File(path, "a") as f:
        del f["17-1882/projections/001/gt-seg"]
    with pytest.raises(ValueError, match="1 of 3|2 of 3"):
        tpre.full_res_to_preprocessed(path, str(tmp_path / "out.h5"), 4, device="cpu")


def test_preprocess_cli_matches_jax(tmp_path, archive, capsys):
    jax_cli.main([archive, str(tmp_path / "theirs.h5"), "--ds-factor", "4", "--no-gpu"])
    port_cli.main([archive, str(tmp_path / "ours.h5"), "--ds-factor", "4", "--no-gpu"])
    assert "wrote {}".format(tmp_path / "ours.h5") in capsys.readouterr().out
    _assert_archives_match(str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main([archive, str(tmp_path / "card.h5"), "--ds-factor", "4"])
