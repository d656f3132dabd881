"""The port's overlays and projective geometry (deepfluoro_tpu_torch/viz and
its five CLIs) against the JAX package's (deepfluoro_tpu/viz), on the CPU.

The blends repeat the JAX package's float32 operations one for one, so
their RGB values are equal, and after the uint8 quantization so are the
pixels; PIL draws the same marks, so the PNGs decode to equal pixels. The
geometry is float64 on both sides: within 1e-12 of each result's scale
(a 3x3 inverse and a few products, summed in another order). vtk is on
neither the tests' machine nor the card's: the viewer runs under the
recording fake vtk of tests/test_projective_scene.py for both packages,
and the scenes are compared object by object."""

import math

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from deepfluoro_tpu.data.fixtures import write_synthetic_dataset as jax_write_synthetic_dataset
from deepfluoro_tpu.data.fixtures import write_synthetic_fullres_dataset as jax_write_fullres
from deepfluoro_tpu.viz import examples as jax_examples
from deepfluoro_tpu.viz import overlays as jax_overlays
from deepfluoro_tpu.viz import projective as jax_projective
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset, write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.viz import examples, overlays, projective
from test_projective_scene import _install_fake_vtk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quantize(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _frames(seed, b=6, h=29, w=35):
    """Projections, labels 0..7 and heats of ``b`` frames; with 5 or more,
    the heats of frames 2-4 are flat (range 0, 5e-4 and just above 1e-3)."""
    rng = np.random.default_rng(seed)
    projs = (rng.standard_normal((b, h, w)) * 3 + 1).astype(np.float32)
    segs = rng.integers(0, 8, (b, h, w)).astype(np.uint8)
    heats = rng.random((b, h, w)).astype(np.float32)
    if b >= 5:
        heats[2] = 0.25
        heats[3] = 0.5 + 5e-4 * rng.random((h, w)).astype(np.float32)
        heats[4] = 0.5 + 1.5e-3 * rng.random((h, w)).astype(np.float32)
    return projs, segs, heats


@pytest.mark.parametrize("num_classes", [7, 8, 3])
def test_seg_blend_equals_jax_per_frame_and_in_a_batch(num_classes):
    projs, segs, _ = _frames(num_classes)
    got = overlays.blend_seg(overlays.normalized_proj_rgb(torch.from_numpy(projs)), torch.from_numpy(segs),
                             num_classes)
    assert got.shape == (*projs.shape, 3) and got.dtype == torch.float32
    for i in range(len(projs)):
        want = jax_overlays.blend_seg(jax_overlays.normalized_proj_rgb(projs[i]), segs[i], num_classes)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(overlays.to_uint8(got[i]).numpy(), _quantize(want))
        one = overlays.blend_seg(overlays.normalized_proj_rgb(torch.from_numpy(projs[i])),
                                 torch.from_numpy(segs[i]), num_classes)
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())


@pytest.mark.parametrize("color", [(0.0, 1.0, 0.0), (1.0, 0.5, 0.25)], ids=["green", "orange"])
def test_heat_blend_equals_jax_with_flat_frames(color):
    projs, _, heats = _frames(1)
    rgb = overlays.normalized_proj_rgb(torch.from_numpy(projs))
    got = overlays.blend_heat(rgb, torch.from_numpy(heats), color)
    for i in range(len(projs)):
        want = jax_overlays.blend_heat(jax_overlays.normalized_proj_rgb(projs[i]), heats[i], color)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(overlays.to_uint8(got[i]).numpy(), _quantize(want))
    # a constant frame blends nothing, a range <= 1e-3 stays unnormalized;
    # a wider one reaches the color at its max
    assert torch.equal(got[2], rgb[2]) and float((got[3] - rgb[3]).abs().max()) <= 1e-3
    peak = np.unravel_index(int(np.argmax(heats[4])), heats[4].shape)
    assert float(heats[4].max() - heats[4].min()) > 1e-3 and got[4][peak].tolist() == list(color)


@pytest.mark.parametrize("n", [1, 3, 8, 11, 17])
def test_tile_images_equals_jax(n):
    imgs = np.random.default_rng(n).random((n, 5, 7, 3)).astype(np.float32)
    got = examples.tile_images(torch.from_numpy(imgs))
    np.testing.assert_array_equal(got.numpy(), jax_examples.tile_images(imgs))
    np.testing.assert_array_equal(examples.tile_images(torch.from_numpy(imgs), nrow=4, padding=3).numpy(),
                                  jax_examples.tile_images(imgs, nrow=4, padding=3))


def _png(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("case", ["seg-gt-csv", "seg-only", "no-seg-gt", "csv-only"])
def test_make_overlay_est_ann_png_equals_jax(tmp_path, case):
    projs, segs, _ = _frames(2, b=1, h=40, w=48)
    rng = np.random.default_rng(3)
    gt = (rng.random((2, 6)) * [[48], [40]]).astype(np.float32)
    gt[0, 1] = np.inf
    gt[1, 4] = np.inf
    csv = {2: (10, 12), 5: (30, 7), 0: (47, 39)}
    seg = None if case.startswith("no-seg") or case == "csv-only" else segs[0]
    gt_lands = gt if "gt" in case else None
    est = csv if "csv" in case else None
    paths = {k: str(tmp_path / "{}.png".format(k)) for k in ("jax", "port")}
    jax_overlays.make_overlay_est_ann(projs[0], seg, gt_lands, est, paths["jax"])
    overlays.make_overlay_est_ann(torch.from_numpy(projs[0]), None if seg is None else torch.from_numpy(seg),
                                  gt_lands, est, paths["port"])
    got, want = _png(paths["port"]), _png(paths["jax"])
    assert got.shape == (40, 48, 3)
    np.testing.assert_array_equal(got, want)


def test_make_overlay_est_heat_png_equals_jax(tmp_path):
    projs, _, heats = _frames(4, b=2, h=40, w=48)
    for i in range(2):
        paths = [str(tmp_path / "{}_{}.png".format(k, i)) for k in ("jax", "port")]
        jax_overlays.make_overlay_est_heat(projs[i], heats[i], paths[0])
        overlays.make_overlay_est_heat(torch.from_numpy(projs[i]), torch.from_numpy(heats[i]), paths[1])
        np.testing.assert_array_equal(_png(paths[1]), _png(paths[0]))


def test_read_est_lands_csv_equals_jax(tmp_path):
    path = str(tmp_path / "l.csv")
    with open(path, "w") as f:
        f.write("pat,proj,land,row,col,time\n1,0,0,5,6,0.1\n1,0,1,-1,-1,0.1\n1,1,0,7,8,0.1\n2,0,3,9,10,0.1\n")
    for pat, proj in ((1, 0), (1, 1), (2, 0), (3, 0)):
        assert overlays.read_est_lands_csv(path, pat, proj) == jax_overlays.read_est_lands_csv(path, pat, proj)
    with open(path, "a") as f:
        f.write("1,0,0,1,1,0.1\n")
    with pytest.raises(ValueError, match="twice"):
        overlays.read_est_lands_csv(path, 1, 0)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Each package's fixture archives, preprocessed (2 specimens of 11
    frames of 40^2, 14 landmarks) and full-res (2 specimens of 3 frames of
    148^2)."""
    d = tmp_path_factory.mktemp("viz")
    return {
        "jax": {"pre": jax_write_synthetic_dataset(str(d / "jax_pre.h5"), num_specimens=2, num_projs=11, img_dim=40),
                "full": jax_write_fullres(str(d / "jax_full.h5"), num_specimens=2, num_projs=3)},
        "port": {"pre": write_synthetic_dataset(str(d / "port_pre.h5"), num_specimens=2, num_projs=11, img_dim=40),
                 "full": write_synthetic_fullres_dataset(str(d / "port_full.h5"), num_specimens=2, num_projs=3)},
        "dir": d,
    }


@pytest.mark.parametrize("kind", ["pre", "full"])
def test_dataset_overlays_equal_jax(archives, kind, tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    if kind == "pre":
        want = jax_examples.make_preproc_overlays(archives["jax"]["pre"], str(jdir))
        got = examples.make_preproc_overlays(archives["port"]["pre"], str(pdir), device="cpu")
    else:
        want = jax_examples.make_full_res_overlays(archives["jax"]["full"], str(jdir))
        got = examples.make_full_res_overlays(archives["port"]["full"], str(pdir), device="cpu")
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want] and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_png(g), _png(w))


def _rigid(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    m = np.eye(4)
    m[:3, :3] = q * np.sign(np.linalg.det(q))
    m[:3, 3] = rng.standard_normal(3) * 100
    return m


def _geometry_inputs():
    rng = np.random.default_rng(7)
    k = np.array([[-5257.73, 0.0, 767.5], [0.0, -5257.73, 767.5], [0.0, 0.0, 1.0]])
    k[:2] += rng.standard_normal((2, 3)) * [[10.0, 0.5, 3.0], [0.5, 10.0, 3.0]]
    return rng, k


GEOMETRY = {
    "invert_rigid": lambda mod, rng, k: mod.invert_rigid(_rigid(rng)),
    "focal_len_two_spacings": lambda mod, rng, k: mod.focal_len_from_intrinsic(k, 0.194, 0.21),
    "focal_len_one_spacing": lambda mod, rng, k: mod.focal_len_from_intrinsic(k, 0.194),
    "pixel_index_to_detector_pt": lambda mod, rng, k: mod.pixel_index_to_detector_pt((1203.5, 17.25), k, 0.194, 0.21),
    "vol_to_camera_xform": lambda mod, rng, k: mod.vol_to_camera_xform(_rigid(rng), _rigid(rng)),
    "vol_to_camera_xform_identity": lambda mod, rng, k: mod.vol_to_camera_xform(_rigid(rng)),
    "index_to_physical_matrix": lambda mod, rng, k: mod.index_to_physical_matrix(
        rng.random(3) + 0.5, _rigid(rng)[:3, :3], rng.standard_normal(3) * 50),
    "source_to_detector_rays": lambda mod, rng, k: mod.source_to_detector_rays(
        [(0, 0), (1535, 0), (1535, 1535), (0, 1535)], k, 0.194, 0.194),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_equals_jax_in_float64(name):
    got = GEOMETRY[name](projective, *_geometry_inputs())
    want = GEOMETRY[name](jax_projective, *_geometry_inputs())
    if isinstance(want, float):
        assert isinstance(got, float) and math.isclose(got, want, rel_tol=1e-12)
        return
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * max(1.0, float(np.abs(want).max())))


def test_geometry_keeps_the_tensors_device_and_refuses_a_non_rigid_shape():
    m = torch.eye(4, dtype=torch.float32)
    assert projective.invert_rigid(m).dtype == torch.float64
    with pytest.raises(ValueError, match="4x4"):
        projective.invert_rigid(np.eye(3))


def _scene(reg):
    """Every object the fake vtk recorded, in creation order, as plain
    values; references between them as (class name, creation index)."""
    index = {id(o): (name, i) for name, objs in reg.objs.items() for i, o in enumerate(objs)}

    def norm(v, top=False):
        if not top and id(v) in index:
            return index[id(v)]
        if isinstance(v, np.ndarray):
            return np.asarray(v)
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if hasattr(v, "__dict__"):
            return {"type": type(v).__name__, **{k: norm(x) for k, x in vars(v).items()}}
        if isinstance(v, (int, float, str, bool, type(None), np.generic)):
            return v
        return type(v).__name__

    return {name: [norm(o, top=True) for o in objs] for name, objs in reg.objs.items()}


def _assert_same(got, want, where="scene"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], "{}.{}".format(where, k))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, "{}[{}]".format(where, i))
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * max(1.0, float(np.abs(want).max())), err_msg=where)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert math.isclose(float(got), want, rel_tol=1e-9, abs_tol=1e-9), where
    else:
        assert got == want, where


def _run_scene(monkeypatch, fn):
    reg = _install_fake_vtk(monkeypatch)
    fn()
    return _scene(reg)


@pytest.mark.parametrize("proj_index", [0, 2])
def test_view_3d_scene_builds_jaxs_scene_under_a_fake_vtk(archives, monkeypatch, proj_index):
    want = _run_scene(monkeypatch, lambda: jax_projective.view_3d_scene(archives["jax"]["full"], "17-1882", proj_index))
    got = _run_scene(monkeypatch, lambda: projective.view_3d_scene(archives["port"]["full"], "17-1882", proj_index,
                                                                   device="cpu"))
    assert len(got["vtkActor"]) == len(want["vtkActor"]) > 8 and len(got["vtkMarchingCubes"]) == 4
    _assert_same(got, want)


def test_view_3d_scene_without_vtk_raises_jaxs_import_error(archives):
    import importlib.util

    if importlib.util.find_spec("vtk") is not None:  # pragma: no cover
        pytest.skip("a vtk module is importable in this environment")
    with pytest.raises(ImportError) as got:
        projective.view_3d_scene(archives["port"]["full"], "17-1882", device="cpu")
    with pytest.raises(ImportError) as want:
        jax_projective.view_3d_scene(archives["jax"]["full"], "17-1882")
    assert str(got.value) == str(want.value) and "vtk" in str(got.value)


CLIS = ["overlay_est_ann", "overlay_est_heat", "make_preproc_overlays", "make_full_res_overlays", "full_res_3d_viz"]


@pytest.mark.parametrize("name", CLIS)
def test_cli_help_lists_jaxs_arguments_and_no_gpu(name, capsys):
    """Every port CLI answers --help (exit 0, naming --no-gpu); the argparse
    ones take JAX's arguments in JAX's order plus --no-gpu. JAX's two
    argv-style CLIs have no help."""
    import importlib

    cli = importlib.import_module("deepfluoro_tpu_torch.cli.{}".format(name))
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0 and "--no-gpu" in capsys.readouterr().out
    if hasattr(cli, "build_parser"):
        jax_cli = importlib.import_module("deepfluoro_tpu.cli.{}".format(name))
        want = [a.dest for a in jax_cli.build_parser()._actions]
        assert [a.dest for a in cli.build_parser()._actions] == want + ["no_gpu"]


@pytest.mark.parametrize("name", ["make_preproc_overlays", "make_full_res_overlays"])
def test_argv_cli_without_a_path_exits_as_jax(name, capsys):
    import importlib

    for pkg, extra in (("deepfluoro_tpu", []), ("deepfluoro_tpu_torch", ["--no-gpu"])):
        cli = importlib.import_module("{}.cli.{}".format(pkg, name))
        with pytest.raises(SystemExit) as e:
            cli.main(extra)
        assert e.value.code == 1
    assert capsys.readouterr().out.count("ERROR: supply path to HDF5 data file") == 2


@pytest.fixture(scope="module")
def nn_file(archives):
    """An nn-file of the contract for specimen 1 of the preprocessed
    archive (11 frames of 40^2: labels, 14 heat channels) and a landmark
    CSV for its frame 3."""
    d = archives["dir"]
    rng = np.random.default_rng(9)
    path = str(d / "nn.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("nn-segs", data=rng.integers(0, 7, (11, 40, 40)).astype(np.uint8), chunks=(1, 40, 40),
                         compression="gzip", compression_opts=9)
        f.create_dataset("nn-heats", data=rng.random((11, 14, 40, 40)).astype(np.float32), chunks=(1, 1, 40, 40),
                         compression="gzip", compression_opts=9)
    csv = str(d / "lands.csv")
    with open(csv, "w") as f:
        f.write("pat,proj,land,row,col,time\n")
        for land in range(14):
            row, col = (-1, -1) if land % 5 == 0 else (int(rng.integers(0, 40)), int(rng.integers(0, 40)))
            f.write("1,3,{},{},{},0.001\n".format(land, row, col))
    return path, csv


def _cli_args(name, archive, nn, csv, out):
    if name == "overlay_est_ann":
        return [archive, nn, "nn-segs", "1", "3", out, "--lands", "--lands-csv", csv]
    if name == "overlay_est_heat":
        return [archive, nn, "nn-heats", "1", "3", "5", out]
    return [archive, out]


@pytest.mark.parametrize("name", CLIS)
def test_cli_writes_jaxs_png(archives, nn_file, name, tmp_path, monkeypatch):
    import importlib

    nn, csv = nn_file
    kind = "full" if "full_res" in name else "pre"
    outs = {}
    for pkg, side, extra in (("deepfluoro_tpu", "jax", []), ("deepfluoro_tpu_torch", "port", ["--no-gpu"])):
        cli = importlib.import_module("{}.cli.{}".format(pkg, name))
        out = tmp_path / side
        out.mkdir()
        if name == "full_res_3d_viz":
            outs[side] = _run_scene(monkeypatch, lambda: cli.main([archives[side]["full"], "17-1882", "--proj", "1",
                                                                    *extra]))
            continue
        target = str(out / "o.png") if name.startswith("overlay") else str(out)
        cli.main(_cli_args(name, archives[side][kind], nn, csv, target) + extra)
        outs[side] = {p.name: _png(p) for p in sorted(out.iterdir())}
    if name == "full_res_3d_viz":
        _assert_same(outs["port"], outs["jax"])
        return
    assert sorted(outs["port"]) == sorted(outs["jax"]) and outs["port"]
    for k in outs["jax"]:
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k])


@pytest.mark.parametrize("name", CLIS)
def test_cli_without_a_card_refuses_unless_no_gpu(archives, nn_file, name, tmp_path, monkeypatch):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot happen")
    nn, csv = nn_file
    cli = importlib.import_module("deepfluoro_tpu_torch.cli.{}".format(name))
    if name == "full_res_3d_viz":
        _install_fake_vtk(monkeypatch)
        args = [archives["port"]["full"], "17-1882"]
    else:
        kind = "full" if "full_res" in name else "pre"
        args = _cli_args(name, archives["port"][kind], nn, csv, str(tmp_path / "o.png") if name.startswith(
            "overlay") else str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
