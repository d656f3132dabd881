"""The port's evaluation (deepfluoro_tpu_torch.eval, the est_lands_csv and
compute_actual_dice_on_test CLIs, and the archive helpers they use)
against the JAX package's, on the same inputs, on the CPU.

Landmark rows and columns, Dice values and both CSVs must be equal (the
landmark CSV apart from its measured ``time`` column): the arithmetic is
float32 on both sides and the decisions (argmax, the 0.9 NCC gate, the
two-decimal Dice) are taken on values far from their thresholds except
where a test puts them there on purpose."""

import h5py
import numpy as np
import pytest
import torch

from deepfluoro_tpu.data import hdf5 as jax_hdf5
from deepfluoro_tpu.eval.dice import hard_dice as jax_hard_dice
from deepfluoro_tpu.eval.dice import write_dice_csv as jax_write_dice_csv
from deepfluoro_tpu.eval.landmarks import detect_landmarks as jax_detect
from deepfluoro_tpu.eval.landmarks import write_landmarks_csv as jax_write_landmarks_csv
from deepfluoro_tpu.utils.io import write_floats_to_txt as jax_write_floats
from deepfluoro_tpu_torch.data import hdf5
from deepfluoro_tpu_torch.data.fixtures import DEFAULT_LAND_NAMES, make_synthetic_data, write_synthetic_dataset
from deepfluoro_tpu_torch.eval import (
    detect_landmarks,
    detect_landmarks_timed,
    hard_dice,
    write_dice_csv,
    write_landmarks_csv,
)
from deepfluoro_tpu_torch.ops.heatmap import synthesize_heatmaps
from deepfluoro_tpu_torch.utils.io import write_floats_to_txt


def _label_maps(seed, n=4, h=24, w=20, num_classes=7):
    """Estimated and true label maps that overlap in part, with class 6
    empty in both and class 5 present only in the estimate; the first
    estimate is the truth itself."""
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 5, (n, h, w)).astype(np.uint8)
    est = np.where(rng.random((n, h, w)) < 0.7, gt, rng.integers(0, 6, (n, h, w))).astype(np.uint8)
    est[0] = gt[0]
    return gt, est


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hard_dice_and_csv_match_jax(tmp_path, seed):
    gt, est = _label_maps(seed)
    want = jax_hard_dice(gt, est, 7)
    got = hard_dice(torch.from_numpy(gt), torch.from_numpy(est), 7)
    assert got.dtype == np.float32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 1.0).all() and (got[:, 5] == 1.0).all() and (got[1:, 4] == 0.0).all()
    jax_write_dice_csv(str(tmp_path / "want.csv"), 3, want)
    write_dice_csv(str(tmp_path / "got.csv"), 3, got)
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()


def test_hard_dice_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="differ in shape"):
        hard_dice(torch.zeros(2, 8, 8, dtype=torch.uint8), torch.zeros(2, 8, 9, dtype=torch.uint8))


def _gaussian_heats(n, l, h, w, seed, border=False):
    """(N, L, H, W) sigma-2.5 Gaussians at random peaks (some within 12 px
    of a border when ``border``), from the port's heatmap synthesis."""
    rng = np.random.default_rng(seed)
    lo, hi = (1, h - 2) if border else (14, h - 15)
    xs = rng.integers(lo, hi, (n, l)).astype(np.float32)
    ys = rng.integers(lo, hi, (n, l)).astype(np.float32)
    lands = torch.from_numpy(np.stack([xs, ys], axis=1))
    return synthesize_heatmaps(lands, h, w).numpy()


def _assert_same_detections(heats, names, segs=None):
    want = jax_detect(heats, names, segs)
    got = detect_landmarks(torch.from_numpy(heats), names, None if segs is None else torch.from_numpy(segs))
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == heats.shape[:2]
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("border", [False, True], ids=["interior", "near-border"])
def test_detect_landmarks_on_gaussian_heats_matches_jax(border):
    """Clean peaks pass the NCC gate in both. Near a border the window
    comes from the reflect pad, which mirrors the peak into it, so some
    fail the gate there, in both."""
    heats = _gaussian_heats(3, 4, 48, 40, seed=1 + border, border=border)
    rows, cols = _assert_same_detections(heats, DEFAULT_LAND_NAMES[:4])
    assert (rows >= 0).all() if not border else 0 < (rows >= 0).sum() < rows.size
    assert np.array_equal(rows[rows >= 0], heats.reshape(12, -1).argmax(1).reshape(3, 4)[rows >= 0] // 40)


def test_detect_landmarks_on_peaks_at_the_border_matches_jax():
    """A peak on the first or last row or column: the reflect pad mirrors
    the Gaussian about that pixel, so the window holds a whole Gaussian and
    passes the gate (an edge-repeating pad would not)."""
    peaks = torch.tensor([[[20.0, 20.0, 0.0, 39.0], [0.0, 47.0, 24.0, 24.0]]])
    heats = synthesize_heatmaps(peaks, 48, 40).numpy()
    rows, cols = _assert_same_detections(heats, DEFAULT_LAND_NAMES[:4])
    assert rows.tolist() == [[0, 47, 24, 24]] and cols.tolist() == [[20, 20, 0, 39]]


def test_detect_landmarks_with_seg_gating_matches_jax():
    """The fixture's true landmarks rendered as heatmaps plus a larger decoy
    peak in the background, more than a window away from every landmark:
    gated by the true label maps the detection finds the landmark, ungated
    the decoy, and an absent class gives -1."""
    data = make_synthetic_data(num_specimens=1, num_projs=3, img_dim=96, seed=4)
    heats = synthesize_heatmaps(torch.from_numpy(data.lands), 96, 96).numpy()
    heats = heats + 3.0 * synthesize_heatmaps(torch.full((1, 2, 14), 14.0), 96, 96).numpy()
    segs = data.segs.copy()
    segs[2][segs[2] == 5] = 0  # FH-l's structure absent in the last frame
    rows, cols = _assert_same_detections(heats.astype(np.float32), DEFAULT_LAND_NAMES, segs)
    assert rows[2, 0] == -1 and (rows >= 0).sum() > 20
    rows_free, cols_free = _assert_same_detections(heats.astype(np.float32), DEFAULT_LAND_NAMES)
    assert (rows_free == 14).all() and (cols_free == 14).all()


def test_detect_landmarks_gate_rejects_a_delta_peak():
    rng = np.random.default_rng(0)
    heats = (rng.random((2, 2, 40, 40)) * 0.5).astype(np.float32)
    heats[:, :, 20, 30] = 1.0
    rows, cols = _assert_same_detections(heats, ["FH-l", "FH-r"])
    assert (rows == -1).all() and (cols == -1).all()


def test_detect_landmarks_timed_and_csv(tmp_path):
    heats = _gaussian_heats(3, 2, 40, 40, seed=5)
    names = ["FH-l", "FH-r"]
    rows, cols = detect_landmarks(torch.from_numpy(heats), names)
    rows_t, cols_t, times = detect_landmarks_timed(torch.from_numpy(heats), names)
    np.testing.assert_array_equal(rows_t, rows)
    np.testing.assert_array_equal(cols_t, cols)
    assert times.shape == (3, 2) and (times > 0).all() and (times[:, 0] == times[:, 1]).all()
    jax_write_landmarks_csv(str(tmp_path / "want.csv"), 2, rows, cols, per_land_time=times)
    write_landmarks_csv(str(tmp_path / "got.csv"), 2, rows, cols, per_land_time=times)
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
    jax_write_landmarks_csv(str(tmp_path / "want0.csv"), 2, rows, cols, no_hdr=True)
    write_landmarks_csv(str(tmp_path / "got0.csv"), 2, rows, cols, no_hdr=True)
    assert (tmp_path / "got0.csv").read_bytes() == (tmp_path / "want0.csv").read_bytes()


def test_detect_landmarks_rejects_bad_inputs():
    with pytest.raises(ValueError, match="landmark names"):
        detect_landmarks(torch.zeros(1, 2, 20, 20), ["FH-l"])
    with pytest.raises(ValueError, match="too small"):
        detect_landmarks(torch.zeros(1, 1, 12, 20), ["FH-l"])


def test_archive_helpers_match_jax(tmp_path):
    path = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=2, num_projs=3, img_dim=24, seed=6)
    assert hdf5.get_orig_img_shape(path, 2) == jax_hdf5.get_orig_img_shape(path, 2) == (24, 24)
    assert hdf5.get_land_names_from_dataset(path) == jax_hdf5.get_land_names_from_dataset(path) == DEFAULT_LAND_NAMES
    got, want = hdf5.load_dataset(path, [2, 1], no_seg=True), jax_hdf5.load_dataset(path, [2, 1], no_seg=True)
    assert got.segs is None and want.segs is None
    np.testing.assert_array_equal(got.projs, want.projs)
    np.testing.assert_array_equal(got.lands, want.lands)
    assert hdf5.load_dataset(path, [1]).segs is not None
    for name, write in (("got", hdf5.write_land_names), ("want", jax_hdf5.write_land_names)):
        with h5py.File(str(tmp_path / "{}.h5".format(name)), "w") as f:
            write(f, ["FH-l", "IPS-r"])
    assert hdf5.get_land_names_from_dataset(str(tmp_path / "got.h5")) == ["FH-l", "IPS-r"]
    with h5py.File(str(tmp_path / "got.h5"), "r") as fg, h5py.File(str(tmp_path / "want.h5"), "r") as fw:
        assert sorted(fg["land-names"]) == sorted(fw["land-names"])
        for key in fw["land-names"]:
            assert fg["land-names"][key][()] == fw["land-names"][key][()]
    jax_write_floats(str(tmp_path / "want.txt"), [0.5, 1.25e-3, 2])
    write_floats_to_txt(str(tmp_path / "got.txt"), [0.5, 1.25e-3, 2])
    assert (tmp_path / "got.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()


@pytest.fixture(scope="module")
def truth_nn_file(tmp_path_factory):
    """A fixture archive and an nn-file made from its specimen 1: the true
    landmarks rendered as heatmaps (so most pass the gate) and the true
    label maps with a stripe of wrong labels (so Dice is not all 1)."""
    d = tmp_path_factory.mktemp("ev")
    ds = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=1, num_projs=5, img_dim=40, seed=8)
    data = hdf5.load_dataset(ds, [1])
    heats = synthesize_heatmaps(torch.from_numpy(data.lands), 40, 40).numpy()
    segs = data.segs.copy()
    segs[:, 10:14] = 3
    nn = str(d / "nn.h5")
    with h5py.File(nn, "w") as f:
        hdf5.write_land_names(f, DEFAULT_LAND_NAMES)
        f.create_dataset("nn-segs", data=segs, chunks=(1, 40, 40), compression="gzip", compression_opts=9)
        f.create_dataset("nn-heats", data=heats, chunks=(1, 1, 40, 40), compression="gzip", compression_opts=9)
    return d, ds, nn


@pytest.mark.parametrize("use_seg", [True, False], ids=["gated", "ungated"])
def test_est_lands_csv_cli_matches_jax(truth_nn_file, use_seg):
    from deepfluoro_tpu.cli import est_lands_csv as jax_cli
    from deepfluoro_tpu_torch.cli import est_lands_csv as port_cli

    d, _, nn = truth_nn_file
    seg = ["--use-seg", "nn-segs"] if use_seg else []
    jax_cli.main([nn, "nn-heats", *seg, "--pat", "1", "--out", str(d / "want.csv")])
    port_cli.main([nn, "nn-heats", *seg, "--pat", "1", "--out", str(d / "got.csv"), "--no-gpu"])
    strip = lambda p: [ln.rsplit(",", 1)[0] for ln in p.read_text().splitlines()]  # noqa: E731
    got = strip(d / "got.csv")
    assert got == strip(d / "want.csv") and len(got) == 1 + 5 * 14
    assert sum(not ln.endswith("-1,-1") for ln in got[1:]) > 40


@pytest.mark.parametrize("no_hdr", [False, True], ids=["header", "no-header"])
def test_compute_actual_dice_cli_matches_jax(truth_nn_file, no_hdr):
    from deepfluoro_tpu.cli import compute_actual_dice_on_test as jax_cli
    from deepfluoro_tpu_torch.cli import compute_actual_dice_on_test as port_cli

    d, ds, nn = truth_nn_file
    flag = ["--no-hdr"] if no_hdr else []
    jax_cli.main([ds, nn, "nn-segs", str(d / "want_dice.csv"), "1", *flag])
    port_cli.main([ds, nn, "nn-segs", str(d / "got_dice.csv"), "1", "--no-gpu", *flag])
    got = (d / "got_dice.csv").read_bytes()
    assert got == (d / "want_dice.csv").read_bytes()
    assert len(got.splitlines()) == (0 if no_hdr else 1) + 5 * 6 and b",1.00\n" in got and b",0.00\n" not in got


def test_eval_clis_refuse_without_a_card(truth_nn_file):
    from deepfluoro_tpu_torch.cli import compute_actual_dice_on_test, est_lands_csv

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot happen")
    d, ds, nn = truth_nn_file
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est_lands_csv.main([nn, "nn-heats", "--pat", "1", "--out", str(d / "x.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_actual_dice_on_test.main([ds, nn, "nn-segs", str(d / "x.csv"), "1"])
