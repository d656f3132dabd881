"""Synthetic preprocessed-archive specimens for the training cells.

A frozen copy of ``deepfluoro_tpu_torch/data/fixtures.py::make_specimen``
(and of ``data/hdf5.py::mark_oob_landmarks_inf``) as of commit
de33eddd4053c3511aa15a93546e00f9499bb3ba: later changes to the port's
fixtures do not move the benchmark's data. ``make_archive`` stacks
specimens the way ``make_synthetic_data`` does.
"""

from __future__ import annotations

import numpy as np

# landmark name -> estimated-seg label gating its detection
# (reference est_lands_csv.py:56-73)
SEG_LABELS_TO_USE_FOR_LANDS = {
    "FH-l": 5, "FH-r": 6,
    "GSN-l": 1, "GSN-r": 2,
    "IOF-l": 1, "IOF-r": 2,
    "MOF-l": 1, "MOF-r": 2,
    "SPS-l": 1, "SPS-r": 2,
    "IPS-l": 1, "IPS-r": 2,
    "ASIS-l": 1, "ASIS-r": 2,
    "PSIS-l": 1, "PSIS-r": 2,
    "PIIS-l": 1, "PIIS-r": 2,
}


def _ellipse_mask(h, w, cy, cx, ry, rx):
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    return (((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2) <= 1.0


def make_specimen(rng: np.random.Generator, num_projs: int, img_dim: int, num_classes: int, land_names):
    """Returns (projs (N,R,C) f4, segs (N,R,C) u1, lands (N,2,L) f4):
    elliptical 'bone' blobs per class at fixed sectors around the center,
    landmarks at fixed angles on the blobs their names gate on, and about
    5% of landmarks out of view."""
    h = w = img_dim
    n_l = len(land_names)
    projs = np.zeros((num_projs, h, w), np.float32)
    segs = np.zeros((num_projs, h, w), np.uint8)
    lands = np.zeros((num_projs, 2, n_l), np.float32)

    for n in range(num_projs):
        bg = rng.random((h // 8 + 1, w // 8 + 1)).astype(np.float32)
        bg = np.kron(bg, np.ones((8, 8), np.float32))[:h, :w]
        img = 0.4 + 0.2 * bg

        class_centers = {}
        for c in range(1, num_classes):
            ang = 2 * np.pi * (c - 1) / max(1, num_classes - 1)
            cx = w / 2 + 0.26 * w * np.cos(ang) + rng.uniform(-0.04, 0.04) * w
            cy = h / 2 + 0.26 * h * np.sin(ang) + rng.uniform(-0.04, 0.04) * h
            ry = h * rng.uniform(0.10, 0.15)
            rx = w * rng.uniform(0.10, 0.15)
            m = _ellipse_mask(h, w, cy, cx, ry, rx)
            segs[n][m] = c
            img[m] += 0.22 + 0.07 * c
            class_centers[c] = (cy, cx, ry, rx)

        img += rng.normal(0, 0.01, (h, w)).astype(np.float32)
        projs[n] = img

        for li, name in enumerate(land_names):
            c = SEG_LABELS_TO_USE_FOR_LANDS.get(name, 1)
            if c in class_centers:
                cy, cx, ry, rx = class_centers[c]
                ang = 2 * np.pi * li / max(1, n_l)
                x = cx + 0.5 * rx * np.cos(ang)
                y = cy + 0.5 * ry * np.sin(ang)
            else:
                x, y = rng.uniform(0, w - 1), rng.uniform(0, h - 1)
            if rng.random() < 0.05:
                x = -20.0
            lands[n, 0, li] = x
            lands[n, 1, li] = y

    return projs, segs, lands


def mark_oob_landmarks_inf(lands: np.ndarray, img_shape_hw) -> np.ndarray:
    """x outside [0, cols-1] or y outside [0, rows-1] -> both coords inf
    (reference dataset.py:421-429)."""
    lands = lands.astype(np.float32).copy()
    rows, cols = img_shape_hw
    x = lands[:, 0, :]
    y = lands[:, 1, :]
    oob = (x < 0) | (x > (cols - 1)) | (y < 0) | (y > (rows - 1))
    lands[:, 0, :][oob] = np.inf
    lands[:, 1, :][oob] = np.inf
    return lands


def make_archive(seed: int, num_specimens: int, num_projs: int, img_dim: int, num_classes: int, land_names):
    """(projs, segs, lands with inf out of view, pat_inds 1..N): the rows
    of a preprocessed archive of ``num_specimens`` specimens."""
    rng = np.random.default_rng(seed)
    parts = [make_specimen(rng, num_projs, img_dim, num_classes, land_names) for _ in range(num_specimens)]
    projs = np.concatenate([p for p, _, _ in parts])
    segs = np.concatenate([s for _, s, _ in parts])
    lands = mark_oob_landmarks_inf(np.concatenate([lm for _, _, lm in parts]), (img_dim, img_dim))
    return projs, segs, lands, np.repeat(np.arange(1, num_specimens + 1), num_projs)
