"""Synthetic specimens with the preprocessed-archive schema, for tests and
for the card's smoke run (JAX counterpart: ``deepfluoro_tpu/data/
fixtures.py``; ``make_specimen`` draws the same numbers from the same
numpy generator).

``make_synthetic_data`` builds the data in memory, as ``load_dataset``
would read it back from ``write_synthetic_dataset``'s archive, and
``make_synthetic_fullres_data`` the raw full-resolution archive's arrays,
so both run where h5py is not installed.
"""

from __future__ import annotations

import numpy as np

from deepfluoro_tpu_torch.data.hdf5 import FluoroData, mark_oob_landmarks_inf
from deepfluoro_tpu_torch.data.preprocess import PAPER_SPEC_IDS
from deepfluoro_tpu_torch.eval.landmarks import SEG_LABELS_TO_USE_FOR_LANDS

# 14 bilateral landmark names as in the real archives (README.md:45-54)
DEFAULT_LAND_NAMES = [
    "FH-l", "FH-r",
    "GSN-l", "GSN-r",
    "IOF-l", "IOF-r",
    "MOF-l", "MOF-r",
    "SPS-l", "SPS-r",
    "IPS-l", "IPS-r",
    "ASIS-l", "ASIS-r",
]


def _ellipse_mask(h, w, cy, cx, ry, rx):
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    return (((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2) <= 1.0


def make_specimen(rng: np.random.Generator, num_projs: int, img_dim: int, num_classes: int = 7, land_names=DEFAULT_LAND_NAMES):
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
                # a fixed angle on the mid-ellipse ring: the location is a
                # function of the visible structure, so a net can learn it
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


FULLRES_LABEL_NAMES = ["left-hemipelvis", "right-hemipelvis", "vertebrae", "upper-sacrum", "left-femur", "right-femur"]
FULLRES_POSE_NAMES = ("cam-to-pelvis-vol", "cam-to-left-femur-vol", "cam-to-right-femur-vol")


def make_synthetic_fullres_data(
    num_specimens: int = 1,
    num_projs: int = 3,
    img_dim: int = 148,
    vol_dim: int = 16,
    land_names=DEFAULT_LAND_NAMES,
    seed: int = 0,
) -> list[dict]:
    """The contents of ``write_synthetic_fullres_dataset``'s archive, one
    dict per specimen, drawn in the JAX fixture's order from one numpy
    generator: ``name``, ``vol``, ``vol_seg``, ``vol_lands`` {name: (3,)},
    ``projs`` (N, R, C) float32 raw intensities (bone dark, exp(-x) of
    ``make_specimen``'s frames), ``segs`` (N, R, C) u1, ``lands`` (N, 2, L)
    float32, ``poses`` (N, 3, 4, 4), ``good_fov`` (N, 2) int and ``rots``
    (N,) bool (even projections are rotated). No h5py needed."""
    rng = np.random.default_rng(seed)
    # the JHU archive's six cadavers, then made-up names for more
    names = list(PAPER_SPEC_IDS) + ["99-{:04d}".format(s) for s in range(max(0, num_specimens - 6))]
    specimens = []
    for s in range(num_specimens):
        spec = {"name": names[s]}
        spec["vol"] = rng.random((vol_dim, vol_dim, vol_dim)).astype(np.float32)
        spec["vol_seg"] = rng.integers(0, 7, (vol_dim, vol_dim, vol_dim)).astype(np.uint8)
        spec["vol_lands"] = {nm: rng.random(3) * vol_dim for nm in land_names}
        projs, spec["segs"], spec["lands"] = make_specimen(rng, num_projs, img_dim, 7, land_names)
        spec["projs"] = np.exp(-projs).astype(np.float32)
        poses = np.tile(np.eye(4), (num_projs, len(FULLRES_POSE_NAMES), 1, 1))
        good_fov = np.zeros((num_projs, 2), np.int64)
        for n in range(num_projs):
            for k in range(len(FULLRES_POSE_NAMES)):
                poses[n, k, :3, 3] = rng.random(3) * 10
            good_fov[n, 0] = int(rng.random() > 0.3)
            good_fov[n, 1] = int(rng.random() > 0.3)
        spec["poses"], spec["good_fov"] = poses, good_fov
        spec["rots"] = np.arange(num_projs) % 2 == 0
        specimens.append(spec)
    return specimens


def _itk_image_group(g, pixels: np.ndarray, spacing):
    """ITK-style image group: dir-mat, origin, pixels, spacing
    (hdf5_layouts/Readme.md:20-28)."""
    nd = pixels.ndim
    g.create_dataset("pixels", data=pixels)
    g.create_dataset("dir-mat", data=np.eye(nd, dtype=np.float64))
    g.create_dataset("origin", data=np.zeros((nd,), np.float64))
    g.create_dataset("spacing", data=np.asarray(spacing, np.float64))


def write_synthetic_fullres_dataset(
    path: str,
    num_specimens: int = 1,
    num_projs: int = 3,
    img_dim: int = 148,  # > 2 * 50 border crop
    vol_dim: int = 16,
    land_names=DEFAULT_LAND_NAMES,
    seed: int = 0,
) -> str:
    """A synthetic full-resolution archive with the schema of
    hdf5_layouts/Readme.md:16-93 (proj-params; per specimen vol, vol-seg,
    vol-landmarks and projections/NNN/{image, gt-seg, gt-landmarks,
    gt-poses, rot-180-for-up}), holding ``make_synthetic_fullres_data``'s
    arrays: the JAX package's fixture for the same arguments."""
    import h5py

    with h5py.File(path, "w") as f:
        pp = f.create_group("proj-params")
        intrinsic = np.array([[5000.0, 0.0, img_dim / 2], [0.0, 5000.0, img_dim / 2], [0.0, 0.0, 1.0]])
        pp.create_dataset("intrinsic", data=intrinsic)
        pp.create_dataset("extrinsic", data=np.eye(4))
        pp["num-cols"] = img_dim
        pp["num-rows"] = img_dim
        pp["pixel-col-spacing"] = 0.194
        pp["pixel-row-spacing"] = 0.194

        for spec in make_synthetic_fullres_data(num_specimens, num_projs, img_dim, vol_dim, land_names, seed):
            sg = f.create_group(spec["name"])
            _itk_image_group(sg.create_group("vol"), spec["vol"], [1.0, 1.0, 1.0])
            vseg = sg.create_group("vol-seg")
            _itk_image_group(vseg.create_group("image"), spec["vol_seg"], [1.0, 1.0, 1.0])
            labels_def = vseg.create_group("labels-def")
            for li, nm in enumerate(FULLRES_LABEL_NAMES, start=1):
                labels_def[str(li)] = nm
            vl = sg.create_group("vol-landmarks")
            for nm in land_names:
                vl.create_dataset(nm, data=spec["vol_lands"][nm])

            projs_g = sg.create_group("projections")
            for n in range(num_projs):
                pg = projs_g.create_group("{:03d}".format(n))
                _itk_image_group(pg.create_group("image"), spec["projs"][n], [0.194, 0.194])
                _itk_image_group(pg.create_group("gt-seg"), spec["segs"][n], [0.194, 0.194])
                gl = pg.create_group("gt-landmarks")
                for li, nm in enumerate(land_names):
                    gl.create_dataset(nm, data=spec["lands"][n, :, li].astype(np.float64))
                gp = pg.create_group("gt-poses")
                for k, pose_name in enumerate(FULLRES_POSE_NAMES):
                    gp.create_dataset(pose_name, data=spec["poses"][n, k])
                gp["left-femur-good-fov"] = int(spec["good_fov"][n, 0])
                gp["right-femur-good-fov"] = int(spec["good_fov"][n, 1])
                pg["rot-180-for-up"] = int(spec["rots"][n])
    return path


def write_synthetic_dataset(
    path: str,
    num_specimens: int = 2,
    num_projs: int = 6,
    img_dim: int = 48,
    num_classes: int = 7,
    land_names=DEFAULT_LAND_NAMES,
    seed: int = 0,
) -> str:
    """Write a preprocessed-schema HDF5 archive (specimens '01'..'0N')."""
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        g = f.create_group("land-names")
        g["num-lands"] = len(land_names)
        for li, name in enumerate(land_names):
            g["land-{:02d}".format(li)] = name
        for s in range(1, num_specimens + 1):
            projs, segs, lands = make_specimen(rng, num_projs, img_dim, num_classes, land_names)
            sg = f.create_group("{:02d}".format(s))
            sg.create_dataset("projs", data=projs)
            sg.create_dataset("segs", data=segs)
            sg.create_dataset("lands", data=lands)
    return path


def make_synthetic_data(
    num_specimens: int = 2,
    num_projs: int = 6,
    img_dim: int = 48,
    num_classes: int = 7,
    land_names=DEFAULT_LAND_NAMES,
    seed: int = 0,
) -> FluoroData:
    """The rows ``load_dataset(write_synthetic_dataset(...), 1..N)`` would
    give for the same arguments, built in memory."""
    rng = np.random.default_rng(seed)
    parts = [make_specimen(rng, num_projs, img_dim, num_classes, land_names) for _ in range(num_specimens)]
    return FluoroData(
        projs=np.concatenate([p for p, _, _ in parts]),
        segs=np.concatenate([s for _, s, _ in parts]),
        lands=mark_oob_landmarks_inf(np.concatenate([l for _, _, l in parts]), (img_dim, img_dim)),
        orig_img_shape=(img_dim, img_dim),
        pat_inds=np.repeat(np.arange(1, num_specimens + 1), num_projs),
    )
