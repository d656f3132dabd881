"""Host-side access to the preprocessed DeepFluoro archives (JAX
counterpart: ``deepfluoro_tpu/data/hdf5.py``).

Schema (reference hdf5_layouts/Readme.md:95-117):
  land-names/num-lands          scalar L
  land-names/land-XX            name of landmark XX
  <NN>/projs                    N x R x C float projections
  <NN>/segs                     N x R x C uint8 label maps
  <NN>/lands                    N x 2 x L landmark coords (row 0 = x, row 1 = y)

``h5py`` is imported inside the functions that read an archive, so the
rest of the port runs where h5py is not installed (data built in memory,
``data/fixtures.py::make_synthetic_data``).
"""

from __future__ import annotations

import dataclasses
import math
import random as _pyrandom
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class FluoroData:
    """An in-memory slice of the preprocessed archive.

    projs: (N, R, C) float32; segs: (N, R, C) uint8 or None; lands:
    (N, 2, L) float32 with inf marking out-of-view, or None. ``pat_inds``
    (N,) holds each row's specimen number, so a caller can select
    specimens from data already in memory (``select_pats``)."""

    projs: np.ndarray
    segs: np.ndarray | None
    lands: np.ndarray | None
    orig_img_shape: tuple[int, int]
    pat_inds: np.ndarray | None = None

    def __len__(self) -> int:
        return self.projs.shape[0]

    @property
    def num_lands(self) -> int:
        return 0 if self.lands is None else self.lands.shape[-1]

    def subset(self, indices: Sequence[int]) -> "FluoroData":
        idx = np.asarray(indices, dtype=np.int64)
        return FluoroData(
            projs=self.projs[idx],
            segs=None if self.segs is None else self.segs[idx],
            lands=None if self.lands is None else self.lands[idx],
            orig_img_shape=self.orig_img_shape,
            pat_inds=None if self.pat_inds is None else self.pat_inds[idx],
        )

    def select_pats(self, pats: Sequence[int]) -> "FluoroData":
        """The rows of the given specimens, concatenated in ``pats`` order
        (the row order load_dataset gives for the same specimens)."""
        if self.pat_inds is None:
            raise ValueError("this FluoroData carries no specimen numbers")
        rows = np.concatenate([np.flatnonzero(self.pat_inds == p) for p in pats])
        if rows.size == 0:
            raise ValueError("no rows of specimens {}".format(list(pats)))
        return self.subset(rows)


def get_orig_img_shape(h5_file_path: str, pat_ind: int) -> tuple[int, int]:
    """(rows, cols) of a specimen's projections (reference dataset.py:330-337)."""
    import h5py

    with h5py.File(h5_file_path, "r") as f:
        s = f["{:02d}/projs".format(pat_ind)].shape
    assert len(s) == 3
    return (s[1], s[2])


def get_num_lands_from_dataset(h5_file_path: str) -> int:
    import h5py

    with h5py.File(h5_file_path, "r") as f:
        return int(f["land-names/num-lands"][()])


def get_land_names_from_dataset(h5_file_path: str) -> list[str]:
    """The archive's landmark names in index order (stored as bytes or str)."""
    import h5py

    with h5py.File(h5_file_path, "r") as f:
        names = []
        for li in range(int(f["land-names/num-lands"][()])):
            s = f["land-names/land-{:02d}".format(li)][()]
            names.append(s.decode() if isinstance(s, (bytes, np.bytes_)) else str(s))
    return names


def write_land_names(h5_file, land_names: Sequence[str]) -> None:
    """Write the land-names group into an open h5py file (contract of
    reference test_ensemble.py:124-129)."""
    g = h5_file.create_group("land-names")
    g["num-lands"] = len(land_names)
    for li, name in enumerate(land_names):
        g["land-{:02d}".format(li)] = name


def mark_oob_landmarks_inf(lands: np.ndarray, img_shape_hw: tuple[int, int]) -> np.ndarray:
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


def load_dataset(h5_file_path: str, pat_inds: Sequence[int], no_seg: bool = False) -> FluoroData:
    """All projections, segmentations and landmarks of the given specimens
    (reference dataset.py:368-512 minus the host-side one-hot and the
    min-max scaling, which training does not use). ``no_seg`` leaves the
    segmentations unread, as inference reads a test archive."""
    import h5py

    all_projs, all_segs, all_lands, all_pats = [], [], [], []
    orig_img_shape = None
    with h5py.File(h5_file_path, "r") as f:
        for pat_idx in pat_inds:
            pat_g = f["{:02d}".format(pat_idx)]
            cur_projs = pat_g["projs"][:].astype(np.float32)
            assert cur_projs.ndim == 3
            if orig_img_shape is None:
                orig_img_shape = (cur_projs.shape[1], cur_projs.shape[2])
            else:
                assert orig_img_shape == (cur_projs.shape[1], cur_projs.shape[2])
            if "lands" in pat_g:
                cur_lands = pat_g["lands"][:].astype(np.float32)
                assert cur_lands.shape[0] == cur_projs.shape[0]
                assert np.all(np.isfinite(cur_lands)), "inputs must be finite (dataset.py:419)"
                all_lands.append(mark_oob_landmarks_inf(cur_lands, orig_img_shape))
            all_projs.append(cur_projs)
            all_pats.append(np.full(cur_projs.shape[0], pat_idx, np.int64))
            if not no_seg and "segs" in pat_g:
                cur_segs = pat_g["segs"][:]
                assert cur_segs.ndim == 3
                all_segs.append(cur_segs.astype(np.uint8))

    projs = np.concatenate(all_projs, axis=0)
    segs = np.concatenate(all_segs, axis=0) if all_segs else None
    lands = np.concatenate(all_lands, axis=0) if all_lands else None
    # every specimen must carry the same datasets, or supervision misaligns
    for name, arr in (("segs", segs), ("lands", lands)):
        if arr is not None and arr.shape[0] != projs.shape[0]:
            raise ValueError(
                "specimens {} disagree on having '{}' ({} rows vs {} projs)".format(
                    list(pat_inds), name, arr.shape[0], projs.shape[0]
                )
            )
    return FluoroData(
        projs=projs, segs=segs, lands=lands, orig_img_shape=orig_img_shape, pat_inds=np.concatenate(all_pats)
    )


def split_train_valid(data: FluoroData, train_valid_split: float, seed: int | None = None):
    """Random train/valid split (reference dataset.py:524-551): the first
    ceil(split*n) positions of a Random(seed) shuffle train, as in the JAX
    package. Returns (train_data, valid_data, train_inds, valid_inds) with
    the indices as python lists, as checkpoints store them
    (train.py:512-513)."""
    assert 0.0 < train_valid_split < 1.0
    n = len(data)
    num_train = int(math.ceil(train_valid_split * n))
    if n - num_train == 0:
        raise ValueError(
            "train_valid_split={} leaves an empty validation set for {} samples".format(train_valid_split, n)
        )
    inds = list(range(n))
    _pyrandom.Random(seed).shuffle(inds)
    train_inds, valid_inds = inds[:num_train], inds[num_train:]
    return data.subset(train_inds), data.subset(valid_inds), train_inds, valid_inds
