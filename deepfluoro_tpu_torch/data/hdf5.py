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
    minmax: tuple[float, float] | None = None  # the global scaling load_dataset applied

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
            minmax=self.minmax,
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


def specimen_counts(h5_file_path: str, pat_inds: Sequence[int]) -> list[int]:
    """Projection counts per specimen (metadata only): the row ranges of a
    :func:`load_dataset` union."""
    import h5py

    with h5py.File(h5_file_path, "r") as f:
        return [int(f["{:02d}/projs".format(p)].shape[0]) for p in pat_inds]


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


def _lr_land_permutation(num_lands: int, land_names: Sequence[str] | None) -> np.ndarray:
    """Landmark index permutation under a left/right mirror. With names,
    '<base>-l' pairs with '<base>-r' and unpaired names map to themselves
    (names without any pair are refused); without names, adjacent pairs
    swap (0<->1, 2<->3, ...), the layout reference dataset.py:495-499
    intended."""
    perm = np.arange(num_lands)
    if land_names:
        assert len(land_names) == num_lands
        index = {n: i for i, n in enumerate(land_names)}
        paired = 0
        for i, n in enumerate(land_names):
            j = None
            if n.endswith("-l"):
                j = index.get(n[:-2] + "-r")
            elif n.endswith("-r"):
                j = index.get(n[:-2] + "-l")
            if j is not None:
                perm[i] = j
                paired += 1
        if num_lands > 0 and paired == 0:
            raise ValueError(
                "land-names {} contain no '-l'/'-r' pairs; cannot derive the left/right landmark swap "
                "for flip duplication".format(list(land_names))
            )
    else:
        assert num_lands % 2 == 0, "unpaired landmark count needs land-names"
        perm = perm.reshape(-1, 2)[:, ::-1].reshape(-1)
    return perm


def _mirror_rows(projs, segs, lands, cols: int, land_names, class_swap):
    """Left/right mirror of a row batch: columns flip, the bilateral label
    pairs swap, in-view landmark x goes to (cols-1)-x and the l/r landmark
    channels swap."""
    m_projs = projs[:, :, ::-1]
    m_segs = None
    if segs is not None:
        lut = np.arange(256, dtype=segs.dtype)
        for a, b in class_swap:
            lut[a], lut[b] = b, a
        m_segs = lut[segs[:, :, ::-1]]
    m_lands = None
    if lands is not None:
        m_lands = lands.copy()
        finite = np.isfinite(m_lands[:, 0, :])
        m_lands[:, 0, :][finite] = (cols - 1) - m_lands[:, 0, :][finite]
        m_lands = m_lands[:, :, _lr_land_permutation(m_lands.shape[-1], land_names)]
    return m_projs, m_segs, m_lands


def lr_flip_duplicate(
    data: FluoroData,
    land_names: Sequence[str] | None = None,
    class_swap: Sequence[tuple[int, int]] = ((1, 2), (5, 6)),
) -> FluoroData:
    """Append a left/right-mirrored copy of every sample: the corrected
    reference dup_data_w_left_right_flip (dataset.py:464-502). The default
    ``class_swap`` is the 7-class map (1 left <-> 2 right hemipelvis, 5 left
    <-> 6 right femur); landmark pairs swap by '-l'/'-r' name, or as
    adjacent pairs without names."""
    m_projs, m_segs, m_lands = _mirror_rows(
        data.projs, data.segs, data.lands, data.orig_img_shape[1], land_names, class_swap
    )
    cat = lambda a, m: None if a is None else np.concatenate([a, m])  # noqa: E731
    return FluoroData(
        projs=np.concatenate([data.projs, m_projs]),
        segs=cat(data.segs, m_segs),
        lands=cat(data.lands, m_lands),
        orig_img_shape=data.orig_img_shape,
        pat_inds=cat(data.pat_inds, data.pat_inds),
        minmax=data.minmax,
    )


def load_dataset(
    h5_file_path: str,
    pat_inds: Sequence[int],
    minmax: bool | tuple[float, float] | None = None,
    no_seg: bool = False,
    dup_lr_flip: bool = False,
) -> FluoroData:
    """All projections, segmentations and landmarks of the given specimens
    (reference dataset.py:368-512 minus the host-side one-hot). ``minmax``
    scales the projections to [0, 1] by their global range (True) or by a
    given (min, max) (dataset.py:381-395, 509-512); ``no_seg`` leaves the
    segmentations unread, as inference reads a test archive;
    ``dup_lr_flip`` appends a mirror of every row (the training loops
    instead mirror the training side after their split)."""
    import h5py

    find_minmax = isinstance(minmax, bool) and minmax
    if isinstance(minmax, tuple):
        mm_min, mm_max = minmax
    else:
        mm_min, mm_max = math.inf, -math.inf

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
            if find_minmax:
                mm_min = min(mm_min, float(cur_projs.min()))
                mm_max = max(mm_max, float(cur_projs.max()))
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
    mm = None
    if minmax is not None and minmax is not False:
        assert (mm_max - mm_min) > 1.0e-6
        projs = (projs - mm_min) / (mm_max - mm_min)
        mm = (mm_min, mm_max)
    data = FluoroData(
        projs=projs, segs=segs, lands=lands, orig_img_shape=orig_img_shape, pat_inds=np.concatenate(all_pats),
        minmax=mm,
    )
    if dup_lr_flip:
        data = lr_flip_duplicate(data, land_names=archive_land_names(h5_file_path) if lands is not None else None)
    return data


class LazyFluoroReader:
    """Rows of the archive read on demand: the per-process feed of
    data-parallel streaming (JAX counterpart: ``data/hdf5.py::
    LazyFluoroReader``). ``take(rows)`` reads exactly the requested rows
    from disk, so a process that feeds its slice of every global batch
    reads about N/P rows per epoch and holds O(batch) rows in memory.

    Rows follow ``load_dataset`` row for row: specimens concatenate in
    ``pat_inds`` order, landmarks are checked finite and marked inf out of
    view. With ``dup_lr_flip`` the row space doubles: row ``i + n_base`` is
    the left/right mirror of row ``i`` (``_mirror_rows``, the math of
    ``lr_flip_duplicate``), so streamed and resident runs see the same
    batches. The h5py handle is not thread-safe: one thread at a time
    calls ``take`` (the training loop's prefetch producer)."""

    def __init__(self, h5_file_path: str, pat_inds: Sequence[int], dup_lr_flip: bool = False,
                 class_swap: Sequence[tuple[int, int]] = ((1, 2), (5, 6))):
        import h5py

        self._f = h5py.File(h5_file_path, "r")
        self._groups = []
        self.orig_img_shape = None
        counts, has_segs, has_lands = [], [], []
        for pat_idx in pat_inds:
            g = self._f["{:02d}".format(pat_idx)]
            shape = g["projs"].shape
            assert len(shape) == 3
            if self.orig_img_shape is None:
                self.orig_img_shape = (shape[1], shape[2])
            else:
                assert self.orig_img_shape == (shape[1], shape[2])
            counts.append(shape[0])
            has_segs.append("segs" in g)
            has_lands.append("lands" in g)
            self._groups.append(g)
        assert len(set(has_segs)) == 1 and len(set(has_lands)) == 1, (
            "specimens {} disagree on having segs/lands".format(list(pat_inds))
        )
        self.has_segs, self.has_lands = has_segs[0], has_lands[0]
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n_base = int(self._offsets[-1])
        self._dup = dup_lr_flip
        self._class_swap = class_swap
        self.land_names = archive_land_names(h5_file_path) if dup_lr_flip and self.has_lands else None
        self.num_lands = self._groups[0]["lands"].shape[2] if self.has_lands else 0

    def __len__(self) -> int:
        return self.n_base * 2 if self._dup else self.n_base

    def close(self) -> None:
        """Idempotent."""
        if self._f is not None:
            self._f.close()
            self._f = None
            self._groups = []

    def _read(self, name: str, rows: np.ndarray, dtype) -> np.ndarray:
        """Base rows in any order, repeats allowed: h5py reads sorted unique
        indices per specimen; the request order is restored after."""
        uniq, inverse = np.unique(rows, return_inverse=True)
        parts = []
        for si, g in enumerate(self._groups):
            lo, hi = self._offsets[si], self._offsets[si + 1]
            m = (uniq >= lo) & (uniq < hi)
            if m.any():
                parts.append(g[name][(uniq[m] - lo).astype(np.int64)])
        return np.concatenate(parts).astype(dtype)[inverse]

    def take(self, indices: Sequence[int]):
        """(projs, segs, lands) numpy arrays of the given rows, in request
        order (segs/lands None when the archive lacks them)."""
        idx = np.asarray(indices, np.int64)
        assert idx.size and idx.min() >= 0 and idx.max() < len(self), "rows out of range for {}-row reader".format(
            len(self))
        mirrored = idx >= self.n_base
        base = np.where(mirrored, idx - self.n_base, idx)
        projs = self._read("projs", base, np.float32)
        segs = self._read("segs", base, np.uint8) if self.has_segs else None
        lands = None
        if self.has_lands:
            lands = self._read("lands", base, np.float32)
            assert np.all(np.isfinite(lands)), "inputs must be finite (dataset.py:419)"
            lands = mark_oob_landmarks_inf(lands, self.orig_img_shape)
        if mirrored.any():
            m = mirrored
            m_projs, m_segs, m_lands = _mirror_rows(
                projs[m], None if segs is None else segs[m], None if lands is None else lands[m],
                self.orig_img_shape[1], self.land_names, self._class_swap,
            )
            projs[m] = m_projs
            if segs is not None:
                segs[m] = m_segs
            if lands is not None:
                lands[m] = m_lands
        return projs, segs, lands


def archive_land_names(h5_file_path: str) -> list[str] | None:
    """The archive's landmark names, or None when it has no readable
    land-names group (flip duplication then swaps adjacent pairs)."""
    try:
        return get_land_names_from_dataset(h5_file_path)
    except (KeyError, OSError):
        return None


def split_indices(n: int, train_valid_split: float, seed: int | None = None):
    """The split core of every trainer: the first ceil(split*n) positions
    of a Random(seed) shuffle train, the rest validate (reference
    dataset.py:524-551). Returns two python lists."""
    assert 0.0 < train_valid_split < 1.0
    num_train = int(math.ceil(train_valid_split * n))
    if n - num_train == 0:
        raise ValueError(
            "train_valid_split={} leaves an empty validation set for {} samples".format(train_valid_split, n)
        )
    inds = list(range(n))
    _pyrandom.Random(seed).shuffle(inds)
    return inds[:num_train], inds[num_train:]


def split_train_valid(data: FluoroData, train_valid_split: float, train_valid_idx=None, seed: int | None = None):
    """Random, or restored, train/valid split (reference dataset.py:524-551).
    ``train_valid_idx`` = (train indices, valid indices) reuses a stored
    split, as a resume does. Returns (train_data, valid_data, train_inds,
    valid_inds) with the indices as python lists, as checkpoints store them
    (train.py:512-513)."""
    if train_valid_idx is None or train_valid_idx[0] is None or train_valid_idx[1] is None:
        train_inds, valid_inds = split_indices(len(data), train_valid_split, seed)
    else:
        train_inds, valid_inds = list(train_valid_idx[0]), list(train_valid_idx[1])
        assert len(train_inds) == int(math.ceil(train_valid_split * len(data)))
        assert len(train_inds) + len(valid_inds) == len(data)
    return data.subset(train_inds), data.subset(valid_inds), train_inds, valid_inds
