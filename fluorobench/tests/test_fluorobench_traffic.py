"""The seeded generators: the same seed gives the same data."""

import numpy as np

from fluorobench.traffic.fullres_frames import make_raw_frames, make_raw_frames_numpy
from fluorobench.traffic.specimens import make_archive

LANDS = ["FH-l", "FH-r", "GSN-l", "GSN-r"]


def test_archive_is_seeded():
    a = make_archive(2**31 + 5, 2, 3, 24, 7, LANDS)
    b = make_archive(2**31 + 5, 2, 3, 24, 7, LANDS)
    c = make_archive(2**31 + 6, 2, 3, 24, 7, LANDS)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    projs, segs, lands, pats = a
    assert projs.shape == (6, 24, 24) and segs.max() == 6 and list(pats) == [1, 1, 1, 2, 2, 2]
    assert np.isinf(lands).any() or np.isfinite(lands).all()


def test_raw_frames_are_seeded_and_bone_dark():
    f1, r1 = make_raw_frames(2**31 + 9, 3, 148, "cpu")
    f2, _ = make_raw_frames(2**31 + 9, 3, 148, "cpu")
    assert np.array_equal(f1, f2) and f1.dtype == np.float32 and list(r1) == [True, False, True]
    assert 0.0 < f1.min() and f1.max() < 1.0
    g, _ = make_raw_frames_numpy(3, 2, 148, LANDS)
    assert g.shape == (2, 148, 148) and 0.0 < g.min() and g.max() < 1.0
