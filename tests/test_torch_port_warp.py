"""The warp of the port: its plain version (deepfluoro_tpu_torch.ops.image.
affine_warp, what the CUDA kernel computes) against the JAX package's XLA
warp (ops.image.affine_warp, mode='mirror') and its Pallas kernel run
through the Pallas interpreter, on the cases of tests/test_pallas_warp.py;
the pair wrapper the augmentation calls, the kernel's per-tile window rule,
and the grid_sample yardstick.

Tolerances: bilinear atol 1e-4, as test_pallas_warp.py holds the Pallas
kernel; nearest by the share of differing pixels (< 0.1 %), because PIL
and the kernels round ties with floor(x + 0.5) while JAX's XLA warp rounds
half away from zero, and float contraction can move a coordinate across a
tie; matrices outside the Pallas kernel's envelope at atol 1e-5, since the
port mirrors in closed form for any matrix."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import deepfluoro_tpu.ops.pallas.warp as W
from deepfluoro_tpu.ops.image import affine_warp as jax_warp
from deepfluoro_tpu.ops.image import calc_pad_amount, inverse_affine_matrix
from deepfluoro_tpu_torch.ops import image as timage
from deepfluoro_tpu_torch.ops import warp as twarp
from deepfluoro_tpu_torch.utils.platform import get_device


def port_warp(img, m, order, out_shape=None, off=(0.0, 0.0)):
    """The port's wrapper on CPU tensors, which takes the plain version."""
    got = twarp.affine_warp(
        torch.tensor(np.asarray(img, np.float32))[None], torch.tensor(np.asarray(m, np.float32))[None],
        order=order, out_shape=out_shape, out_offset_xy=off,
    )
    return got[0].numpy()


def xla_warp(img, m, order, out_shape=None, off=(0.0, 0.0)):
    """Run eagerly: op by op, each float operation rounds on its own as in
    the port, where a compiled program may contract multiply-adds."""
    return np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(m), order=order, out_shape=out_shape, out_offset_xy=off, mode="mirror"))


@pytest.mark.parametrize(
    "angle,trans,scale,shear",
    [
        (4.7, (12.0, -9.0), 1.08, (0.9, -0.6)),
        (-5.0, (0.0, 20.0), 0.9, (0.0, 0.0)),
        (0.0, (-14.0, 14.0), 1.1, (-1.0, 1.0)),
    ],
)
def test_bilinear_matches_xla_and_pallas(rng, angle, trans, scale, shear):
    img = rng.random((90, 90)).astype(np.float32)
    m = np.asarray(inverse_affine_matrix((45.0, 45.0), angle, trans, scale, shear))
    got = port_warp(img, m, 1, (96, 96), (-3, -3))
    np.testing.assert_allclose(got, xla_warp(img, m, 1, (96, 96), (-3, -3)), atol=1e-4)
    pallas = np.asarray(W.affine_warp_pallas(
        jnp.asarray(img), jnp.asarray(m), order=1, out_shape=(96, 96), out_offset_xy=(-3, -3),
        pad=64, guarded=False, interpret=True,
    ))
    np.testing.assert_allclose(got, pallas, atol=1e-4)


def test_nearest_matches_xla_and_pallas(rng):
    img = rng.integers(0, 7, (90, 90)).astype(np.float32)
    m = np.asarray(inverse_affine_matrix((45.0, 45.0), 3.0, (8.0, -5.0), 1.05, (0.5, -0.5)))
    got = port_warp(img, m, 0)
    assert (got != xla_warp(img, m, 0)).mean() < 0.001
    pallas = np.asarray(W.affine_warp_pallas(
        jnp.asarray(img), jnp.asarray(m), order=0, out_shape=(90, 90), pad=64, guarded=False, interpret=True,
    ))
    assert (got != pallas).mean() < 0.001


def test_identity_is_exact(rng):
    img = rng.random((64, 64)).astype(np.float32)
    m = np.asarray(inverse_affine_matrix((32.0, 32.0), 0.0, (0.0, 0.0), 1.0, (0.0, 0.0)))
    np.testing.assert_array_equal(port_warp(img, m, 1), img)
    np.testing.assert_array_equal(port_warp(img, m, 0), img)


@pytest.mark.parametrize(
    "angle,trans,scale",
    [
        (40.0, (0.0, 0.0), 1.0),   # rotation far beyond the Pallas band's 5 deg
        (0.0, (80.0, 0.0), 1.0),   # translation beyond the Pallas apron
        (0.0, (0.0, 0.0), 0.4),    # zoom-out past the apron
        (30.0, (60.0, -60.0), 0.6),
    ],
)
@pytest.mark.parametrize("order", [0, 1])
def test_out_of_envelope_matches_xla(rng, angle, trans, scale, order):
    img = rng.random((90, 90)).astype(np.float32)
    if order == 0:
        img = np.floor(img * 7)
    m = np.asarray(inverse_affine_matrix((45.0, 45.0), angle, trans, scale, (0.0, 0.0)))
    got, want = port_warp(img, m, order), xla_warp(img, m, order)
    if order == 1:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (got != want).mean() < 0.001


@pytest.mark.parametrize("orig,out_dim", [(360, 360), (300, 320), (180, 192)])
def test_wide_geometries_match_xla(rng, orig, out_dim):
    """The column-tiled geometries of test_pallas_warp.py and the 8x
    training geometry, at an extreme legal augmentation draw."""
    extra = calc_pad_amount(out_dim, orig) if out_dim > orig else 0
    img = rng.random((orig, orig)).astype(np.float32)
    m = np.asarray(inverse_affine_matrix((orig / 2.0, orig / 2.0), -5.0, (-20.0, 20.0), 0.9, (-1.0, 1.0)))
    got = port_warp(img, m, 1, (out_dim, out_dim), (-extra, -extra))
    np.testing.assert_allclose(got, xla_warp(img, m, 1, (out_dim, out_dim), (-extra, -extra)), atol=1e-4)


def test_batched_wrapper_matches_per_sample(rng):
    imgs = rng.random((3, 40, 40)).astype(np.float32)
    mats = np.stack([
        np.asarray(inverse_affine_matrix((20.0, 20.0), a, (3.0, -2.0), s, (0.5, 0.0)))
        for a, s in ((3.0, 1.05), (-4.0, 0.95), (0.0, 1.0))
    ])
    before = twarp.warp_launches
    got = twarp.affine_warp(torch.from_numpy(imgs), torch.from_numpy(mats), 1, (48, 48), (-4, -4)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], timage.affine_warp(torch.from_numpy(imgs[i]), torch.from_numpy(mats[i]), 1, (48, 48), (-4, -4)).numpy())
    assert twarp.warp_launches == before  # the CPU path launches no kernel


def test_wrapper_rejects_bad_inputs():
    img = torch.zeros(2, 8, 8)
    m = torch.zeros(2, 2, 3)
    with pytest.raises(ValueError):
        twarp.affine_warp(img.double(), m)
    with pytest.raises(ValueError):
        twarp.affine_warp(img, m[:1])
    with pytest.raises(ValueError):
        twarp.affine_warp(img[0], m[0])
    with pytest.raises(ValueError):
        twarp.affine_warp(img, m, order=3)


def test_cuda_entry_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


PALLAS_CASES = [
    (4.7, (12.0, -9.0), 1.08, (0.9, -0.6)),
    (-5.0, (0.0, 20.0), 0.9, (0.0, 0.0)),
    (0.0, (-14.0, 14.0), 1.1, (-1.0, 1.0)),
    (3.0, (8.0, -5.0), 1.05, (0.5, -0.5)),
]


@pytest.mark.parametrize("angle,trans,scale,shear", PALLAS_CASES)
def test_pair_matches_two_pallas_calls(rng, angle, trans, scale, shear):
    """The augmentation's pair (projection bilinear into the padded frame,
    labels nearest into their own) on the CPU against two interpreted
    Pallas calls, one per order."""
    proj = rng.random((90, 90)).astype(np.float32)
    labels = rng.integers(0, 7, (90, 90)).astype(np.float32)
    m = np.array(inverse_affine_matrix((45.0, 45.0), angle, trans, scale, shear))
    before = twarp.warp_launches
    got_p, got_s = twarp.affine_warp_pair(
        torch.from_numpy(proj)[None], torch.from_numpy(labels)[None], torch.from_numpy(m)[None], (96, 96), (-3, -3)
    )
    assert twarp.warp_launches == before  # the CPU path launches no kernel
    want_p = np.asarray(W.affine_warp_pallas(
        jnp.asarray(proj), jnp.asarray(m), order=1, out_shape=(96, 96), out_offset_xy=(-3, -3),
        pad=64, guarded=False, interpret=True,
    ))
    want_s = np.asarray(W.affine_warp_pallas(
        jnp.asarray(labels), jnp.asarray(m), order=0, out_shape=(90, 90), pad=64, guarded=False, interpret=True,
    ))
    np.testing.assert_allclose(got_p[0].numpy(), want_p, atol=1e-4)
    assert got_s.shape == (1, 90, 90)
    assert (got_s[0].numpy() != want_s).mean() < 0.001


def test_pair_without_labels_and_bad_inputs():
    proj = torch.rand(2, 20, 20)
    m = torch.from_numpy(np.stack([np.asarray(inverse_affine_matrix((10.0, 10.0), 2.0, (1.0, 0.0), 1.0, (0.0, 0.0)))] * 2))
    got_p, got_s = twarp.affine_warp_pair(proj, None, m, (24, 24), (-2, -2))
    assert got_s is None
    np.testing.assert_array_equal(got_p.numpy(), timage.affine_warp(proj, m, 1, (24, 24), (-2, -2)).numpy())
    with pytest.raises(ValueError):
        twarp.affine_warp_pair(proj, proj[:1], m, (24, 24), (-2, -2))
    with pytest.raises(ValueError):
        twarp.affine_warp_pair(proj, proj.double(), m, (24, 24), (-2, -2))


def _plain_coords(m, out_hw, off):
    """in_x, in_y (B, OH, OW) in the plain version's float32 operations."""
    oh, ow = out_hw
    xs = (torch.arange(ow, dtype=torch.float32) + 0.5 + off[0])[None, None, :]
    ys = (torch.arange(oh, dtype=torch.float32) + 0.5 + off[1])[None, :, None]
    col = lambda k: m[:, k // 3, k % 3][:, None, None]  # noqa: E731
    return col(0) * xs + col(1) * ys + col(2) - 0.5, col(3) * xs + col(4) * ys + col(5) - 0.5


def _aug_box_matrices(rng, n, dim):
    """Inverse matrices drawn over the augmentation's box (rot U(-5, 5) deg,
    translate up to 20 px, shear U(-1, 1) deg, scale U(0.9, 1.1)), with its
    corners among them."""
    corners = [(r, (20.0 * d, 0.0), s, (h, -h)) for r in (-5.0, 5.0) for s in (0.9, 1.1) for h in (-1.0, 1.0) for d in (-1.0, 1.0)]
    draws = [
        (rng.uniform(-5, 5), tuple(rng.uniform(-14.1, 14.1, 2)), rng.uniform(0.9, 1.1), tuple(rng.uniform(-1, 1, 2)))
        for _ in range(n)
    ]
    return torch.stack([
        torch.as_tensor(np.asarray(inverse_affine_matrix((dim / 2.0, dim / 2.0), a, t, s, h)))
        for a, t, s, h in corners + draws
    ])


def _far_matrices(dim):
    cases = [(30.0, (60.0, -60.0), 0.6), (40.0, (0.0, 0.0), 1.0), (0.0, (80.0, 0.0), 1.0), (0.0, (0.0, 0.0), 0.4),
             (3.0, (5.0, -5.0), 0.1), (170.0, (-300.0, 250.0), 2.5), (0.0, (4.0e6, 0.0), 1.0)]
    return torch.stack([
        torch.as_tensor(np.asarray(inverse_affine_matrix((dim / 2.0, dim / 2.0), a, t, s, (0.0, 0.0))))
        for a, t, s in cases
    ])


@pytest.mark.parametrize("dim,out_dim", [(90, 96), (179, 193), (300, 320)])
def test_tile_window_rule_holds_every_tap(rng, dim, out_dim):
    """The kernel's per-tile window rule (tile_windows, the Python copy of
    window() in csrc/affine_warp.cu): every bilinear and nearest tap of
    every pixel of a tile staged in shared memory lies inside its window;
    the augmentation's box always fits the budget, and far matrices send
    tiles to the global path."""
    extra = (out_dim - dim + 1) // 2
    off = (-extra, -extra)
    aug = _aug_box_matrices(rng, 24, dim)
    far = _far_matrices(dim)
    n_global = 0
    for mats, out_hw, o in ((aug, (out_dim, out_dim), off), (aug, (dim, dim), (0.0, 0.0)), (far, (out_dim, out_dim), off)):
        win = twarp.tile_windows(mats, out_hw, o)
        in_x, in_y = _plain_coords(mats, out_hw, o)
        taps = {
            "x": (torch.floor(in_x), torch.floor(in_x) + 1, torch.floor(in_x + 0.5)),
            "y": (torch.floor(in_y), torch.floor(in_y) + 1, torch.floor(in_y + 0.5)),
        }
        for i, (r0, r1) in enumerate(win["rows"].tolist()):
            for j, (c0, c1) in enumerate(win["cols"].tolist()):
                for b in range(mats.shape[0]):
                    if not win["shared"][b, i, j]:
                        n_global += 1
                        continue
                    for axis, lo, size in (("x", win["x0"], win["w"]), ("y", win["y0"], win["h"])):
                        first, last = int(lo[b, i, j]), int(lo[b, i, j] + size[b, i, j] - 1)
                        for t in taps[axis]:
                            tile = t[b, r0 : r1 + 1, c0 : c1 + 1]
                            assert first <= float(tile.min()) and float(tile.max()) <= last, (axis, b, i, j)
        if mats is aug:
            assert bool(win["shared"].all()) and int((win["w"] * win["h"]).max()) <= twarp.WIN_FLOATS
    assert n_global > 0


@pytest.mark.parametrize(
    "angle,trans,scale,shear,dim,out_dim",
    [
        (4.7, (12.0, -9.0), 1.08, (0.9, -0.6), 90, 96),
        (-5.0, (-20.0, 20.0), 0.9, (-1.0, 1.0), 179, 193),
        (5.0, (20.0, 0.0), 1.1, (1.0, -1.0), 64, 64),
        (30.0, (60.0, -60.0), 0.6, (0.0, 0.0), 64, 72),
    ],
)
def test_grid_sample_yardstick_matches_plain(rng, angle, trans, scale, shear, dim, out_dim):
    """grid_sample_warp (reflection, align_corners=True) computes the plain
    warp: bilinear to 1e-4 on the augmentation's box and the far matrix;
    nearest equal away from exact ties, where grid_sample rounds half to
    even and the port takes floor(x + 0.5)."""
    extra = (out_dim - dim + 1) // 2
    img = torch.from_numpy(rng.random((2, dim, dim)).astype(np.float32))
    m = torch.as_tensor(np.asarray(inverse_affine_matrix((dim / 2.0, dim / 2.0), angle, trans, scale, shear)))
    m = m.expand(2, 2, 3).contiguous()
    args = (m, 1, (out_dim, out_dim), (-extra, -extra))
    np.testing.assert_allclose(twarp.grid_sample_warp(img, *args).numpy(), timage.affine_warp(img, *args).numpy(), atol=1e-4)
    labels = torch.floor(img * 7)
    args = (m, 0, (out_dim, out_dim), (-extra, -extra))
    got, want = twarp.grid_sample_warp(labels, *args), timage.affine_warp(labels, *args)
    in_x, in_y = _plain_coords(m, (out_dim, out_dim), (-extra, -extra))
    near_tie = ((in_x - torch.floor(in_x) - 0.5).abs() < 1e-3) | ((in_y - torch.floor(in_y) - 0.5).abs() < 1e-3)
    assert float(near_tie.float().mean()) < 0.01
    np.testing.assert_array_equal(got[~near_tie].numpy(), want[~near_tie].numpy())
