"""The warp of the port: its plain version (deepfluoro_tpu_torch.ops.image.
affine_warp, what the CUDA kernel computes) against the JAX package's XLA
warp (ops.image.affine_warp, mode='mirror') and its Pallas kernel run
through the Pallas interpreter, on the cases of tests/test_pallas_warp.py.

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
