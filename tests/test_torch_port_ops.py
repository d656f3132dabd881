"""The port's image ops, heatmaps and losses (deepfluoro_tpu_torch.ops)
against the JAX package's (deepfluoro_tpu.ops) on the same numpy inputs.
Tolerance atol 1e-5: both sides compute in float32 with the same formulas,
so only summation order differs; pads and crops move values and must
agree exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepfluoro_tpu.ops import heatmap as jheat
from deepfluoro_tpu.ops import image as jimg
from deepfluoro_tpu.ops import losses as jloss
from deepfluoro_tpu_torch.ops import heatmap as theat
from deepfluoro_tpu_torch.ops import image as timg
from deepfluoro_tpu_torch.ops import losses as tloss

ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("padded,cur", [(192, 180), (96, 90), (97, 90), (48, 47)])
def test_calc_pad_amount(padded, cur):
    assert timg.calc_pad_amount(padded, cur) == jimg.calc_pad_amount(padded, cur)


@pytest.mark.parametrize("src,dst", [((40, 40), (32, 32)), ((41, 40), (32, 31)), ((16, 16), (16, 16))])
def test_center_crop_exact(rng, src, dst):
    x = rng.random((2, 3) + src).astype(np.float32)
    want = np.asarray(jimg.center_crop(jnp.asarray(x.transpose(0, 2, 3, 1)), dst)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(timg.center_crop(t(x), dst).numpy(), want)


@pytest.mark.parametrize("cur,padded", [(40, 48), (41, 48), (48, 48), (90, 96)])
def test_reflect_pad_to_exact(rng, cur, padded):
    x = rng.random((3, cur, cur)).astype(np.float32)
    want = np.asarray(jimg.reflect_pad_to(jnp.asarray(x), padded, spatial_axes=(1, 2)))
    np.testing.assert_array_equal(timg.reflect_pad_to(t(x), padded).numpy(), want)


def test_znorm_ddof1(rng):
    x = (rng.random((48, 48)) * 3 + 1).astype(np.float32)
    got = timg.znorm(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jimg.znorm(jnp.asarray(x))), atol=ATOL)
    assert got.std(ddof=1) == pytest.approx(1.0, abs=1e-5)
    # the per-sample form the batch preparation uses
    xb = np.stack([x, 2 * x + 5])
    per = timg.znorm(t(xb), dim=(1, 2)).numpy()
    for i in range(2):
        np.testing.assert_allclose(per[i], np.asarray(jimg.znorm(jnp.asarray(xb[i]))), atol=ATOL)


@pytest.mark.parametrize(
    "center,angle,trans,scale,shear",
    [((90.0, 90.0), 4.7, (12.0, -9.0), 1.08, (0.9, -0.6)), ((45.5, 44.5), -5.0, (0.0, 20.0), 0.9, (-1.0, 1.0))],
)
def test_affine_matrices_and_landmarks(rng, center, angle, trans, scale, shear):
    jm = np.asarray(jimg.inverse_affine_matrix(center, angle, trans, scale, shear))
    tm = timg.inverse_affine_matrix(center, angle, trans, scale, shear)
    np.testing.assert_allclose(tm.numpy(), jm, atol=ATOL)
    np.testing.assert_allclose(timg.forward_affine_matrix(tm).numpy(), np.asarray(jimg.forward_affine_matrix(jnp.asarray(jm))), atol=ATOL)
    # batched draws give the per-sample matrices
    tb = timg.inverse_affine_matrix(
        center, torch.tensor([angle, 0.0]), (torch.tensor([trans[0], 1.0]), torch.tensor([trans[1], 2.0])),
        torch.tensor([scale, 1.0]), (torch.tensor([shear[0], 0.0]), torch.tensor([shear[1], 0.0])),
    )
    np.testing.assert_allclose(tb[0].numpy(), jm, atol=ATOL)

    lands = rng.uniform(0, 180, (2, 14)).astype(np.float32)
    lands[:, 3] = np.inf
    lands[0, 5] = 400.0  # lands out of bounds after the transform
    want = np.asarray(jimg.transform_landmarks(jnp.asarray(lands), jnp.asarray(jm), (180, 180)))
    got = timg.transform_landmarks(t(lands), tm, (180, 180)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4)


def test_gaussian_heatmap():
    np.testing.assert_allclose(
        theat.gaussian_heatmap(25, 25, 2.5).numpy(), np.asarray(jheat.gaussian_heatmap(25, 25, 2.5)), atol=ATOL
    )
    np.testing.assert_allclose(
        theat.gaussian_heatmap(20, 30, 3.0, 4.5, 7.25).numpy(),
        np.asarray(jheat.gaussian_heatmap(20, 30, 3.0, 4.5, 7.25)), atol=ATOL,
    )


def test_synthesize_heatmaps_inf_to_zero(rng):
    lands = rng.uniform(0, 40, (3, 2, 6)).astype(np.float32)
    lands[0, :, 2] = np.inf
    lands[2, 1, 5] = np.inf
    got = theat.synthesize_heatmaps(t(lands), 40, 44).numpy()
    assert got.shape == (3, 6, 40, 44)
    for b in range(3):
        want = np.asarray(jheat.synthesize_heatmaps(jnp.asarray(lands[b]), 40, 44)).transpose(2, 0, 1)
        np.testing.assert_allclose(got[b], want, atol=ATOL)
    assert not got[0, 2].any() and not got[2, 5].any()


def _probs(rng, shape):
    logits = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("skip_bg", [False, True])
def test_dice(rng, skip_bg):
    pred = _probs(rng, (3, 5, 24, 24))
    labels = rng.integers(0, 4, (3, 24, 24))  # class 4 empty everywhere: the eps quirk
    tgt = np.eye(5, dtype=np.float32)[labels].transpose(0, 3, 1, 2)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    want = np.asarray(jloss.per_sample_dice(nhwc(pred), nhwc(tgt), skip_bg))
    np.testing.assert_allclose(tloss.per_sample_dice(t(pred), t(tgt), skip_bg).numpy(), want, atol=ATOL)
    assert float(tloss.soft_dice_loss(t(pred), t(tgt), skip_bg)) == pytest.approx(
        float(jloss.soft_dice_loss(nhwc(pred), nhwc(tgt), skip_bg)), abs=ATOL
    )


def test_ncc_and_joint_losses(rng):
    pred_seg = _probs(rng, (2, 7, 20, 20))
    tgt_seg = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 20, 20))].transpose(0, 3, 1, 2)
    pred_h = rng.standard_normal((2, 4, 20, 20)).astype(np.float32)
    tgt_h = rng.random((2, 4, 20, 20)).astype(np.float32)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731

    np.testing.assert_allclose(
        tloss.ncc_2d(t(pred_h), t(tgt_h)).numpy(), np.asarray(jloss.ncc_2d(jnp.asarray(pred_h), jnp.asarray(tgt_h))), atol=ATOL
    )
    np.testing.assert_allclose(
        tloss.per_sample_heatmap_ncc(t(pred_h), t(tgt_h)).numpy(),
        np.asarray(jloss.per_sample_heatmap_ncc(nhwc(pred_h), nhwc(tgt_h))), atol=ATOL,
    )
    np.testing.assert_allclose(
        tloss.per_sample_joint(t(pred_seg), t(pred_h), t(tgt_seg), t(tgt_h), 0.3).numpy(),
        np.asarray(jloss.per_sample_joint(nhwc(pred_seg), nhwc(pred_h), nhwc(tgt_seg), nhwc(tgt_h), 0.3)), atol=ATOL,
    )
    assert float(tloss.dice_and_heatmap_loss(t(pred_seg), t(pred_h), t(tgt_seg), t(tgt_h))) == pytest.approx(
        float(jloss.dice_and_heatmap_loss(nhwc(pred_seg), nhwc(pred_h), nhwc(tgt_seg), nhwc(tgt_h))), abs=ATOL
    )
