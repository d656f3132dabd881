"""Training losses: soft Dice, 2D NCC and the joint Dice + heatmap-NCC loss
(JAX counterpart: ``deepfluoro_tpu/ops/losses.py``).

Predictions and targets are NCHW here (the JAX package's are NHWC).
Semantics follow the reference (train_test_code/dice.py, ncc.py), with its
quirks kept so loss values stay comparable:

- soft Dice: eps=1e-4 added to numerator and denominator; a class empty in
  both prediction and target scores (+eps)/(+eps) = +1, the worst value
  (dice.py:20-55; the gradient is zero either way);
- NCC: sample std with N-1, eps=1e-8 in the denominator (ncc.py:12-38);
- joint: (1-w)*dice + w*mean((ncc+1)*-0.5) (dice.py:57-86).

On row-sharded frames (a 'spatial' ``axis`` of several bands, each rank
holding a band of rows of the prediction and the target) the per-image
losses take their sums over the bands with a differentiable all-reduce
(``parallel/sharding.py::spatial_sum``) before any ratio: Dice's three
sums, and NCC's two means, then its three centered sums (``n`` is then
the whole frame's pixel count). Every band gets the image's loss.
"""

from __future__ import annotations

import torch

from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.sharding import spatial_sum

_DICE_EPS = 1.0e-4
_NCC_EPS = 1.0e-8


def per_sample_dice(pred: torch.Tensor, target: torch.Tensor, skip_bg: bool, axis: Axis = Axis()) -> torch.Tensor:
    """Per-image (negated) soft Dice of ``(B, C, H, W)`` tensors -> (B,)
    (of the whole frames when they are row-sharded over ``axis``)."""
    if skip_bg:
        pred = pred[:, 1:]
        target = target[:, 1:]
    num_classes = pred.shape[1]
    if axis.size > 1:
        sums = spatial_sum(torch.stack([torch.sum(target * pred, dim=(2, 3)), torch.sum(target * target, dim=(2, 3)),
                                        torch.sum(pred * pred, dim=(2, 3))]), axis)
        numerators = -2.0 * sums[0] + _DICE_EPS
        denominators = sums[1] + sums[2] + _DICE_EPS
        return torch.sum(numerators / denominators, dim=1) / num_classes
    numerators = -2.0 * torch.sum(target * pred, dim=(2, 3)) + _DICE_EPS
    denominators = torch.sum(target * target, dim=(2, 3)) + torch.sum(pred * pred, dim=(2, 3)) + _DICE_EPS
    return torch.sum(numerators / denominators, dim=1) / num_classes


def soft_dice_loss(pred: torch.Tensor, target: torch.Tensor, skip_bg: bool = True) -> torch.Tensor:
    """Scalar (negated) Dice of softmax probabilities against one-hot
    targets, both ``(B, C, H, W)``; -1 is a perfect segmentation."""
    assert pred.ndim == 4 and target.ndim == 4
    return torch.mean(per_sample_dice(pred, target, skip_bg))


def ncc_2d(x: torch.Tensor, y: torch.Tensor, dims: tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """Normalized cross-correlation over two spatial dims (reference
    ncc.py:12-38); the spatial dims are reduced away."""
    n = x.shape[dims[0]] * x.shape[dims[1]]
    assert n > 1
    # mismatched spatial dims would broadcast into a finite but wrong value
    assert x.shape[dims[0]] == y.shape[dims[0]] and x.shape[dims[1]] == y.shape[dims[1]], (x.shape, y.shape)
    x = x.float()
    y = y.float()
    x_zm = x - x.mean(dim=dims, keepdim=True)
    x_sd = torch.sqrt(torch.sum(x_zm * x_zm, dim=dims) / (n - 1))
    y_zm = y - y.mean(dim=dims, keepdim=True)
    y_sd = torch.sqrt(torch.sum(y_zm * y_zm, dim=dims) / (n - 1))
    return torch.sum(x_zm * y_zm, dim=dims) / ((n * (x_sd * y_sd)) + _NCC_EPS)


def sharded_ncc_2d(x: torch.Tensor, y: torch.Tensor, axis: Axis, n: int) -> torch.Tensor:
    """``ncc_2d`` over dims (2, 3) of frames row-sharded over ``axis``,
    whose whole frames hold ``n`` pixels: the means and the centered sums
    are summed over the bands."""
    assert n > 1 and x.shape[2:] == y.shape[2:], (x.shape, y.shape)
    x = x.float()
    y = y.float()
    means = spatial_sum(torch.stack([x.sum(dim=(2, 3)), y.sum(dim=(2, 3))]), axis) / n
    x_zm = x - means[0][..., None, None]
    y_zm = y - means[1][..., None, None]
    sums = spatial_sum(torch.stack([torch.sum(x_zm * x_zm, dim=(2, 3)), torch.sum(y_zm * y_zm, dim=(2, 3)),
                                    torch.sum(x_zm * y_zm, dim=(2, 3))]), axis)
    x_sd = torch.sqrt(sums[0] / (n - 1))
    y_sd = torch.sqrt(sums[1] / (n - 1))
    return sums[2] / ((n * (x_sd * y_sd)) + _NCC_EPS)


def per_sample_heatmap_ncc(pred_heats: torch.Tensor, target_heats: torch.Tensor, axis: Axis = Axis(),
                           n: int = 0) -> torch.Tensor:
    """Per-image heatmap loss of ``(B, L, H, W)`` tensors -> (B,): NCC mapped
    to [-1, 0] (dice.py:81-86), averaged over landmarks (row-sharded over
    ``axis``: whole frames of ``n`` pixels)."""
    if axis.size > 1:
        nccs = sharded_ncc_2d(pred_heats, target_heats, axis, n)
    else:
        nccs = ncc_2d(pred_heats, target_heats, dims=(2, 3))
    return torch.mean((nccs + 1.0) * -0.5, dim=1)


def per_sample_joint(pred_seg, pred_heats, tgt_seg, tgt_heats, heat_coeff: float, axis: Axis = Axis(),
                     n: int = 0) -> torch.Tensor:
    """Per-image joint loss -> (B,), shared by training and validation
    (row-sharded over ``axis``: whole frames of ``n`` pixels)."""
    dice = per_sample_dice(pred_seg, tgt_seg, skip_bg=False, axis=axis)
    heat = per_sample_heatmap_ncc(pred_heats, tgt_heats, axis, n)
    return (1.0 - heat_coeff) * dice + heat_coeff * heat


def heatmap_ncc_loss(pred_heats: torch.Tensor, target_heats: torch.Tensor) -> torch.Tensor:
    """Scalar heatmap NCC loss (reference dice.py:81-86)."""
    return torch.mean(per_sample_heatmap_ncc(pred_heats, target_heats))


def dice_and_heatmap_loss(pred_seg, pred_heats, target_seg, target_heats, skip_bg: bool = False, heatmap_wgt: float = 0.5):
    """Joint loss (1-w)*dice + w*heatmap-NCC (reference dice.py:57-86; the
    training loop uses skip_bg=False, train.py:324)."""
    assert 1.0e-8 < heatmap_wgt < 1.0 + 1.0e-8
    dice = soft_dice_loss(pred_seg, target_seg, skip_bg=skip_bg)
    heat = heatmap_ncc_loss(pred_heats, target_heats)
    return (1.0 - heatmap_wgt) * dice + heatmap_wgt * heat
