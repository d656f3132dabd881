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
"""

from __future__ import annotations

import torch

_DICE_EPS = 1.0e-4
_NCC_EPS = 1.0e-8


def per_sample_dice(pred: torch.Tensor, target: torch.Tensor, skip_bg: bool) -> torch.Tensor:
    """Per-image (negated) soft Dice of ``(B, C, H, W)`` tensors -> (B,)."""
    if skip_bg:
        pred = pred[:, 1:]
        target = target[:, 1:]
    num_classes = pred.shape[1]
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


def per_sample_heatmap_ncc(pred_heats: torch.Tensor, target_heats: torch.Tensor) -> torch.Tensor:
    """Per-image heatmap loss of ``(B, L, H, W)`` tensors -> (B,): NCC mapped
    to [-1, 0] (dice.py:81-86), averaged over landmarks."""
    nccs = ncc_2d(pred_heats, target_heats, dims=(2, 3))
    return torch.mean((nccs + 1.0) * -0.5, dim=1)


def per_sample_joint(pred_seg, pred_heats, tgt_seg, tgt_heats, heat_coeff: float) -> torch.Tensor:
    """Per-image joint loss -> (B,), shared by training and validation."""
    dice = per_sample_dice(pred_seg, tgt_seg, skip_bg=False)
    heat = per_sample_heatmap_ncc(pred_heats, tgt_heats)
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
