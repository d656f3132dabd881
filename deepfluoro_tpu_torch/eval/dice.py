"""Hard (non-differentiable) Dice between estimated and ground-truth label
maps (JAX counterpart: ``deepfluoro_tpu/eval/dice.py``; reference
compute_actual_dice_on_test.py:63-93).

Per projection, per class 1..num_classes-1: dice = 2 |est & gt| / (|est| +
|gt|), and 1.0 where both are empty. All classes of all projections at
once, on the label maps' device, in float32 as the JAX package computes
them: the CSV prints two decimals, and float64 could round the third
differently.
"""

from __future__ import annotations

import numpy as np
import torch


def hard_dice(gt_segs: torch.Tensor, est_segs: torch.Tensor, num_classes: int = 7) -> np.ndarray:
    """(N, H, W) integer label maps on one device -> (N, num_classes-1)
    float32 Dice of classes 1..num_classes-1, as numpy."""
    if gt_segs.shape != est_segs.shape:
        raise ValueError("label maps differ in shape: {} vs {}".format(tuple(gt_segs.shape), tuple(est_segs.shape)))
    classes = torch.arange(1, num_classes, device=gt_segs.device)[None, :, None, None]
    gt = (gt_segs.long()[:, None] == classes).float()
    est = (est_segs.to(gt_segs.device).long()[:, None] == classes).float()
    inter = torch.sum(est * gt, dim=(2, 3))
    tot = torch.sum(gt, dim=(2, 3)) + torch.sum(est, dim=(2, 3))
    d = torch.where(tot > 0.1, (2.0 * inter) / torch.clamp(tot, min=1e-12), torch.ones_like(tot))
    return torch.clamp(d, 0.0, 1.0).cpu().numpy()


def write_dice_csv(out_path: str, pat_ind: int, dices: np.ndarray, no_hdr: bool = False) -> None:
    """CSV contract of compute_actual_dice_on_test.py:59-93: header
    ``pat,proj,label,dice``, rows '{},{},{},{:.2f}'."""
    with open(out_path, "w") as csv_out:
        if not no_hdr:
            csv_out.write("pat,proj,label,dice\n")
        n, cm1 = dices.shape
        for proj in range(n):
            for li in range(cm1):
                d = float(dices[proj, li])
                assert -1.0e-8 < d < 1 + 1.0e-8
                csv_out.write("{},{},{},{:.2f}\n".format(pat_ind, proj, li + 1, d))
