"""Full-resolution inference in plain PyTorch: raw frame -> prep -> K
members -> ensemble, and the landmark decode (reference README.md:84-95
for the prep, util.py:293-377 for the ensemble, est_lands_csv.py:56-134
for the landmarks; SURVEY.md §2-§3).

Prep: crop 50 px from each border, Beer-Lambert log (log(I0 + 1e-6) -
log(max(I, 1e-6)), I0 the frame's maximum), rotate 180 degrees where
flagged, shrink by the factor with ``jax.image.resize``'s linear method (a
triangle filter widened by the factor, sample i at (i + 0.5) m / n - 0.5,
weights normalized per output, worked out in float64), reflect-pad to the
network size (ceil((pad - n) / 2) a side), z-norm per frame (N - 1).
Ensemble: each member's softmax and heatmaps cut to the frame (center
crop), heatmaps min-max normalized per frame over all landmarks, the mean
over members, the argmax as labels.
Landmarks (rule 3): the argmax of each heatmap over the pixels whose label
is the landmark's structure; found where the NCC of the 25 x 25 window at
the peak (12-px reflect padding) with a sigma-2.5 Gaussian is >= 0.9.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fluorobench.reference import unet
from fluorobench.traffic.specimens import SEG_LABELS_TO_USE_FOR_LANDS

BORDER = 50
NCC_THRESH = 0.9


def resize_matrix(m: int, n: int) -> np.ndarray:
    """(n, m) float64 weights of the linear resize from m to n samples."""
    scale = m / n
    sample = (np.arange(n) + 0.5) * scale - 0.5
    dist = np.abs(sample[:, None] - np.arange(m)[None, :]) / max(scale, 1.0)
    w = np.maximum(0.0, 1.0 - dist)
    return w / w.sum(axis=1, keepdims=True)


def crop_size(raw: int, ds_factor: int) -> int:
    return (raw - 2 * BORDER) // ds_factor


def prep(frames: torch.Tensor, rots: torch.Tensor, ds_factor: int, pad_dim: int, num: unet.Numerics):
    """(B, H, W) raw frames -> (B, 1, P, P) network input in ``num.dtype``."""
    x = frames.to(num.dtype)[:, BORDER:-BORDER, BORDER:-BORDER]
    x = torch.log(x.amax(dim=(1, 2), keepdim=True) + 1e-6) - torch.log(torch.clamp(x, min=1e-6))
    x = torch.where(rots[:, None, None], x.flip(1, 2), x)
    n = crop_size(frames.shape[-1], ds_factor)
    wr = torch.from_numpy(resize_matrix(x.shape[1], n)).to(x.device, num.dtype)
    wc = torch.from_numpy(resize_matrix(x.shape[2], n)).to(x.device, num.dtype)
    x = wr @ x @ wc.T
    if pad_dim > n:
        pad = math.ceil((pad_dim - n) / 2)
        x = F.pad(x[:, None], (pad,) * 4, mode="reflect")[:, 0]
    x = (x - x.mean(dim=(1, 2), keepdim=True)) / x.std(dim=(1, 2), correction=1, keepdim=True)
    return x[:, None]


@torch.no_grad()
def ensemble(members, frames, rots, cfg: dict, num: unet.Numerics):
    """(mean probabilities (B, C, h, w), mean heats (B, L, h, w), labels
    (B, h, w)) of the members' state dicts (in ``num.dtype``)."""
    with num.scope():
        x = prep(frames, rots, cfg["ds_factor"], cfg["proj_unet_dim"], num)
        n = crop_size(frames.shape[-1], cfg["ds_factor"])
        prob = heat = None
        for p in members:
            seg, h = unet.forward(p, x, cfg, num)
            seg, h = unet.center_crop(seg, (n, n)), unet.center_crop(h, (n, n))
            lo, hi = h.amin(dim=(1, 2, 3), keepdim=True), h.amax(dim=(1, 2, 3), keepdim=True)
            h = (h - lo) / (hi - lo)
            prob = seg if prob is None else prob + seg
            heat = h if heat is None else heat + h
    prob, heat = prob / len(members), heat / len(members)
    return prob, heat, prob.argmax(dim=1)


def gaussian(size: int, sigma: float = 2.5) -> np.ndarray:
    c = size // 2
    d2 = (np.arange(size)[None, :] - c) ** 2 + (np.arange(size)[:, None] - c) ** 2
    return np.exp(d2 / (sigma * sigma * -2.0)) / (2.0 * math.pi * sigma * sigma)


def ncc(a: np.ndarray, b: np.ndarray) -> float:
    n = a.size
    az, bz = a - a.mean(), b - b.mean()
    sa, sb = math.sqrt((az * az).sum() / (n - 1)), math.sqrt((bz * bz).sum() / (n - 1))
    return float((az * bz).sum() / (n * (sa * sb) + 1e-8))


def landmarks(heats: np.ndarray, labels: np.ndarray, land_names, roi: int = 25):
    """Rule 3 on one frame's (L, h, w) heats and (h, w) labels -> (rows
    (L,), cols (L,), nccs (L,)) with -1 where not found; nccs are the
    window NCCs (nan where the structure is absent)."""
    half = roi // 2
    template = gaussian(roi)
    rows, cols = np.full(len(land_names), -1), np.full(len(land_names), -1)
    nccs = np.full(len(land_names), np.nan)
    for li, name in enumerate(land_names):
        gate = SEG_LABELS_TO_USE_FOR_LANDS.get(name, -1)
        h = heats[li].astype(np.float64)
        masked = h if gate < 0 else np.where(labels == gate, h, -np.inf)
        idx = int(np.argmax(masked))
        if not np.isfinite(masked.flat[idx]):
            continue
        r, c = divmod(idx, h.shape[1])
        win = np.pad(h, half, mode="reflect")[r : r + roi, c : c + roi]
        nccs[li] = ncc(template, win)
        if nccs[li] >= NCC_THRESH:
            rows[li], cols[li] = r, c
    return rows, cols, nccs
