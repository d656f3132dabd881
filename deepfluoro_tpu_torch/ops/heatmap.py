"""Gaussian landmark-heatmap synthesis (JAX counterpart:
``deepfluoro_tpu/ops/heatmap.py``).

The pdf is the unnormalized-sum Gaussian exp(-(dx^2+dy^2)/(2 sigma^2)) /
(2 pi sigma^2), exactly as dataset.py:323 (not re-normalized to sum to 1;
NCC is scale-invariant). Heatmaps are channels-first here: ``(L, H, W)``,
where the JAX package returns ``(H, W, L)``.
"""

from __future__ import annotations

import math

import torch


def gaussian_heatmap(
    num_rows: int,
    num_cols: int,
    sigma: float,
    peak_row: float | None = None,
    peak_col: float | None = None,
    device=None,
) -> torch.Tensor:
    """Single (H, W) Gaussian heatmap; the default peak is the image center
    (reference util.py:38-51)."""
    if peak_row is None:
        peak_row = num_rows // 2
    if peak_col is None:
        peak_col = num_cols // 2
    ys = torch.arange(num_rows, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(num_cols, dtype=torch.float32, device=device)[None, :]
    d2 = (xs - peak_col) ** 2 + (ys - peak_row) ** 2
    return torch.exp(d2 / (sigma * sigma * -2.0)) / (2.0 * math.pi * sigma * sigma)


def synthesize_heatmaps(lands_xy: torch.Tensor, num_rows: int, num_cols: int, sigma: float = 2.5) -> torch.Tensor:
    """Heatmaps for ``(..., 2, L)`` landmarks (row 0 = x, row 1 = y; inf
    marks out-of-view, dataset.py:317-325) -> ``(..., L, H, W)`` float32;
    channels of non-finite landmarks are zero. sigma 2.5 is the reference's
    hardcoded value (dataset.py:306)."""
    mu_x = lands_xy[..., 0, :]
    mu_y = lands_xy[..., 1, :]
    finite = torch.isfinite(mu_x) & torch.isfinite(mu_y)
    # avoid inf - inf = nan below
    mu_x = torch.where(finite, mu_x, torch.zeros_like(mu_x))[..., None, None]
    mu_y = torch.where(finite, mu_y, torch.zeros_like(mu_y))[..., None, None]
    ys = torch.arange(num_rows, dtype=torch.float32, device=lands_xy.device)[:, None]
    xs = torch.arange(num_cols, dtype=torch.float32, device=lands_xy.device)[None, :]
    d2 = (xs - mu_x) ** 2 + (ys - mu_y) ** 2
    pdf = torch.exp(d2 / (sigma * sigma * -2.0)) / (2.0 * math.pi * sigma * sigma)
    return torch.where(finite[..., None, None], pdf, torch.zeros_like(pdf))
