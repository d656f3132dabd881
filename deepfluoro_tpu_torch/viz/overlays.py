"""Overlay rendering: estimated segmentation, landmark and heatmap overlays
(JAX counterpart: ``deepfluoro_tpu/viz/overlays.py``).

The reference CLIs' visual contracts:
- overlay_est_ann.py:99-161: alpha = 0.35 seg blend with the 7-color
  table, GT landmarks as yellow ellipses (box radius 2), estimated
  landmarks as yellow crosshairs (radius 6);
- overlay_est_heat.py:71-86: the min-max normalized heatmap blended green
  (the normalization skipped where the range is at most 1e-3).

The blends are tensor functions on (..., H, W) inputs on any device: one
pass over a whole batch of frames, where the JAX package loops over the
classes with boolean masks on one frame. They repeat its float32
operations one for one (``(1 - alpha) * out + alpha * color``, ``h / rng``
where ``rng > 1e-3``), so after ``to_uint8`` the pixels equal the JAX
package's. PIL draws the marks and writes the PNG, on the host; it is
imported inside the functions that need it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# class 1..7 colors (overlay_est_ann.py:108-114)
LABEL_COLORS = [
    (0.0, 1.0, 0.0),  # pelvis green
    (1.0, 0.0, 0.0),  # left femur red
    (0.0, 0.0, 1.0),  # right femur blue
    (1.0, 1.0, 0.0),  # yellow
    (0.0, 1.0, 1.0),  # cyan
    (1.0, 0.5, 0.0),  # orange
    (0.5, 0.0, 0.5),  # purple
]


def normalized_proj_rgb(proj: torch.Tensor) -> torch.Tensor:
    """(..., H, W) projections -> (..., H, W, 3) RGB in [0, 1], each frame
    min-max normalized over its own pixels (overlay_est_ann.py:88-97)."""
    lo = proj.amin(dim=(-2, -1), keepdim=True)
    hi = proj.amax(dim=(-2, -1), keepdim=True)
    g = (proj - lo) / (hi - lo)
    return torch.stack([g, g, g], dim=-1)


def blend_seg(img_rgb: torch.Tensor, seg: torch.Tensor, num_classes: int = 7, alpha: float = 0.35) -> torch.Tensor:
    """Alpha-blend each class 1..num_classes-1's color over the (..., H, W,
    3) image where the (..., H, W) labels hold it (overlay_est_ann.py:
    106-124)."""
    # alpha * color in double, then float32, as numpy takes the Python float
    table = torch.zeros((max(num_classes, 1), 3), dtype=torch.float64)
    for label in range(1, num_classes):
        table[label] = torch.tensor([alpha * c for c in LABEL_COLORS[label - 1]], dtype=torch.float64)
    table = table.to(device=img_rgb.device, dtype=img_rgb.dtype)
    labels = seg.to(device=img_rgb.device, dtype=torch.long)
    hit = ((labels >= 1) & (labels < num_classes))[..., None]
    blended = (1 - alpha) * img_rgb + table[labels.clamp(0, num_classes - 1)]
    return torch.where(hit, blended, img_rgb)


def blend_heat(img_rgb: torch.Tensor, heat: torch.Tensor, color=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """Blend each frame's (..., H, W) heatmap channel, min-max normalized
    over the frame unless its range is at most 1e-3, in ``color`` over the
    (..., H, W, 3) image (overlay_est_heat.py:71-84)."""
    lo = heat.amin(dim=(-2, -1), keepdim=True)
    rng = heat.amax(dim=(-2, -1), keepdim=True) - lo
    h = heat - lo
    h = torch.where(rng > 1.0e-3, h / rng, h)[..., None].to(img_rgb.device)
    rgb = torch.tensor(color, dtype=img_rgb.dtype, device=img_rgb.device)
    return (1 - h) * img_rgb + h * rgb


def to_uint8(img_rgb: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB -> uint8 as the PNG stores it: clip, times 255, truncate."""
    return (img_rgb.clamp(0, 1) * 255).to(torch.uint8)


def _to_pil(img_rgb: torch.Tensor):
    from PIL import Image

    return Image.fromarray(to_uint8(img_rgb).cpu().numpy(), "RGB")


def draw_gt_land(draw, xy, box_radius: int = 2, fill: str = "yellow"):
    x, y = xy
    draw.ellipse([(x - box_radius, y - box_radius), (x + box_radius, y + box_radius)], fill=fill)


def draw_est_land(draw, xy, r: int = 6, color: str = "yellow"):
    x, y = xy
    draw.line([(x, y + r), (x, y - r)], fill=color)
    draw.line([(x - r, y), (x + r, y)], fill=color)


def make_overlay_est_ann(
    proj: torch.Tensor,
    est_seg: torch.Tensor | None,
    gt_lands: np.ndarray | None,
    est_lands: dict[int, tuple[float, float]] | None,
    out_path: str,
    num_classes: int = 7,
) -> None:
    """Full annotation overlay of one (H, W) frame (overlay_est_ann.py:
    86-161): the blends on ``proj``'s device, the marks by PIL.
    gt_lands: (2, L) with inf for out of view; est_lands: {land_idx: (x,
    y)}."""
    from PIL import ImageDraw

    img = normalized_proj_rgb(proj)
    if est_seg is not None:
        img = blend_seg(img, est_seg, num_classes)
    pil = _to_pil(img)
    if gt_lands is not None or est_lands:
        draw = ImageDraw.Draw(pil)
        if gt_lands is not None:
            gt_lands = np.asarray(gt_lands)
            for l in range(gt_lands.shape[-1]):
                x, y = gt_lands[0, l], gt_lands[1, l]
                if math.isfinite(x) and math.isfinite(y):
                    draw_gt_land(draw, (x, y))
        if est_lands:
            for xy in est_lands.values():
                draw_est_land(draw, xy)
        del draw
    pil.save(out_path)


def make_overlay_est_heat(proj: torch.Tensor, est_heat: torch.Tensor, out_path: str) -> None:
    """Heatmap overlay of one (H, W) frame (overlay_est_heat.py:53-86)."""
    _to_pil(blend_heat(normalized_proj_rgb(proj), est_heat)).save(out_path)


def read_est_lands_csv(csv_path: str, pat_ind: int, proj: int) -> dict[int, tuple[int, int]]:
    """Parse the landmark CSV back into {land_idx: (col, row)} for one
    projection, skipping not-found rows (overlay_est_ann.py:69-84)."""
    est_lands = {}
    with open(csv_path) as f:
        lines = f.readlines()[1:]
    for line in lines:
        toks = line.strip().split(",")
        if int(toks[0]) == pat_ind and int(toks[1]) == proj:
            land_row, land_col = int(toks[3]), int(toks[4])
            if land_row >= 0 and land_col >= 0:
                idx = int(toks[2])
                if idx in est_lands:
                    raise ValueError("landmark {} of specimen {} projection {} appears twice in {}".format(
                        idx, pat_ind, proj, csv_path))
                est_lands[idx] = (land_col, land_row)
    return est_lands
