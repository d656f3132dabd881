"""Raw full-resolution frames (1536^2 detector intensities) for the
inference cells.

``make_raw_frames_numpy`` is a frozen copy of the raw frame maker of
``deepfluoro_tpu_torch/data/fixtures.py::make_synthetic_fullres_data``
(``np.exp(-projs)`` of ``make_specimen``'s frames: bone dark) as of commit
de33eddd4053c3511aa15a93546e00f9499bb3ba. At 1536^2 it takes about a third
of a second a frame on the host, so the cells use ``make_raw_frames``: the
same construction (a blocky background at 8-pixel cells, one elliptical
blob per class at fixed sectors, Gaussian noise of 0.01, then exp(-x)),
drawn on the device from a ``torch.Generator`` in a few calls per frame
and copied to host memory, where a C-arm's frames arrive. Even frames are
flagged rot-180, as in the fixture.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fluorobench.traffic.specimens import make_specimen


def make_raw_frames_numpy(seed: int, num_frames: int, img_dim: int, land_names, num_classes: int = 7):
    """(frames (N, R, C) float32 raw intensities, rot flags (N,) bool)."""
    rng = np.random.default_rng(seed)
    projs, _, _ = make_specimen(rng, num_frames, img_dim, num_classes, land_names)
    return np.exp(-projs).astype(np.float32), np.arange(num_frames) % 2 == 0


def make_raw_frames(seed: int, num_frames: int, img_dim: int, device, num_classes: int = 7):
    """(frames (N, R, C) float32 host numpy raw intensities, rot flags
    (N,) bool), drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h = w = img_dim
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    n_cls = num_classes - 1
    ang = torch.tensor([2 * math.pi * c / max(1, n_cls) for c in range(n_cls)], device=device)
    out = torch.empty((num_frames, h, w), dtype=torch.float32, device=device)
    for n in range(num_frames):
        cells = torch.rand((h // 8 + 1, w // 8 + 1), generator=gen, device=device)
        img = 0.4 + 0.2 * cells.repeat_interleave(8, 0).repeat_interleave(8, 1)[:h, :w]
        u = torch.rand((n_cls, 4), generator=gen, device=device)
        cx = w / 2 + 0.26 * w * torch.cos(ang) + (u[:, 0] * 0.08 - 0.04) * w
        cy = h / 2 + 0.26 * h * torch.sin(ang) + (u[:, 1] * 0.08 - 0.04) * h
        ry = h * (0.10 + 0.05 * u[:, 2])
        rx = w * (0.10 + 0.05 * u[:, 3])
        inside = (((ys - cy[:, None, None]) / ry[:, None, None]) ** 2
                  + ((xs - cx[:, None, None]) / rx[:, None, None]) ** 2) <= 1.0
        bump = (0.22 + 0.07 * torch.arange(1, num_classes, device=device, dtype=torch.float32))[:, None, None]
        img = img + (inside * bump).sum(0)
        img = img + 0.01 * torch.randn((h, w), generator=gen, device=device)
        out[n] = torch.exp(-img)
    return out.cpu().numpy(), np.arange(num_frames) % 2 == 0
