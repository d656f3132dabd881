"""Landmark locations from estimated heatmaps, the reference's "rule 3"
(JAX counterpart: ``deepfluoro_tpu/eval/landmarks.py``; reference
est_lands_csv.py:56-134).

Per projection and landmark:
  1. the heatmap's argmax over the pixels whose estimated class is the
     landmark's structure (name -> label map below); not found when the
     class is absent;
  2. the 25x25 window at that peak in the 12-px reflect-padded heatmap (the
     peak's index in the unpadded heatmap is the window's start in the
     padded one, est_lands_csv.py:113-119);
  3. found only where NCC(sigma-2.5 Gaussian template, window) >= 0.9
     (est_lands_csv.py:87,121-122).

The reference loops per projection and landmark in Python; here the whole
(N, L) grid is a few batched torch operations on the heatmaps' device.
The windows are gathered by index arithmetic: row and column indices
reflected at the borders, which equals ``F.pad(..., mode="reflect")``
(and ``jnp.pad`` reflect) for frames of at least 13 pixels.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deepfluoro_tpu_torch.ops.heatmap import gaussian_heatmap
from deepfluoro_tpu_torch.ops.losses import ncc_2d
from deepfluoro_tpu_torch.utils.profiling import count, span

# landmark name -> estimated-seg label gating its detection
# (est_lands_csv.py:56-73; labels per README.md:33-41)
SEG_LABELS_TO_USE_FOR_LANDS = {
    "FH-l": 5, "FH-r": 6,
    "GSN-l": 1, "GSN-r": 2,
    "IOF-l": 1, "IOF-r": 2,
    "MOF-l": 1, "MOF-r": 2,
    "SPS-l": 1, "SPS-r": 2,
    "IPS-l": 1, "IPS-r": 2,
    "ASIS-l": 1, "ASIS-r": 2,
    "PSIS-l": 1, "PSIS-r": 2,
    "PIIS-l": 1, "PIIS-r": 2,
}

_ROI = 25
_PAD = 12
_NCC_THRESH = 0.9


def _gate_labels(land_names) -> list[int]:
    """Seg label per landmark; -1 disables gating."""
    return [SEG_LABELS_TO_USE_FOR_LANDS.get(nm, -1) for nm in land_names]


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index into a reflect-padded axis of length n -> index into the axis
    (edge not repeated; one reflection, so |pad| < n)."""
    i = i.abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


@torch.no_grad()
def detect_landmarks(heats: torch.Tensor, land_names, segs: torch.Tensor | None = None):
    """Detect all landmarks in all projections on ``heats``' device.

    heats: (N, L, H, W) estimated heatmaps (the ``nn-heats`` layout);
    land_names: L names (they select each landmark's gating class); segs:
    optional (N, H, W) estimated label maps (``nn-segs``).
    Returns (rows, cols): two (N, L) int32 numpy arrays, -1 where not found.
    """
    with span("landmarks.detect"):
        n, l, h, w = heats.shape
        if len(land_names) != l:
            raise ValueError("{} landmark names for {} heatmaps".format(len(land_names), l))
        if min(h, w) <= _PAD:
            raise ValueError("frames of {}x{} are too small for the {}-px reflect pad".format(h, w, _PAD))
        dev = heats.device
        heats = heats.float()
        masked = heats
        if segs is not None:
            gate = torch.tensor(_gate_labels(land_names), device=dev)[None, :, None, None]
            allowed = (segs.to(dev).long()[:, None] == gate) | (gate < 0)
            masked = torch.where(allowed, heats, torch.full_like(heats, -torch.inf))
        flat = masked.reshape(n, l, h * w)
        # torch.argmax takes the first index of ties, as jnp.argmax
        idx = flat.argmax(dim=2)
        found = torch.isfinite(flat.gather(2, idx[..., None])[..., 0])
        r, c = idx // w, idx % w

        off = torch.arange(-_PAD, _PAD + 1, device=dev)
        rr = _reflect(r[..., None] + off, h)[..., :, None]  # (N, L, 25, 1)
        cc = _reflect(c[..., None] + off, w)[..., None, :]  # (N, L, 1, 25)
        ni = torch.arange(n, device=dev)[:, None, None, None]
        li = torch.arange(l, device=dev)[None, :, None, None]
        roi = heats[ni, li, rr, cc]  # (N, L, 25, 25)
        template = gaussian_heatmap(_ROI, _ROI, 2.5, device=dev)
        found &= ncc_2d(template, roi) >= _NCC_THRESH

        rows = torch.where(found, r, torch.full_like(r, -1)).to(torch.int32)
        cols = torch.where(found, c, torch.full_like(c, -1)).to(torch.int32)
        count("host_syncs", 2)
        return rows.cpu().numpy(), cols.cpu().numpy()


def detect_landmarks_timed(heats: torch.Tensor, land_names, segs: torch.Tensor | None = None):
    """:func:`detect_landmarks` one projection at a time, timed, so the CSV's
    ``time`` column varies per row as the reference's per-detection timing
    does (est_lands_csv.py:94,131-133). Each projection's wall-clock, from
    the call to its result on the host after a synchronise, is divided
    evenly over its L landmarks; one warm-up call runs before timing.

    Returns (rows (N, L), cols (N, L), times (N, L) seconds)."""
    n, l = heats.shape[:2]
    dev = heats.device

    def one(i):
        return detect_landmarks(heats[i : i + 1], land_names, None if segs is None else segs[i : i + 1])

    one(0)
    rows = np.empty((n, l), np.int32)
    cols = np.empty((n, l), np.int32)
    times = np.empty((n, l), np.float64)
    for i in range(n):
        t0 = time.perf_counter()
        r, c = one(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[i] = (time.perf_counter() - t0) / l
        rows[i], cols[i] = r[0], c[0]
    return rows, cols, times


def write_landmarks_csv(out_path: str, pat_ind: int, rows, cols, per_land_time=0.0, no_hdr: bool = False) -> None:
    """CSV contract of est_lands_csv.py:75-134: header
    ``pat,proj,land,row,col,time``; -1,-1 marks not found; '{:3f}' times.
    ``per_land_time`` is a scalar or an (N, L) array of per-detection
    seconds."""
    n, l = rows.shape
    times = np.broadcast_to(np.asarray(per_land_time, np.float64), (n, l))
    with open(out_path, "w") as csv_out:
        if not no_hdr:
            csv_out.write("pat,proj,land,row,col,time\n")
        for i in range(n):
            for land_ind in range(l):
                csv_out.write(
                    "{},{},{},{},{},{:3f}\n".format(
                        pat_ind, i, land_ind, int(rows[i, land_ind]), int(cols[i, land_ind]), times[i, land_ind]
                    )
                )
