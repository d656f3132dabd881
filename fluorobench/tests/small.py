"""Cells cut to a size the CPU runs in seconds, for the tests: depth 2,
wf 2; training frames of 32^2 padded to 36, six frames a specimen; raw
frames of 148^2 at the 2x factor (24^2 padded to 28), a pool of four."""

from pathlib import Path

import torch

from fluorobench import harness

ROOT = Path(__file__).resolve().parents[2]


def small_cell(name: str) -> harness.Cell:
    """A cell of ``BENCHMARK.json`` cut to test size."""
    cell = harness.load_cell(ROOT, name)
    cfg = dict(cell.config, depth=2, init_feats_exp=2)
    if cell.traffic["runner"] == "train":
        cfg.update(frame=32, proj_unet_dim=36)
        cell.traffic = dict(cell.traffic, frames_per_specimen=6)
    else:
        cfg.update(raw_frame=148, proj_unet_dim=28, ds_factor=2)
        cell.traffic = dict(cell.traffic, pool_frames=4, warmup_items=1, check_frames=3)
    cell.config = cfg
    return cell


def small_run(name: str, seed: int = 2**31 + 11, seconds: float | None = None, trace: bool = False) -> harness.Run:
    """A tiny run of ``name``; a training run's window (2 s by default) has
    to hold the checked epoch, the second after the warm-up, at the CPU's
    40-50 ms a step."""
    cell = small_cell(name)
    if seconds is None:
        seconds = 2.0 if cell.traffic["runner"] == "train" else 0.5
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"))
