"""Heatmap overlay CLI (JAX counterpart: ``deepfluoro_tpu/cli/
overlay_est_heat.py``; contract of reference overlay_est_heat.py:22-86):

  python -m deepfluoro_tpu_torch.cli.overlay_est_heat ipcai_2020_ds_8x.h5 \\
    spec_1_test.h5 nn-heats 1 3 1 spec_1_proj_3_fhr_est_heat.png [--no-gpu]

The blend runs on CUDA; without a card it refuses unless given
``--no-gpu``. The frame moves to the host only for PIL.
"""

from __future__ import annotations

import argparse

import torch

from deepfluoro_tpu_torch.data.hdf5 import load_dataset
from deepfluoro_tpu_torch.utils.platform import get_device
from deepfluoro_tpu_torch.viz.overlays import make_overlay_est_heat


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="overlay estimated heat maps for a specific projection and landmark",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("ds_path", help="HDF5 archive with the projections", type=str)
    parser.add_argument("seg_file", help="HDF5 file from test_ensemble", type=str)
    parser.add_argument("seg_group", help="group path of the estimated heatmaps", type=str)
    parser.add_argument("pat_ind", help="specimen ID", type=int)
    parser.add_argument("proj_ind", help="projection index within the specimen", type=int)
    parser.add_argument("land_ind", help="heatmap channel (landmark) to blend", type=int)
    parser.add_argument("out_overlay", help="destination PNG", type=str)
    parser.add_argument("--num-classes", help="segmentation class count incl. background", type=int, default=7)
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    return parser


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    dev = get_device("cpu" if args.no_gpu else None)

    data = load_dataset(args.ds_path, [args.pat_ind], no_seg=True)
    proj = torch.from_numpy(data.projs[args.proj_ind]).to(dev)
    with h5py.File(args.seg_file, "r") as f:
        est_heat = torch.from_numpy(f[args.seg_group][args.proj_ind, args.land_ind, :, :]).to(dev)

    make_overlay_est_heat(proj, est_heat, args.out_overlay)


if __name__ == "__main__":
    main()
