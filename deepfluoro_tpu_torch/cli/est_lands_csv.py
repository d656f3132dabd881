"""Landmark location CLI (JAX counterpart: ``deepfluoro_tpu/cli/
est_lands_csv.py``; contract of reference est_lands_csv.py:24-134):

  python -m deepfluoro_tpu_torch.cli.est_lands_csv spec_1_test.h5 nn-heats \\
    --use-seg nn-segs --pat 1 --out spec_1_lands.csv [--no-gpu]

Runs on CUDA; without a card it refuses unless given ``--no-gpu``.
"""

from __future__ import annotations

import argparse

import torch

from deepfluoro_tpu_torch.data.hdf5 import get_land_names_from_dataset
from deepfluoro_tpu_torch.eval.landmarks import detect_landmarks_timed, write_landmarks_csv
from deepfluoro_tpu_torch.utils.platform import get_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="estimate landmark locations and write to CSV",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("heat_file_path", help="HDF5 file holding the estimated heatmaps (test_ensemble output)", type=str)
    parser.add_argument("heats_group_path", help="group path of the heatmaps inside the file", type=str)
    parser.add_argument("--out", help="destination CSV of detected landmark locations", type=str, default="yy_lands_est.csv")
    parser.add_argument("--pat", help="specimen ID written into the CSV rows", type=int)
    parser.add_argument("--use-seg", help="group path of estimated segmentations; gates each landmark to its structure", type=str, default="")
    parser.add_argument("--no-hdr", help="omit the CSV header row", action="store_true")
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    return parser


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    dev = get_device("cpu" if args.no_gpu else None)
    land_names = get_land_names_from_dataset(args.heat_file_path)

    print("reading heatmaps...")
    with h5py.File(args.heat_file_path, "r") as f:
        heats = torch.from_numpy(f[args.heats_group_path][:]).to(dev)
        segs = torch.from_numpy(f[args.use_seg][:]).to(dev) if args.use_seg else None

    print("detecting landmark locations...")
    rows, cols, times = detect_landmarks_timed(heats, land_names, segs)
    write_landmarks_csv(args.out, args.pat, rows, cols, per_land_time=times, no_hdr=args.no_hdr)


if __name__ == "__main__":
    main()
