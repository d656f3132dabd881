"""Hard-Dice CLI (JAX counterpart: ``deepfluoro_tpu/cli/
compute_actual_dice_on_test.py``; contract of reference
compute_actual_dice_on_test.py:19-96):

  python -m deepfluoro_tpu_torch.cli.compute_actual_dice_on_test \\
    ipcai_2020_ds_8x.h5 spec_1_test.h5 nn-segs spec_1_dice.csv 1 [--no-gpu]

Runs on CUDA; without a card it refuses unless given ``--no-gpu``.
"""

from __future__ import annotations

import argparse

import torch

from deepfluoro_tpu_torch.eval.dice import hard_dice, write_dice_csv
from deepfluoro_tpu_torch.native.chunkzip import read_dataset_direct
from deepfluoro_tpu_torch.utils.platform import get_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="compute actual dice coefficients between estimated segmentations and ground truth. Scores are written out in CSV format.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("ds_path", help="HDF5 archive with the ground-truth segmentations", type=str)
    parser.add_argument("seg_file", help="HDF5 file holding the estimated label maps", type=str)
    parser.add_argument("seg_group", help="group path of the estimated label maps", type=str)
    parser.add_argument("csv_out", help="destination CSV (pat,proj,label,dice)", type=str)
    parser.add_argument("pat_ind", help="specimen ID to evaluate", type=int)
    parser.add_argument("--no-hdr", help="omit the CSV header row", action="store_true")
    parser.add_argument("--num-classes", help="segmentation class count incl. background", type=int, default=7)
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    return parser


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    dev = get_device("cpu" if args.no_gpu else None)

    with h5py.File(args.ds_path, "r") as f:
        gt_segs = torch.from_numpy(f["{:02d}/segs".format(args.pat_ind)][:]).to(dev)
    with h5py.File(args.seg_file, "r") as f:
        # nn-segs follow the per-image-chunk gzip contract: direct chunk
        # reads and the native codec's parallel inflate
        est_segs = torch.from_numpy(read_dataset_direct(f[args.seg_group])).to(dev)
    if gt_segs.shape[0] != est_segs.shape[0]:
        raise ValueError("{} ground-truth label maps, {} estimated".format(gt_segs.shape[0], est_segs.shape[0]))

    dices = hard_dice(gt_segs, est_segs, args.num_classes)
    write_dice_csv(args.csv_out, args.pat_ind, dices, no_hdr=args.no_hdr)


if __name__ == "__main__":
    main()
