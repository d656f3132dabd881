"""Annotation overlay CLI (JAX counterpart: ``deepfluoro_tpu/cli/
overlay_est_ann.py``; contract of reference overlay_est_ann.py:25-161):

  python -m deepfluoro_tpu_torch.cli.overlay_est_ann ipcai_2020_ds_8x.h5 \\
    spec_1_test.h5 nn-segs 1 3 spec_1_est_ann_proj_3.png \\
    --lands --no-gt-lands --lands-csv spec_1_lands.csv [--no-gpu]

The blends run on CUDA; without a card it refuses unless given
``--no-gpu``. The frame moves to the host only for PIL.
"""

from __future__ import annotations

import argparse

import torch

from deepfluoro_tpu_torch.data.hdf5 import load_dataset
from deepfluoro_tpu_torch.utils.platform import get_device
from deepfluoro_tpu_torch.viz.overlays import make_overlay_est_ann, read_est_lands_csv


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="overlay segs",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("ds_path", help="HDF5 archive with the projections (and GT landmarks)", type=str)
    parser.add_argument("seg_file", help="HDF5 file from test_ensemble", type=str)
    parser.add_argument("seg_group", help="group path of the estimated label maps", type=str)
    parser.add_argument("pat_ind", help="specimen ID", type=int)
    parser.add_argument("proj_ind", help="projection index within the specimen", type=int)
    parser.add_argument("out_overlay", help="destination PNG", type=str)
    parser.add_argument("--lands", help="draw ground-truth and estimated landmarks", action="store_true")
    parser.add_argument("--no-gt-lands", help="skip the ground-truth landmark markers", action="store_true")
    parser.add_argument("--no-seg", help="skip the segmentation blend", action="store_true")
    parser.add_argument("--lands-csv", help="landmark CSV from est_lands_csv to draw", type=str)
    parser.add_argument("--num-classes", help="segmentation class count incl. background", type=int, default=7)
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    return parser


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    dev = get_device("cpu" if args.no_gpu else None)

    est_lands = {}
    if args.lands:
        est_lands = read_est_lands_csv(args.lands_csv, args.pat_ind, args.proj_ind)

    data = load_dataset(args.ds_path, [args.pat_ind], no_seg=True)
    # the reference min-max normalizes the z-normed sample (overlay_est_ann.py:
    # 88-92); z-norm is affine, so the raw projection normalizes the same
    proj = torch.from_numpy(data.projs[args.proj_ind]).to(dev)

    est_seg = None
    if not args.no_seg:
        with h5py.File(args.seg_file, "r") as f:
            # one chunk: nn-segs is gzip 9 in per-image chunks
            est_seg = torch.from_numpy(f[args.seg_group][args.proj_ind]).to(dev)

    gt_lands = None
    if args.lands and not args.no_gt_lands and data.lands is not None:
        gt_lands = data.lands[args.proj_ind]

    make_overlay_est_ann(proj, est_seg, gt_lands, est_lands if args.lands else None, args.out_overlay,
                         num_classes=args.num_classes)


if __name__ == "__main__":
    main()
