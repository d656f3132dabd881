"""Convert the full-resolution archive into a preprocessed training
archive (JAX counterpart: ``deepfluoro_tpu/cli/preprocess_full_res.py``):
crop 50 px borders, Beer-Lambert log, patient-up rotation and 2x/4x/8x/16x
downsampling, on the device, the pipeline the reference documents
(README.md:84-95).

  python -m deepfluoro_tpu_torch.cli.preprocess_full_res full_res.h5 out_8x.h5 --ds-factor 8

Runs on CUDA; without a card it refuses unless given ``--no-gpu``.
"""

from __future__ import annotations

import argparse

from deepfluoro_tpu_torch.data.preprocess import full_res_to_preprocessed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Preprocess the full-resolution archive into a training-ready dataset.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("input_path", help="full-resolution HDF5 archive", type=str)
    parser.add_argument("output_path", help="output preprocessed HDF5", type=str)
    parser.add_argument("--ds-factor", help="downsampling factor per 2D dim (2/4/8/16)", type=int, default=8)
    parser.add_argument("--no-gpu", help="Only use CPU", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = full_res_to_preprocessed(args.input_path, args.output_path, args.ds_factor,
                                   device="cpu" if args.no_gpu else None)
    print("wrote {}".format(out))


if __name__ == "__main__":
    main()
