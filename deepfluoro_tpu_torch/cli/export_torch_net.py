"""Write a JAX package checkpoint (flax msgpack) as a reference ``.pt``
file, without JAX (JAX counterpart: ``deepfluoro_tpu/cli/
export_torch_net.py``, which needs JAX). A format conversion on the CPU:

  python -m deepfluoro_tpu_torch.cli.export_torch_net zz_checkpoint.pt reference_net.pt

The file equals the JAX exporter's (``compat/from_jax.py::
torch_checkpoint_from_jax``): the reference's ``train.py`` resumes from it
and ``test_ensemble`` loads it, as do this package's loaders.
"""

from __future__ import annotations

import argparse
import os

import torch

from deepfluoro_tpu_torch.compat.from_jax import torch_checkpoint_from_jax
from deepfluoro_tpu_torch.train.checkpoint import is_torch_checkpoint


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="export a JAX package (msgpack) checkpoint as a reference torch .pt file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("native_path", help="JAX package (msgpack) checkpoint to export", type=str)
    parser.add_argument("out_path", help="destination .pt file", type=str)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if is_torch_checkpoint(args.native_path):
        raise SystemExit("{} is already a torch checkpoint".format(args.native_path))
    tmp = "{}.tmp".format(args.out_path)
    torch.save(torch_checkpoint_from_jax(args.native_path), tmp)
    os.replace(tmp, args.out_path)
    print(args.out_path)


if __name__ == "__main__":
    main()
