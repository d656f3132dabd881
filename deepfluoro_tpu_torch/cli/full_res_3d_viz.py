"""Interactive 3D view of the projective geometry (JAX counterpart:
``deepfluoro_tpu/cli/full_res_3d_viz.py``; reference examples_dataset/
full_res_3d_viz.py). Needs the optional ``vtk`` package.

  python -m deepfluoro_tpu_torch.cli.full_res_3d_viz full_res.h5 17-1882 --proj 0 [--no-gpu]

The scene's geometry runs on CUDA; without a card it refuses unless given
``--no-gpu``. VTK gets host numbers.
"""

from __future__ import annotations

import argparse

from deepfluoro_tpu_torch.viz.projective import view_3d_scene


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="3D visualization of CT meshes, landmarks, and projection geometry.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("ds_path", help="Path to full-resolution HDF5 archive", type=str)
    parser.add_argument("spec_id", help="Specimen group name (e.g. 17-1882)", type=str)
    parser.add_argument("--proj", help="projection index", type=int, default=0)
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    view_3d_scene(args.ds_path, args.spec_id, args.proj, device="cpu" if args.no_gpu else None)


if __name__ == "__main__":
    main()
