"""Per-specimen tiled GT overlay PNGs of a preprocessed archive (JAX
counterpart: ``deepfluoro_tpu/cli/make_preproc_overlays.py``; reference
examples_dataset/make_preproc_overlays.py):

  python -m deepfluoro_tpu_torch.cli.make_preproc_overlays <preproc.h5> [out_dir] [--no-gpu]

The blends run on CUDA; without a card it refuses unless given
``--no-gpu``. ``-h``/``--help`` prints this text (the JAX CLI has no
help: it takes any first argument as the archive).
"""

from __future__ import annotations

import sys

from deepfluoro_tpu_torch.viz.examples import make_preproc_overlays


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "-h" in argv or "--help" in argv:
        print(__doc__.strip())
        sys.exit(0)
    device = "cpu" if "--no-gpu" in argv else None
    argv = [a for a in argv if a != "--no-gpu"]
    if len(argv) < 1:
        print("ERROR: supply path to HDF5 data file as first argument")
        sys.exit(1)
    out_dir = argv[1] if len(argv) > 1 else "."
    for p in make_preproc_overlays(argv[0], out_dir, device=device):
        print(p)


if __name__ == "__main__":
    main()
