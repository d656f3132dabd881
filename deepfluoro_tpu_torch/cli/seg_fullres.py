"""Full-resolution ensemble inference CLI: raw archive in, nn-segs out
(JAX counterpart: ``deepfluoro_tpu/cli/seg_fullres.py``).

  python -m deepfluoro_tpu_torch.cli.seg_fullres ipcai_2020_full_res_data.h5 \\
    spec_17-1882_test.h5 --ds-factor 8 --nets yy_best_net.pt [more.pt ...] \\
    [--pats 17-1882,18-1109] [--batch-size N] [--times times.txt] [--no-gpu] \\
    [--int8 [--int8-float-levels N]] [--profile-dir DIR]

The reference's test_ensemble.py reads preprocessed per-rung archives;
this reads the raw full-res archive and preprocesses each batch on the
device (crop, log, rot-180, downsample, pad, z-norm) in front of the
ensemble (``infer/fullres.py``). The output carries the ``nn-segs``/
``nn-heats``/``land-names`` contract of ``cli/test_ensemble.py``, so
``est_lands_csv`` and ``compute_actual_dice_on_test`` read it against a
preprocessed archive of the same factor. Runs on CUDA with TF32 off;
without a card it refuses unless given ``--no-gpu``. ``--int8`` runs the
members' post-training int8 forwards, calibrated on the first batch of
frames through the same prep; ``--profile-dir`` writes a
``torch.profiler`` trace of the inference.
"""

from __future__ import annotations

import argparse

import torch

from deepfluoro_tpu_torch.data.hdf5 import write_land_names
from deepfluoro_tpu_torch.infer.ensemble import load_net_from_checkpoint
from deepfluoro_tpu_torch.infer.fullres import fullres_land_names, list_fullres_frames, seg_fullres_dataset
from deepfluoro_tpu_torch.utils.io import write_floats_to_txt
from deepfluoro_tpu_torch.utils.platform import get_device
from deepfluoro_tpu_torch.utils.profiling import profile_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run the ensemble directly on a RAW full-resolution archive.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("input_data_file_path", help="input FULL-RES HDF5 archive (raw 1536^2 frames)", type=str)
    parser.add_argument("output_data_file_path", help="output HDF5 file for nn-segs / nn-heats", type=str)
    parser.add_argument("--ds-factor", help="downsample factor the nets were trained at (1/2/4/8/16)", type=int, required=True)
    parser.add_argument("--nets", help="checkpoint files of the ensemble members", type=str, nargs="+", required=True)
    parser.add_argument("--pats", help="comma-separated full-res specimen GROUP NAMES (e.g. 17-1882); default: all", type=str, default="")
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    parser.add_argument("--times", help="write per-image inference seconds to this file", type=str, default="")
    parser.add_argument("--batch-size", help="frames per fused inference batch", type=int, default=4)
    parser.add_argument("--int8", help="post-training int8 (w8a8) inference, scales calibrated on the first batch through the same prep", action="store_true")
    parser.add_argument("--int8-float-levels", help="with --int8: keep the finest N U-Net levels in float", type=int, default=0)
    parser.add_argument("--profile-dir", help="Write a torch.profiler trace (TensorBoard-loadable) to this directory", type=str, default="")
    return parser


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    dev = get_device("cpu" if args.no_gpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    models = []
    cfg = None
    for net_path in args.nets:
        print("  loading state from disk for: {}".format(net_path))
        model, net_cfg = load_net_from_checkpoint(net_path, device=dev)
        models.append(model)
        if cfg is not None:
            for field in ("num_lands", "proj_unet_dim", "num_classes"):
                a, b = getattr(cfg, field), getattr(net_cfg, field)
                if a != b:
                    raise ValueError("ensemble members disagree on {}: {} vs {} ({})".format(field, a, b, net_path))
        cfg = net_cfg

    specimens = [s for s in args.pats.split(",") if s] or None
    times: list[float] = []
    with h5py.File(args.input_data_file_path, "r") as src, h5py.File(args.output_data_file_path, "w") as f:
        entries = list_fullres_frames(src, specimens)
        print("Number of full-res projections: {}".format(len(entries)))
        if cfg.num_lands > 0:
            land_names = fullres_land_names(src, entries)
            if land_names is not None:
                if len(land_names) != cfg.num_lands:
                    raise ValueError("archive carries {} landmark names but the nets expect {}".format(
                        len(land_names), cfg.num_lands))
                write_land_names(f, land_names)
        print("running fused preprocess + ensemble on raw frames")
        with profile_trace(args.profile_dir):
            seg_fullres_dataset(
                src, specimens, models, f, ds_factor=args.ds_factor, num_lands=cfg.num_lands, times=times,
                batch_size=args.batch_size, pad_img_dim=cfg.proj_unet_dim, quantized=args.int8,
                int8_float_levels=args.int8_float_levels,
            )
        f.flush()

    if args.times:
        write_floats_to_txt(args.times, times)


if __name__ == "__main__":
    main()
