"""Ensemble segmentation and heatmap estimation CLI (JAX counterpart:
``deepfluoro_tpu/cli/test_ensemble.py``; contract of reference
test_ensemble.py:20-148):

  python -m deepfluoro_tpu_torch.cli.test_ensemble ipcai_2020_ds_8x.h5 \\
    spec_1_test.h5 --pats 1 --nets yy_best_net.pt [more.pt ...] \\
    [--times times.txt] [--no-gpu] [--batch-size N] [--int8
    [--int8-calib-batches N] [--int8-float-levels N]] [--profile-dir DIR]

Writes ``nn-segs`` (u1, gzip 9), ``nn-heats`` and the ``land-names`` group
to the output HDF5, and optionally one line of seconds per image. Runs on
CUDA with TF32 off (the recipe is float32); without a card it refuses
unless given ``--no-gpu``. ``--int8`` runs the members' post-training
int8 forwards (``infer/quantized.py``), calibrated on the first
``--int8-calib-batches`` batches of the input; ``--profile-dir`` writes a
``torch.profiler`` trace of the inference.

``--ensemble-devices E`` and ``--dp-devices D`` run E x D local workers,
one per card: each loads its K/E members (E must divide the number of
``--nets``) and takes its 1/D of every batch (D must divide
``--batch-size``); process 0 writes the file and the times. Under
``torchrun`` with E x D processes each process is one of them.
"""

from __future__ import annotations

import argparse

import torch

from deepfluoro_tpu_torch.data.hdf5 import get_land_names_from_dataset, load_dataset, write_land_names
from deepfluoro_tpu_torch.infer.ensemble import load_net_from_checkpoint, seg_dataset_ensemble
from deepfluoro_tpu_torch.parallel import make_mesh, process_count
from deepfluoro_tpu_torch.parallel.multihost import is_writer, launch
from deepfluoro_tpu_torch.parallel.sharding import sum_over
from deepfluoro_tpu_torch.utils.io import write_floats_to_txt
from deepfluoro_tpu_torch.utils.platform import get_device
from deepfluoro_tpu_torch.utils.profiling import profile_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run ensemble segmentation and heatmap estimation.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("input_data_file_path", help="input HDF5 archive with the test projections", type=str)
    parser.add_argument("output_data_file_path", help="output HDF5 file for nn-segs / nn-heats", type=str)
    parser.add_argument("--nets", help="checkpoint files of the ensemble members", type=str, nargs="+", required=True)
    parser.add_argument("--pats", help="comma-separated specimen IDs to run inference on", type=str, required=True)
    parser.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    parser.add_argument("--times", help="write per-image inference seconds to this file", type=str, default="")
    parser.add_argument("--batch-size", help="Images per inference batch (1 matches the reference's timing granularity)", type=int, default=1)
    parser.add_argument("--profile-dir", help="Write a torch.profiler trace (TensorBoard-loadable) to this directory", type=str, default="")
    parser.add_argument("--int8", help="post-training int8 quantized inference: every conv runs s8 x s8 -> s32 on the int8 tensor cores with activation scales calibrated on the first batches of the input data (framework extension; the reference infers in float32)", action="store_true")
    parser.add_argument("--int8-calib-batches", help="number of leading input batches used to calibrate the int8 activation scales", type=int, default=4)
    parser.add_argument("--int8-float-levels", help="hybrid mode: keep the finest N U-Net levels in float and quantize only the deeper levels", type=int, default=0)
    parser.add_argument("--ensemble-devices", help="shard the ensemble members over this many devices (must divide the number of --nets); 0 = off", type=int, default=0)
    parser.add_argument("--dp-devices", help="also shard each inference batch over this many devices (must divide --batch-size); composes with --ensemble-devices on one mesh", type=int, default=0)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    n = max(1, args.ensemble_devices) * max(1, args.dp_devices)
    launch(run, args, n, device="cpu" if args.no_gpu else "cuda")


def run(args):
    """Run the ensemble on this process (its members and rows when there
    are several processes)."""
    import h5py

    dev = get_device("cpu" if args.no_gpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    test_pats = [int(i) for i in args.pats.split(",")]
    world = process_count()
    mesh = None
    nets = args.nets
    if world > 1:
        ens = args.ensemble_devices or (world // max(1, args.dp_devices))
        dp = args.dp_devices or (world // ens)
        mesh = make_mesh({"ensemble": ens, "data": dp})
        if len(nets) % ens:
            raise ValueError("{} ensemble members do not shard evenly over the {}-way 'ensemble' mesh axis".format(
                len(nets), ens))
        nets = nets[mesh.axis("ensemble").rows(len(nets))]
        if is_writer():
            print("device mesh: {}".format(mesh.axes), flush=True)

    models = []
    cfg = None
    for net_path in nets:
        print("  loading state from disk for: {}".format(net_path))
        model, net_cfg = load_net_from_checkpoint(net_path, device=dev)
        models.append(model)
        # members that disagree here would run at the wrong padded size
        if cfg is not None:
            for field in ("num_lands", "proj_unet_dim", "num_classes"):
                a, b = getattr(cfg, field), getattr(net_cfg, field)
                if a != b:
                    raise ValueError("ensemble members disagree on {}: {} vs {} ({})".format(field, a, b, net_path))
        cfg = net_cfg

    if mesh is not None:
        # every process's members must agree with every other's
        fields = [cfg.num_lands, cfg.proj_unet_dim, cfg.num_classes]
        slots = [0.0] * (3 * world)
        slots[3 * mesh.rank : 3 * mesh.rank + 3] = fields
        if any(sum_over(slots)[3 * r + i] != fields[i] for r in range(world) for i in range(3)):
            raise ValueError("ensemble members on different processes disagree on num_lands, proj_unet_dim or "
                             "num_classes")

    land_names = None
    if cfg.num_lands > 0:
        land_names = get_land_names_from_dataset(args.input_data_file_path)
        if len(land_names) != cfg.num_lands:
            raise ValueError("the archive names {} landmarks, the nets {}".format(len(land_names), cfg.num_lands))

    print("initializing testing dataset")
    test_data = load_dataset(args.input_data_file_path, test_pats, no_seg=True)
    print("Length of testing dataset: {}".format(len(test_data)))

    times: list[float] = []

    def segment(f):
        with profile_trace(args.profile_dir):
            seg_dataset_ensemble(
                test_data, models, f, num_lands=cfg.num_lands, times=times, batch_size=args.batch_size,
                pad_img_dim=cfg.proj_unet_dim, num_classes=cfg.num_classes, quantized=args.int8,
                calib_batches=args.int8_calib_batches, int8_float_levels=args.int8_float_levels, mesh=mesh,
            )

    if not is_writer():
        segment(None)
        return
    print("opening destination file for writing")
    with h5py.File(args.output_data_file_path, "w") as f:
        if land_names:
            write_land_names(f, land_names)
        print("running network on projections")
        segment(f)
        print("closing file...")

    if args.times:
        write_floats_to_txt(args.times, times)


if __name__ == "__main__":
    main()
