"""Training CLI (JAX counterpart: ``deepfluoro_tpu/cli/train.py``), with
the flags of the IPCAI paper recipe (reference train_test_code/Readme.md:
14-17) and ``--no-gpu``:

  python -m deepfluoro_tpu_torch.cli.train ipcai_2020_ds_8x.h5 \\
    --train-pats 2,3,4,5,6 --num-classes 7 --init-lr 0.1 --momentum 0.9 \\
    --unet-batch-norm --unet-no-max-pool --unet-img-dim 192 --unet-num-lvls 6 \\
    --batch-size 5 --max-num-epochs 500 --unet-init-feats-exp 5 \\
    --wgt-decay 0.0001 --data-aug --unet-padding --nesterov \\
    --checkpoint-net yy_check_net.pt --checkpoint-freq 100 --use-lands \\
    --best-net yy_best_net.pt --lr-sched plateau --train-valid-split 0.85 \\
    --heat-coeff 0.5

An existing ``--checkpoint-net`` file resumes the run. Runs on CUDA;
without a card it refuses unless given ``--no-gpu``. The ladder's big
rungs train with ``--bf16 --remat --stream-data``. ``--profile-dir``
writes a ``torch.profiler`` trace of the run; ``--debug-nans`` turns on
autograd's anomaly mode, which raises at the backward op that first
makes a NaN.

Data parallelism, one process per card (``train/loop.py::fit``'s mesh):
``--dp-devices N`` on one host starts N local workers, card r for rank r
(``--batch-size`` is the global batch and must divide by N);
``--dp-devices 0`` takes every card. Across hosts, or under ``torchrun
--nproc-per-node N -m deepfluoro_tpu_torch.cli.train ...``, every process
runs the same command, with ``--num-processes P --process-id p
--coordinator host:port`` where ``torchrun`` does not set them; the data
axis then spans all P processes. NCCL joins them on CUDA, gloo on the
CPU.

``--spatial-devices S`` cuts every frame's rows into S bands, one per
card, for the large rungs (``fit(shard_spatial=True)``; padded or valid
convolutions, any frame of at least S rows); it composes with
``--dp-devices D`` on one {'data': D, 'spatial': S} mesh of D * S
processes (``--dp-devices 0``: every card left over). ``--tp-devices T``
cuts the convolutions' output channels over T cards (tensor
parallelism, ``parallel/tensor.py``); it composes with ``--dp-devices D``
on one {'data': D, 'model': T} mesh of D * T processes, and is refused
with ``--spatial-devices`` (the JAX package refuses that composition).
"""

from __future__ import annotations

import argparse

from deepfluoro_tpu_torch.data.hdf5 import get_num_lands_from_dataset
from deepfluoro_tpu_torch.parallel import make_mesh, process_count
from deepfluoro_tpu_torch.parallel.multihost import is_writer, launch, local_device_count
from deepfluoro_tpu_torch.train.config import TrainConfig
from deepfluoro_tpu_torch.train.loop import fit
from deepfluoro_tpu_torch.utils.profiling import enable_nan_debugging, profile_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Training.", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("input_data_file_path", help="HDF5 archive holding the preprocessed projections/segmentations")
    p.add_argument("--train-pats", help="comma-separated specimen IDs to train on", type=str, required=True)
    p.add_argument("--valid-pats", help="comma-separated specimen IDs to validate on", type=str)
    p.add_argument("--num-classes", help="number of segmentation classes (incl. background)", type=int, required=True)
    p.add_argument("--batch-size", help="minibatch size in images", type=int, default=1)
    p.add_argument("--unet-img-dim", help="reflect-pad images to this square size before the U-Net", type=int, default=364)
    p.add_argument("--checkpoint-net", help="checkpoint file", type=str, default="zz_checkpoint.pt")
    p.add_argument("--best-net", help="file for the network with the lowest validation loss", type=str, default="zz_best_valid.pt")
    p.add_argument("--checkpoint-freq", help="save the checkpoint every this many epochs", type=int, default=1)
    p.add_argument("--no-save-best-valid", help="disable writing the best-validation network", action="store_true")
    p.add_argument("--light-best-nets", help="best-valid / pre-restart files store only arch meta + weights + BN stats (inference artifacts), not optimizer/scheduler state; the periodic checkpoint keeps full state for resume", action="store_true")
    p.add_argument("--optim", help="optimizer: sgd | adam | rmsprop", type=str, default="sgd")
    p.add_argument("--lr-sched", help="LR schedule: cos | plateau | none", type=str, default="cos")
    p.add_argument("--init-lr", help="starting learning rate", type=float, default=1.0e-2)
    p.add_argument("--lr-patience", help="plateau schedule: epochs without improvement before decaying", type=int, default=20)
    p.add_argument("--lr-cooldown", help="plateau schedule: epochs to wait after a decay", type=int, default=20)
    p.add_argument("--nesterov", help="enable Nesterov momentum (SGD)", action="store_true")
    p.add_argument("--momentum", help="momentum coefficient", type=float, default=0.9)
    p.add_argument("--wgt-decay", help="L2 weight-decay coefficient", type=float, default=0)
    p.add_argument("--cos-anneal-epochs", help="cosine schedule: epochs per annealing period", type=int, default=10)
    p.add_argument("--cos-growth", help="cosine schedule: period multiplier at each restart", type=int, default=2)
    p.add_argument("--save-restart-net", help="save a snapshot right before each warm restart as <PREFIX>_XX.pt", type=str)
    p.add_argument("--save-after-n-restarts", help="only start writing pre-restart snapshots after this many restarts", type=int, default=0)
    p.add_argument("--max-num-restarts", help="stop after this many warm restarts (<= 0 disables)", type=int, default=-1)
    p.add_argument("--max-num-epochs", help="epoch budget", type=int, default=200)
    p.add_argument("--train-loss-txt", help="per-iteration training-loss log file", type=str, default="train_iter_loss.txt")
    p.add_argument("--valid-loss-txt", help="per-epoch validation-loss log file", type=str, default="valid_loss.txt")
    p.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    p.add_argument("--max-hours", help="wall-clock budget in hours; exits early if the next epoch would overrun", type=float, default=-1.0)
    p.add_argument("--unet-num-lvls", help="U-Net encoder depth (levels)", type=int, default=5)
    p.add_argument("--unet-init-feats-exp", help="log2 of the first level's feature count", type=int, default=4)
    p.add_argument("--unet-batch-norm", help="BatchNorm after each conv+ReLU", action="store_true")
    p.add_argument("--unet-padding", help="pad convolutions so feature maps keep their size", action="store_true")
    p.add_argument("--unet-no-max-pool", help="downsample with learned strided convs instead of max-pool", action="store_true")
    p.add_argument("--unet-block-depth", help="convolutions per block at each level", type=int, default=2)
    p.add_argument("--unet-no-res", help="drop the 1x1 residual shortcuts", action="store_true")
    p.add_argument("--data-aug", help="enable the stochastic augmentation", action="store_true")
    p.add_argument("--use-lands", help="add the landmark-heatmap head (count read from the archive)", action="store_true")
    p.add_argument("--heat-coeff", help="heatmap-loss weight; the dice term gets one minus this", type=float, default=0.5)
    p.add_argument("--dice-valid", help="validate with the dice term only", action="store_true")
    p.add_argument("--train-valid-split", help="fraction of the pool used for training; active in [0,1], overrides --valid-pats", type=float, default=-1.0)
    p.add_argument("--stream-data", help="keep the dataset in host memory and prefetch batches to the device (for archives too large for device memory); default keeps the dataset on the device", action="store_true")
    p.add_argument("--bf16", help="Use bfloat16 compute (float32 params)", action="store_true")
    p.add_argument("--remat", help="Rematerialize activations per U-Net block during backprop: fits large-resolution frames / bigger batches in device memory for ~1 extra forward of compute; results equal up to float reassociation", action="store_true")
    p.add_argument("--dup-lr-flip", help="duplicate every training sample with a left/right mirror (flipped projections, bilateral seg labels and landmark pairs swapped); mirrors join after the train/valid split", action="store_true")
    p.add_argument("--seed", help="random seed", type=int, default=0)
    p.add_argument("--profile-dir", help="Write a torch.profiler trace (TensorBoard-loadable) to this directory", type=str, default="")
    p.add_argument("--debug-nans", help="Fault on the first NaN-producing backward op (torch.autograd.set_detect_anomaly)", action="store_true")
    p.add_argument("--dp-devices", help="shard each batch over this many devices (data parallelism, one process per card); 0 = all devices when any parallel flag is active, 1 = off", type=int, default=1)
    p.add_argument("--spatial-devices", help="also shard image rows over this many devices (for large-resolution training); composes with --dp-devices on one 2-D mesh", type=int, default=1)
    p.add_argument("--tp-devices", help="shard conv channels over this many devices (tensor parallelism, one process per card); composes with --dp-devices, not with --spatial-devices", type=int, default=1)
    p.add_argument("--num-processes", help="total process count for multi-host training; run one process per card with the same flags", type=int, default=0)
    p.add_argument("--process-id", help="this process's index in [0, --num-processes)", type=int, default=None)
    p.add_argument("--coordinator", help="multi-host coordinator address host:port (torch.distributed's TCP store on process 0)", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag in ("spatial_devices", "tp_devices"):
        if getattr(args, flag) < 1:
            raise SystemExit("--{} must be at least 1, got {}".format(flag.replace("_", "-"), getattr(args, flag)))
    if args.tp_devices > 1 and args.spatial_devices > 1:
        raise SystemExit("--tp-devices does not compose with --spatial-devices: 'spatial' x 'model' is refused, as "
                         "the JAX package refuses it; combine either with --dp-devices")
    device = "cpu" if args.no_gpu else "cuda"
    inner = args.spatial_devices * args.tp_devices
    dp = max(1, local_device_count(device) // inner) if args.dp_devices <= 0 else args.dp_devices
    launch(run, args, dp * inner, args.num_processes, args.process_id, args.coordinator, device)


def run(args):
    """Train on this process (one rank of a data-parallel, a data x
    spatial or a data x model group when there are several processes)."""
    world = process_count()
    sp, tp = args.spatial_devices, args.tp_devices
    inner = sp * tp
    mesh = None
    if world > 1 or inner > 1:
        if world % inner:
            raise SystemExit("--spatial-devices {} x --tp-devices {} does not divide the process count {}".format(
                sp, tp, world))
        dp = world // inner
        # --dp-devices 1 (the default) stands for every process under
        # torchrun or the process flags, as before; beside --spatial-devices
        # or --tp-devices it means one data slice
        if args.dp_devices not in (0, dp) and not (args.dp_devices == 1 and (inner == 1 or dp == 1)):
            raise SystemExit("--dp-devices {} x --spatial-devices {} x --tp-devices {} must equal the process count "
                             "{}: the port runs one process per card".format(args.dp_devices, sp, tp, world))
        if sp > 1:
            mesh = make_mesh({"data": dp, "spatial": sp})
        elif tp > 1:
            mesh = make_mesh({"data": dp, "model": tp})
        else:
            mesh = make_mesh({"data": world})
        if is_writer():
            print("device mesh: {}".format(mesh.axes), flush=True)
    train_pats = [int(i) for i in args.train_pats.split(",")]
    valid_pats = None
    if args.train_valid_split < 0:
        if args.valid_pats is None:
            raise SystemExit("--valid-pats is required without --train-valid-split")
        valid_pats = [int(i) for i in args.valid_pats.split(",")]
    num_lands = 0
    if args.use_lands:
        num_lands = get_num_lands_from_dataset(args.input_data_file_path)
        print("num. lands read from file: {}".format(num_lands))
        assert num_lands > 0

    cfg = TrainConfig(
        num_classes=args.num_classes,
        batch_size=args.batch_size,
        proj_unet_dim=args.unet_img_dim,
        optim_type=args.optim,
        init_lr=args.init_lr,
        nesterov=args.nesterov,
        momentum=args.momentum,
        wgt_decay=args.wgt_decay,
        lr_sched_meth=args.lr_sched.lower(),
        lr_patience=args.lr_patience,
        lr_cooldown=args.lr_cooldown,
        lrs_num_epochs=args.cos_anneal_epochs,
        lrs_growth_factor=args.cos_growth,
        max_num_restarts=args.max_num_restarts,
        save_restart_net_prefix=args.save_restart_net,
        save_after_n_restarts=args.save_after_n_restarts,
        max_num_epochs=args.max_num_epochs,
        max_hours=args.max_hours,
        depth=args.unet_num_lvls,
        init_feats_exp=args.unet_init_feats_exp,
        batch_norm=args.unet_batch_norm,
        padding=args.unet_padding,
        no_max_pool=args.unet_no_max_pool,
        block_depth=args.unet_block_depth,
        use_res=not args.unet_no_res,
        data_aug=args.data_aug,
        num_lands=num_lands,
        heat_coeff=args.heat_coeff,
        use_dice_valid=args.dice_valid,
        train_valid_split=args.train_valid_split,
        checkpoint_freq=args.checkpoint_freq,
        save_best_valid=not args.no_save_best_valid,
        light_best_nets=args.light_best_nets,
        seed=args.seed,
        dup_lr_flip=args.dup_lr_flip,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat,
    )
    if args.debug_nans:
        enable_nan_debugging()
    with profile_trace(args.profile_dir):
        fit(
            args.input_data_file_path,
            train_pats,
            cfg,
            valid_pats=valid_pats,
            checkpoint_filename=args.checkpoint_net,
            best_valid_filename=args.best_net,
            train_loss_txt=args.train_loss_txt,
            valid_loss_txt=args.valid_loss_txt,
            stream_data=args.stream_data,
            device="cpu" if args.no_gpu else "cuda",
            mesh=mesh,
            shard_spatial=sp > 1,
        )


if __name__ == "__main__":
    main()
