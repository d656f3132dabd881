"""Train the leave-one-specimen-out ensemble in one run, the full paper
recipe per fold (JAX counterpart: ``deepfluoro_tpu/cli/train_folds.py``),
through ``train/multifold.py::fit_multifold``:

  python -m deepfluoro_tpu_torch.cli.train_folds ipcai_2020_ds_8x.h5 \\
    --pats 1,2,3,4,5,6 --num-classes 7 --init-lr 0.1 --momentum 0.9 \\
    --unet-batch-norm --unet-no-max-pool --unet-img-dim 192 \\
    --unet-num-lvls 6 --batch-size 5 --epochs 500 --unet-init-feats-exp 5 \\
    --wgt-decay 0.0001 --data-aug --unet-padding --nesterov --use-lands \\
    --lr-sched plateau --train-valid-split 0.85 --net-prefix yy_fold

Writes, per fold (specimen XX is held out of its fold's training):
  <net-prefix>_specXX.pt          best-validation network (the ensemble
                                  member, read by cli/test_ensemble.py)
  <checkpoint-prefix>_specXX.pt   periodic checkpoint; a full set resumes

Runs on CUDA; without a card it refuses unless given ``--no-gpu``.

Fold parallelism, one process per card (``fit_multifold``'s mesh):
``--ensemble-devices E`` on one host starts E local workers, each owning
K/E folds (E must divide K). Across hosts, or under ``torchrun
--nproc-per-node E -m deepfluoro_tpu_torch.cli.train_folds ...``, every
process runs the same command, with ``--num-processes P --process-id p
--coordinator host:port`` where ``torchrun`` does not set them; the fold
axis then spans all P processes.
"""

from __future__ import annotations

import argparse

from deepfluoro_tpu_torch.data.hdf5 import get_num_lands_from_dataset
from deepfluoro_tpu_torch.parallel import make_mesh, process_count
from deepfluoro_tpu_torch.parallel.multihost import is_writer, launch
from deepfluoro_tpu_torch.train.config import TrainConfig
from deepfluoro_tpu_torch.train.multifold import fit_multifold


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train all leave-one-specimen-out folds simultaneously (full recipe).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("input_data_file_path", type=str)
    p.add_argument("--pats", help="comma list of specimen IDs; one fold per held-out specimen", type=str, required=True)
    p.add_argument("--num-classes", type=int, default=7)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--unet-img-dim", type=int, default=364)
    p.add_argument("--epochs", help="Maximum number of epochs", type=int, default=200)
    p.add_argument("--optim", help="Optimization strategy to use.", type=str, default="sgd")
    p.add_argument("--lr-sched", help="'cos' | 'plateau' | 'none' (per-fold state machines)", type=str, default="plateau")
    p.add_argument("--init-lr", type=float, default=1.0e-2)
    p.add_argument("--lr-patience", type=int, default=20)
    p.add_argument("--lr-cooldown", type=int, default=20)
    p.add_argument("--cos-anneal-epochs", type=int, default=10)
    p.add_argument("--cos-growth", type=int, default=2)
    p.add_argument("--max-num-restarts", type=int, default=-1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wgt-decay", type=float, default=0.0)
    p.add_argument("--nesterov", action="store_true")
    p.add_argument("--max-hours", type=float, default=-1.0)
    p.add_argument("--unet-num-lvls", type=int, default=5)
    p.add_argument("--unet-init-feats-exp", type=int, default=4)
    p.add_argument("--unet-batch-norm", action="store_true")
    p.add_argument("--unet-padding", action="store_true")
    p.add_argument("--unet-no-max-pool", action="store_true")
    p.add_argument("--unet-block-depth", type=int, default=2)
    p.add_argument("--unet-no-res", action="store_true")
    p.add_argument("--data-aug", action="store_true")
    p.add_argument("--use-lands", action="store_true")
    p.add_argument("--heat-coeff", type=float, default=0.5)
    p.add_argument("--dice-valid", help="Use only dice validation loss even when training with dice + heatmap loss", action="store_true")
    p.add_argument("--train-valid-split", help="Per-fold ratio of the training pool kept for training; the rest validates", type=float, default=0.85)
    p.add_argument("--checkpoint-freq", type=int, default=1)
    p.add_argument("--light-best-nets", help="best-valid nets store only arch meta + weights + BN stats, not optimizer/scheduler state; the resume checkpoints keep full state", action="store_true")
    p.add_argument("--net-prefix", help="Prefix for per-fold BEST-VALIDATION networks <prefix>_specXX.pt", type=str, default="zz_fold")
    p.add_argument("--checkpoint-prefix", help="Prefix for per-fold resume checkpoints", type=str, default="zz_fold_checkpoint")
    p.add_argument("--train-loss-prefix", help="Prefix for per-fold train loss txt files ('' disables)", type=str, default="")
    p.add_argument("--valid-loss-prefix", help="Prefix for per-fold valid loss txt files ('' disables)", type=str, default="")
    p.add_argument("--save-restart-net", help="Prefix for per-fold pre-warm-restart snapshots <prefix>_specXX_RR.pt (cos schedule)", type=str, default="")
    p.add_argument("--save-after-n-restarts", help="Only save pre-restart snapshots once this many restarts have happened", type=int, default=0)
    p.add_argument("--stream-data", help="Keep the union dataset in host memory and prefetch the lockstep batches to the device (for archives too large for device memory); default keeps the union on the device", action="store_true")
    p.add_argument("--dup-lr-flip", help="Duplicate every training sample with a left/right mirror; mirrors join after each fold's split (validation and held-out frames stay mirror-free)", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--remat", help="Rematerialize activations per U-Net block (memory for compute; equal up to float reassociation)", action="store_true")
    p.add_argument("--no-gpu", help="run on the CPU", action="store_true")
    p.add_argument("--ensemble-devices", help="shard the fold axis over this many devices (an 'ensemble' mesh axis, one process per card); 0 = single device (or, multi-process, every process)", type=int, default=0)
    p.add_argument("--num-processes", help="total process count for multi-host fold training; run one process per card with the same flags", type=int, default=0)
    p.add_argument("--process-id", help="this process's index in [0, --num-processes)", type=int, default=None)
    p.add_argument("--coordinator", help="multi-host coordinator address host:port (torch.distributed's TCP store on process 0)", type=str, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    launch(run, args, max(1, args.ensemble_devices), args.num_processes, args.process_id, args.coordinator,
           "cpu" if args.no_gpu else "cuda")


def run(args):
    """Train the folds on this process (the owner of K/E of them when
    there are several processes)."""
    world = process_count()
    mesh = None
    if world > 1:
        if args.ensemble_devices not in (0, world):
            raise SystemExit("--ensemble-devices {} must equal the process count {}: the port runs one process "
                             "per card".format(args.ensemble_devices, world))
        mesh = make_mesh({"ensemble": world})
        if is_writer():
            print("device mesh: {}".format(mesh.axes), flush=True)
    pats = [int(p) for p in args.pats.split(",")]
    assert len(pats) >= 2, "need at least two specimens for leave-one-out"
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
        max_num_epochs=args.epochs,
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
        light_best_nets=args.light_best_nets,
        save_restart_net_prefix=args.save_restart_net or None,
        save_after_n_restarts=args.save_after_n_restarts,
        seed=args.seed,
        dup_lr_flip=args.dup_lr_flip,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat,
    )
    out = fit_multifold(
        args.input_data_file_path,
        pats,
        cfg,
        checkpoint_prefix=args.checkpoint_prefix,
        best_prefix=args.net_prefix,
        train_loss_txt_prefix=args.train_loss_prefix or None,
        valid_loss_txt_prefix=args.valid_loss_prefix or None,
        stream_data=args.stream_data,
        device="cpu" if args.no_gpu else "cuda",
        mesh=mesh,
    )
    if not is_writer():
        return
    for k, p in enumerate(pats):
        print("fold {} (held-out spec {:02d}): best valid {:.6f} -> {}_spec{:02d}.pt".format(
            k, p, out["best_valid_losses"][k], args.net_prefix, p))


if __name__ == "__main__":
    main()
