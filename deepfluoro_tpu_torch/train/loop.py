"""The training loop on one device (JAX counterpart: ``deepfluoro_tpu/
train/loop.py::fit``, itself after reference train.py:104-578).

Epochs of shuffled batches from a dataset held on the device, the plateau
and cosine schedules, a validation loss per epoch, the best-validation
save, the periodic checkpoint and a checkpoint on exit. Saves are
synchronous; the loop starts no thread or process and installs no signal
handler.

Not ported yet: resume from an existing checkpoint (refused),
``max_hours``, pre-restart snapshots, left/right flip duplication,
bfloat16 compute, rematerialization and light best nets (no option here
yet); the JAX package's streaming feed, async checkpointer, SIGTERM
handling and meshes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from deepfluoro_tpu_torch.data.augment import AugmentConfig
from deepfluoro_tpu_torch.data.hdf5 import FluoroData, load_dataset, split_train_valid
from deepfluoro_tpu_torch.data.pipeline import BatchIterator
from deepfluoro_tpu_torch.train.checkpoint import copy_checkpoint, save_checkpoint
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.train.schedules import ReduceLROnPlateau, WarmRestartLR
from deepfluoro_tpu_torch.train.step import eval_losses, make_optimizer, train_step
from deepfluoro_tpu_torch.utils.io import RunningFloatWriter
from deepfluoro_tpu_torch.utils.platform import get_device


def evaluate(model, cfg: TrainConfig, aug_cfg: AugmentConfig, iterator: BatchIterator):
    """Per-image losses over a dataset -> (mean, std with N-1), as the
    reference's batch-1 no-grad loop (util.py:116-165)."""
    losses = torch.cat([eval_losses(model, cfg, aug_cfg, batch) for batch in iterator.epoch()]).cpu().numpy()
    std = float(losses.std(ddof=1)) if losses.size > 1 else 0.0
    return float(losses.mean()), std


def fit(
    data: str | os.PathLike | FluoroData,
    train_pats,
    cfg: TrainConfig,
    valid_pats=None,
    checkpoint_filename: str = "zz_checkpoint.pt",
    best_valid_filename: str = "zz_best_valid.pt",
    train_loss_txt: str = "train_iter_loss.txt",
    valid_loss_txt: str = "valid_loss.txt",
    verbose: bool = True,
    device: str | torch.device | None = None,
) -> dict:
    """Train a network on ``device`` (default CUDA; raises without a card
    unless ``device="cpu"``).

    ``data`` is an archive path, or a ``FluoroData`` in memory whose
    ``pat_inds`` name each row's specimen. ``train_pats`` (and
    ``valid_pats`` when ``cfg.train_valid_split < 0``) select specimens.
    ``cfg.num_lands`` should already match the data.

    Returns dict(model, optimizer, cfg, best_valid_loss, epoch, train_idx,
    valid_idx, train_losses, valid_losses, step_seconds); ``step_seconds``
    holds each iteration of the batch loop on the host's clock: the batch
    gather, the train step up to its loss reaching the host, and the loop's
    bookkeeping. An epoch's entries sum to its batch loop; validation and
    checkpoints fall outside them.
    """

    def log(msg):
        if verbose:
            print(msg, flush=True)

    dev = get_device(device)
    if os.path.exists(checkpoint_filename):
        raise NotImplementedError(
            "checkpoint '{}' exists and resume is not ported to deepfluoro_tpu_torch yet; "
            "move it away or pick another checkpoint file".format(checkpoint_filename)
        )
    assert cfg.lr_sched_meth in ("cos", "plateau", "none")
    lrs_is_cos = cfg.lr_sched_meth == "cos"
    lrs_plateau = cfg.lr_sched_meth == "plateau"

    def load(pats):
        if isinstance(data, FluoroData):
            return data.select_pats(pats)
        return load_dataset(data, pats)

    log("initializing training dataset")
    train_data = load(train_pats)
    train_idx = valid_idx = None
    if cfg.train_valid_split >= 0:
        train_data, valid_data, train_idx, valid_idx = split_train_valid(train_data, cfg.train_valid_split, seed=cfg.seed)
    else:
        assert valid_pats is not None
        log("initializing validation dataset")
        valid_data = load(valid_pats)
    log("Length of training dataset: {}".format(len(train_data)))
    log("Length of validation dataset: {}".format(len(valid_data)))
    orig_h, orig_w = train_data.orig_img_shape
    assert orig_h == orig_w, "non-square projections ({}, {}) are not supported".format(orig_h, orig_w)

    aug_train = AugmentConfig(
        num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.5 if cfg.data_aug else 0.0
    )
    # dice-only validation never reads target heatmaps
    aug_eval = AugmentConfig(
        num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.0,
        include_heat_map=not cfg.use_dice_valid,
    )

    log("creating network")
    # seeded init that leaves the caller's global RNG state as it was
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg)
    model.to(dev)
    optimizer = make_optimizer(cfg, model.parameters())

    lr_sched = None
    if cfg.optim_type == "sgd":
        if lrs_is_cos:
            lr_sched = WarmRestartLR(cfg.init_lr, init_run_period_epochs=cfg.lrs_num_epochs, growth_factor=cfg.lrs_growth_factor)
        elif lrs_plateau:
            lr_sched = ReduceLROnPlateau(cfg.init_lr, factor=0.1, patience=cfg.lr_patience, cooldown=cfg.lr_cooldown)
    else:
        assert cfg.lr_sched_meth == "none", "adam/rmsprop only support lr-sched none (train.py:343-352)"

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    # the same numpy shuffle stream as the JAX loop's, so batch orders agree
    train_iter = BatchIterator(train_data, cfg.batch_size, dev, shuffle=True, rng=np.random.default_rng(cfg.seed + 1))
    valid_iter = BatchIterator(valid_data, cfg.batch_size, dev)
    train_ds_len = len(train_data)

    best_valid_loss = None
    last_loss = None
    epoch = 0
    num_restarts = 0
    train_losses, valid_losses, step_seconds = [], [], []

    def save_net(path):
        save_checkpoint(
            path, cfg, model, optimizer,
            sched_state=lr_sched.state_dict() if lr_sched is not None else None,
            epoch=epoch, best_valid_loss=best_valid_loss, last_loss=last_loss,
            num_restarts=num_restarts, train_idx=train_idx, valid_idx=valid_idx,
        )

    log("Start Training...")
    with RunningFloatWriter(train_loss_txt) as train_loss_out, RunningFloatWriter(valid_loss_txt) as valid_loss_out:
        keep_training = True
        while keep_training:
            epoch_start = time.time()
            log("Epoch: {:03d}".format(epoch))
            running_loss_num_iters = max(1, int(0.05 * train_ds_len))
            running_loss, running_loss_iter = 0.0, 0
            epoch_loss, num_batches, num_examples_run = 0.0, 0, 0

            t_mark = time.perf_counter()
            for batch in train_iter.epoch():
                lr = lr_sched.get_lr() if lr_sched is not None else cfg.init_lr
                loss = float(train_step(model, optimizer, cfg, aug_train, gen, batch, lr))
                last_loss = loss
                train_losses.append(loss)
                train_loss_out.write(loss)
                epoch_loss += loss
                num_batches += 1
                running_loss += loss
                running_loss_iter += 1
                if running_loss_iter == running_loss_num_iters:
                    log("    Running Avg. Loss: {:.6f}".format(running_loss / running_loss_num_iters))
                    running_loss, running_loss_iter = 0.0, 0
                num_examples_run += int(batch[0].shape[0])
                if lrs_is_cos and lr_sched is not None:
                    lr_sched.intra_epoch_step(num_examples_run / train_ds_len)
                now = time.perf_counter()
                step_seconds.append(now - t_mark)
                t_mark = now

            log("  Running validation")
            avg_valid_loss, std_valid_loss = evaluate(model, cfg, aug_eval, valid_iter)
            valid_losses.append(avg_valid_loss)
            valid_loss_out.write(avg_valid_loss)
            log("  Avg. Training Loss: {:.6f}".format(epoch_loss / num_batches))
            log("  Validation Loss: {:.6f} +/- {:.6f}".format(avg_valid_loss, std_valid_loss))

            if lr_sched is not None:
                if lrs_plateau:
                    lr_sched.step(avg_valid_loss)
                else:
                    lr_sched.step()
                    if lr_sched.just_restarted:
                        log("  Next epoch is warm restart...")
                        num_restarts += 1
            epoch += 1

            new_best_valid = best_valid_loss is None or avg_valid_loss < best_valid_loss
            if new_best_valid:
                best_valid_loss = avg_valid_loss

            saved_path = None
            if epoch % cfg.checkpoint_freq == 0:
                log("  Saving checkpoint")
                save_net(checkpoint_filename)
                saved_path = checkpoint_filename
            if new_best_valid and cfg.save_best_valid:
                log("  Saving best validation (loss: {:.6f})".format(best_valid_loss))
                if saved_path is not None:
                    copy_checkpoint(saved_path, best_valid_filename)
                else:
                    save_net(best_valid_filename)
                    saved_path = best_valid_filename

            log("  This epoch took {:.4f} hours!".format((time.time() - epoch_start) / 3600.0))
            if cfg.max_num_restarts > 0:
                if num_restarts >= cfg.max_num_restarts:
                    keep_training = False
                    log("  Exiting - maximum number of restarts performed!")
            elif epoch >= cfg.max_num_epochs:
                keep_training = False
                log("  Exiting - maximum number of epochs performed!")

            if not keep_training:
                log("    saving checkpoint before exit!")
                if saved_path is None:
                    save_net(checkpoint_filename)
                elif saved_path != checkpoint_filename:
                    copy_checkpoint(saved_path, checkpoint_filename)

    return {
        "model": model,
        "optimizer": optimizer,
        "cfg": cfg,
        "best_valid_loss": best_valid_loss,
        "epoch": epoch,
        "train_idx": train_idx,
        "valid_idx": valid_idx,
        "train_losses": train_losses,
        "valid_losses": valid_losses,
        "step_seconds": step_seconds,
    }
