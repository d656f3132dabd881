"""The training loop on one device (JAX counterpart: ``deepfluoro_tpu/
train/loop.py::fit``, itself after reference train.py:104-578).

Epochs of shuffled batches, from a dataset held on the device or streamed
from host memory (``stream_data``); the plateau and cosine schedules; a
validation loss per epoch. Checkpoint kinds (train.py:517-542): the
periodic checkpoint every ``checkpoint_freq`` epochs, the best-validation
net (a copy when the checkpoint was written this epoch; a light save with
``light_best_nets``) and the pre-warm-restart snapshots
``<prefix>_RR.pt``. It stops at the epoch or restart budget, when the next
epoch would overrun ``max_hours``, or after the epoch in which SIGTERM
arrived, and always checkpoints on exit. An existing checkpoint resumes:
its metadata overrides the caller's config, and its split, weights,
BatchNorm statistics, optimizer and scheduler state, epoch, best
validation loss and restart count carry on. Saves run on a worker thread
(``AsyncCheckpointer``).

``cfg.compute_dtype`` and ``cfg.remat`` build the model (bfloat16
convolutions under autocast, per-block recompute); a resumed run keeps
the checkpoint's. Losses are computed from the float32 outputs.

With a mesh (``parallel/mesh.py``) whose 'data' axis spans several
processes, one per card, ``fit`` trains data-parallel as the JAX
package's multi-process ``fit`` does: every process holds the same
replica and takes its contiguous slice of each global batch, BatchNorm
normalizes over the global batch, the gradients and losses are averaged
over the processes, and process 0 alone writes files. With a 'spatial'
axis too and ``shard_spatial`` (JAX: ``fit(mesh=..., shard_spatial=
True)``), each frame's rows are cut into bands over 'spatial' for the
network (``train/step.py``; ``parallel/halo.py``), the 2x and 1x rungs'
layout. With a 'model' axis (JAX: ``fit`` on a mesh with 'model'), the
parameters, BatchNorm statistics and optimizer state are cut by output
channel over its processes (tensor parallelism, ``parallel/tensor.py``).
"""

from __future__ import annotations

import math
import os
import signal
import time

import numpy as np
import torch

from deepfluoro_tpu_torch.data.augment import AugmentConfig
from deepfluoro_tpu_torch.data.hdf5 import (
    FluoroData,
    LazyFluoroReader,
    archive_land_names,
    load_dataset,
    lr_flip_duplicate,
    split_indices,
    split_train_valid,
)
from deepfluoro_tpu_torch.data.pipeline import BatchIterator, PrefetchIterator
from deepfluoro_tpu_torch.ops.image import calc_pad_amount
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.multihost import is_writer
from deepfluoro_tpu_torch.parallel.tensor import gather_state, shard_channels, slice_optimizer_state, slice_state
from deepfluoro_tpu_torch.parallel.sharding import (
    agree_any,
    barrier,
    count_true,
    gather_rows,
    shard_rows,
    sync_batch_norm,
)
from deepfluoro_tpu_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.train.schedules import ReduceLROnPlateau, WarmRestartLR
from deepfluoro_tpu_torch.train.step import eval_losses, make_optimizer, set_lr, train_step
from deepfluoro_tpu_torch.utils.io import RunningFloatWriter
from deepfluoro_tpu_torch.utils.platform import get_device


def evaluate(model, cfg: TrainConfig, aug_cfg: AugmentConfig, iterator, data: Axis = Axis(), shard=None):
    """Per-image losses over a dataset -> (mean, std with N-1), as the
    reference's batch-1 no-grad loop (util.py:116-165).

    Over a data axis of several ranks each batch is split over them (an
    uneven batch padded with duplicates of its row 0, masked out after)
    and the per-image losses are gathered, so every rank gets the one
    result; they are row-local, so they equal one process's. With a
    ``shard`` the frames are row-sharded as in training."""
    losses = []
    for batch in iterator.epoch():
        n = int(batch[0].shape[0])
        pad = (-n) % data.size
        rows = data.rows(n + pad)

        def part(a):
            if a is None:
                return None
            if pad:
                a = torch.cat([a, a[:1].expand(pad, *a.shape[1:])])
            return a[rows]

        local = eval_losses(model, cfg, aug_cfg, tuple(part(a) for a in batch), shard)
        losses.append(gather_rows(local, data)[:n])
    losses = torch.cat(losses).cpu().numpy()
    std = float(losses.std(ddof=1)) if losses.size > 1 else 0.0
    return float(losses.mean()), std


def checkpoint_config(ck: dict, base: TrainConfig) -> TrainConfig:
    """The config a checkpoint resumes with: its metadata over ``base``. A
    reference train.py file stores no init-lr; its param groups' LR stands
    in (the reference's own resume restores it, train.py:355)."""
    meta = {k: v for k, v in ck.items() if not k.endswith("state-dict") and k != "loss"}
    groups = (ck.get("optimizer-state-dict") or {}).get("param_groups", [])
    if "init-lr" not in meta and groups:
        meta["init-lr"] = float(groups[0]["lr"])
    return TrainConfig.from_checkpoint_meta(meta, base=base)


def make_scheduler(cfg: TrainConfig):
    """The LR state machine train.py:331-352 builds, or None (constant LR)."""
    if cfg.optim_type != "sgd":
        assert cfg.lr_sched_meth == "none", "adam/rmsprop only support lr-sched none (train.py:343-352)"
        return None
    if cfg.lr_sched_meth == "cos":
        return WarmRestartLR(cfg.init_lr, init_run_period_epochs=cfg.lrs_num_epochs, growth_factor=cfg.lrs_growth_factor)
    if cfg.lr_sched_meth == "plateau":
        return ReduceLROnPlateau(cfg.init_lr, factor=0.1, patience=cfg.lr_patience, cooldown=cfg.lr_cooldown)
    return None


def restore_training_state(ck: dict, model, optimizer, lr_sched, log=print) -> float | None:
    """Load a checkpoint's weights, BatchNorm statistics, optimizer and
    scheduler state into a fresh model (already on its device), optimizer
    and scheduler; a None model and optimizer (a fold another process
    owns) take the scheduler state alone. A light file (no optimizer
    state) warm-starts the weights with the fresh optimizer. A reference
    scheduler state (torch's plateau state, the reference WarmRestartLR's
    attributes) maps onto the port's fields. Returns the best validation
    loss, None if none yet."""
    if model is not None:
        model.load_state_dict(ck["model-state-dict"])
        if ck.get("optimizer-state-dict"):
            optimizer.load_state_dict(ck["optimizer-state-dict"])
        else:
            log("  checkpoint stores no optimizer state; starting optimizer fresh")
    sched = dict(ck.get("scheduler-state-dict") or {})
    if lr_sched is not None and sched:
        if sched.get("base_lrs"):
            sched["base_lr"] = float(sched["base_lrs"][0])
        if sched.get("min_lrs"):
            sched["min_lr"] = float(sched["min_lrs"][0])
        groups = (ck.get("optimizer-state-dict") or {}).get("param_groups", [])
        if isinstance(lr_sched, ReduceLROnPlateau) and "lr" not in sched and groups:
            sched["lr"] = float(groups[0]["lr"])
        keys = lr_sched.state_dict().keys()
        lr_sched.load_state_dict({k: v for k, v in sched.items() if k in keys})
    bvl = float(ck.get("best-valid-loss", math.inf))
    return bvl if math.isfinite(bvl) else None


def flip_duplicate(source, d: FluoroData, log=print) -> FluoroData:
    """``lr_flip_duplicate`` of ``d`` with the landmark names of ``source``
    (an archive path); data in memory, or an archive without names, swap
    adjacent landmark pairs, which the log says."""
    names = None
    if d.lands is not None:
        names = None if isinstance(source, FluoroData) else archive_land_names(source)
        if names is None:
            log("WARNING: no landmark names; flip duplication swaps ADJACENT landmark pairs")
    return lr_flip_duplicate(d, land_names=names)


class SigtermFlag:
    """Installs a SIGTERM handler that only sets ``requested`` (printing
    from a signal handler can re-enter stdout's lock); the training loops
    stop after the current epoch and checkpoint. ``restore`` puts the
    previous handler back. Off the main thread nothing is installed."""

    def __init__(self):
        self.requested = False
        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass

    def _on_sigterm(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


def index_list(v) -> list[int]:
    return [] if v is None else [int(i) for i in np.asarray(v).reshape(-1)]


class ReaderRows:
    """The training rows of a ``LazyFluoroReader`` as a
    ``PrefetchIterator`` source: position i reads reader row ``rows[i]``;
    ``projs``, ``segs`` and ``lands`` are empty arrays that give each
    array's dtype and row shape."""

    def __init__(self, reader: LazyFluoroReader, rows):
        self.reader = reader
        self.rows = np.asarray(rows, np.int64)
        h, w = reader.orig_img_shape
        self.projs = np.empty((0, h, w), np.float32)
        self.segs = np.empty((0, h, w), np.uint8) if reader.has_segs else None
        self.lands = np.empty((0, 2, reader.num_lands), np.float32) if reader.has_lands else None

    def __len__(self) -> int:
        return len(self.rows)

    def take(self, positions):
        return self.reader.take(self.rows[positions])


def streamed_rows(path, train_pats, valid_pats, cfg: TrainConfig, train_idx, valid_idx, log=print):
    """The per-process streaming feed of data-parallel ``fit`` (JAX:
    ``loop.py:263-330``): a ``LazyFluoroReader`` over the training
    specimens, the split of its rows (restored, or ``split_indices``), the
    validation rows read into memory, and the training rows (mirrors as
    row + N) as a ``ReaderRows``. No process holds the training union.
    Returns (reader, ReaderRows, valid FluoroData, train_idx, valid_idx)."""
    reader = LazyFluoroReader(path, train_pats, dup_lr_flip=cfg.dup_lr_flip)
    if cfg.dup_lr_flip and reader.has_lands and reader.land_names is None:
        log("WARNING: no landmark names; flip duplication swaps ADJACENT landmark pairs")
    n_pool = reader.n_base
    if cfg.train_valid_split >= 0:
        if not 0.0 < cfg.train_valid_split < 1.0:
            raise ValueError("train_valid_split={} must lie strictly in (0, 1)".format(cfg.train_valid_split))
        if not (train_idx and valid_idx):
            train_idx, valid_idx = split_indices(n_pool, cfg.train_valid_split, cfg.seed)
        assert len(train_idx) + len(valid_idx) == n_pool, "restored split indices cover {} of {} pool rows".format(
            len(train_idx) + len(valid_idx), n_pool)
        vp, vs, vl = reader.take(valid_idx)
        valid_data = FluoroData(projs=vp, segs=vs, lands=vl, orig_img_shape=reader.orig_img_shape)
        rows = np.asarray(train_idx, np.int64)
    else:
        assert valid_pats is not None
        valid_data = load_dataset(path, valid_pats)
        rows = np.arange(n_pool, dtype=np.int64)
    if cfg.dup_lr_flip:
        rows = np.concatenate([rows, rows + n_pool])
    return reader, ReaderRows(reader, rows), valid_data, train_idx, valid_idx


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
    stream_data: bool = False,
    device: str | torch.device | None = None,
    mesh=None,
    shard_spatial: bool = False,
) -> dict:
    """Train a network on ``device`` (default CUDA; raises without a card
    unless ``device="cpu"``), resuming from ``checkpoint_filename`` when it
    exists.

    ``data`` is an archive path, or a ``FluoroData`` in memory whose
    ``pat_inds`` name each row's specimen. ``train_pats`` (and
    ``valid_pats`` when ``cfg.train_valid_split < 0``) select specimens.
    ``cfg.num_lands`` should already match the data. ``stream_data`` keeps
    the data in host memory and prefetches batches to the device
    (``PrefetchIterator``), with the resident feed's batch order.

    A resumed session shuffles from ``np.random.default_rng(cfg.seed + 1)``
    again, as the JAX ``fit`` does, and its loss logs are appended to.

    ``mesh`` (``parallel.make_mesh({'data': P})``, every process of the
    group calling ``fit`` in lockstep, each on its own card) trains
    data-parallel: ``cfg.batch_size`` is the global batch and must divide
    by P; each process takes its contiguous slice of the shared global
    index order and the same augmentation draws as one process, so the run
    equals one process's up to the order of sums. A final global batch
    that does not split evenly is skipped. Every process holds the
    dataset (``stream_data``: host memory), except that ``stream_data``
    with an archive path reads each process's rows from disk as it needs
    them (``LazyFluoroReader``). Every process resumes from the
    checkpoint, which all must see; process 0 alone writes checkpoints and
    loss logs; the processes agree after each epoch to stop if any of
    them got SIGTERM or ran out of ``max_hours``. The returned losses are
    the global ones on every process.

    A mesh with a 'spatial' axis of S processes too ({'data': P,
    'spatial': S}) and ``shard_spatial=True`` cuts every padded frame into
    S bands of rows (``parallel/mesh.py::row_layout``: whole blocks of
    ``2**(depth - 1)`` rows where the frame allows, uneven bands allowed,
    at least one row per band), one per process of each data slice: each
    prepares its slice's whole frames (the same augmentation, one warp
    launch per step), keeps its band, and runs the U-Net on it with row
    exchanges (padded or valid convolutions, either upsampling);
    BatchNorm spans data x spatial, the losses span the bands, the
    gradients are summed over 'spatial' and averaged over 'data'.
    Validation runs on the same bands. Without ``shard_spatial`` the
    'spatial' processes train replicas of their data slice.

    A mesh with a 'model' axis of T processes ({'data': P, 'model': T})
    trains tensor-parallel: every process of a data slice holds its
    output-channel shares of the state (``parallel/tensor.py``'s rule)
    and draws the slice's augmentation; the gradient average spans
    'data'. Checkpoints, best nets and loss files are one process's: the
    state is gathered over 'model' and process 0 writes it; a resume cuts
    it again. 'spatial' with ``shard_spatial`` and 'model' together raise
    NotImplementedError, as in the JAX package.

    Returns dict(model, optimizer, cfg, best_valid_loss, epoch,
    num_restarts, train_idx, valid_idx, train_losses, valid_losses,
    step_seconds) for this session; ``step_seconds`` holds each iteration
    of the batch loop on the host's clock: the batch gather, the train step
    up to its loss reaching the host, and the loop's bookkeeping. An
    epoch's entries sum to its batch loop; validation falls outside them,
    and the checkpointer's worker thread writes while the next epoch's
    steps run.
    """

    writer = is_writer()

    def log(msg):
        if verbose and writer:
            print(msg, flush=True)

    dev = get_device(device)
    axis = Axis() if mesh is None else mesh.axis("data")
    tp = Axis() if mesh is None else mesh.axis("model")
    if mesh is not None and set(mesh.axis_names) - {"data", "spatial", "model"}:
        raise ValueError("fit shards over 'data', 'spatial' and 'model' axes only; got mesh axes {}".format(mesh.axes))
    spatial = shard_spatial and mesh is not None and mesh.axis("spatial").size > 1
    if spatial and tp.size > 1:
        raise NotImplementedError("row sharding over 'spatial' does not compose with tensor parallelism over 'model' "
                                  "(the JAX package refuses it too): drop one axis")
    # every process of the mesh agrees on resume, stopping and writing
    world = Axis() if mesh is None else mesh.joint(*mesh.axis_names)
    prev = None
    train_idx = valid_idx = None
    resume = os.path.exists(checkpoint_filename)
    if world.size > 1:
        seen = count_true(resume, world.group)
        if seen not in (0, world.size):
            raise RuntimeError(
                "checkpoint '{}' exists on {} of {} processes; a multi-process resume needs it on storage every "
                "process sees".format(checkpoint_filename, seen, world.size)
            )
    if resume:
        log("loading state from checkpoint...")
        prev = load_checkpoint(checkpoint_filename, weights_only=False)
        cfg = checkpoint_config(prev, cfg)
        if cfg.train_valid_split >= 0:
            train_idx, valid_idx = index_list(prev.get("train-idx")), index_list(prev.get("valid-idx"))
            assert train_idx and valid_idx, "checkpoint holds no train/valid split"
    assert cfg.lr_sched_meth in ("cos", "plateau", "none")
    lrs_is_cos = cfg.lr_sched_meth == "cos"
    lrs_plateau = cfg.lr_sched_meth == "plateau"
    if cfg.batch_size % axis.size:
        raise ValueError("data-parallel training splits each global batch evenly: batch_size {} must be divisible "
                         "by the data axis {}".format(cfg.batch_size, axis.size))

    def load(pats):
        if isinstance(data, FluoroData):
            return data.select_pats(pats)
        return load_dataset(data, pats)

    def maybe_dup(d):
        # mirrors join the training side only, after any split: a mirror of
        # a validation frame in training would inflate the validation loss
        # that picks the best net and drives the plateau schedule
        return flip_duplicate(data, d, log) if cfg.dup_lr_flip else d

    reader = None
    if stream_data and axis.size > 1 and not isinstance(data, FluoroData):
        log("initializing training dataset (per-process streaming reader)")
        reader, train_data, valid_data, train_idx, valid_idx = streamed_rows(
            data, train_pats, valid_pats, cfg, train_idx, valid_idx, log)
        orig_hw = reader.orig_img_shape
    else:
        log("initializing training dataset")
        train_data = load(train_pats)
        if cfg.train_valid_split >= 0:
            train_data, valid_data, train_idx, valid_idx = split_train_valid(
                train_data, cfg.train_valid_split, (train_idx, valid_idx), seed=cfg.seed
            )
            train_data = maybe_dup(train_data)
        else:
            assert valid_pats is not None
            train_data = maybe_dup(train_data)
            log("initializing validation dataset")
            valid_data = load(valid_pats)
        orig_hw = train_data.orig_img_shape
    log("Length of training dataset: {}".format(len(train_data)))
    log("Length of validation dataset: {}".format(len(valid_data)))
    orig_h, orig_w = orig_hw
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
    sync_batch_norm(model, axis)
    shard = None
    if spatial:
        pad = cfg.proj_unet_dim
        rows = orig_h + 2 * calc_pad_amount(pad, orig_h) if pad > orig_h else orig_h
        shard = shard_rows(model, mesh, rows)
        log("row-sharded frames: rows [{}, {}) of {} on this process".format(shard.start, shard.stop, rows))
    dims = shard_channels(model, tp)
    param_keys = [k for k, _ in model.named_parameters()]
    optimizer = make_optimizer(cfg, model.parameters())
    lr_sched = make_scheduler(cfg)

    best_valid_loss = None
    epoch = 0
    num_restarts = 0
    if prev is not None:
        if tp.size > 1:
            # a checkpoint is whole: each 'model' rank takes its shares
            prev["model-state-dict"] = slice_state(prev["model-state-dict"], dims, tp)
            if prev.get("optimizer-state-dict"):
                prev["optimizer-state-dict"] = slice_optimizer_state(prev["optimizer-state-dict"], param_keys, dims, tp)
        best_valid_loss = restore_training_state(prev, model, optimizer, lr_sched, log)
        epoch = int(prev["epoch"])
        num_restarts = int(prev.get("lrs-num-restarts", 0))
        del prev

    gen = torch.Generator(device=dev)
    # a resumed session draws an augmentation stream of its own
    gen.manual_seed(cfg.seed + 1_000_003 * epoch)
    # the JAX loop's numpy shuffle stream, so batch orders agree; with a
    # data axis each process takes its slice of every global batch
    part = None if axis.size == 1 else (axis.index, axis.size)
    if stream_data:
        train_iter = PrefetchIterator(train_data, cfg.batch_size, dev, shuffle=True, seed=cfg.seed + 1, part=part)
        valid_iter = PrefetchIterator(valid_data, cfg.batch_size, dev, shuffle=False)
    else:
        train_iter = BatchIterator(train_data, cfg.batch_size, dev, shuffle=True, rng=np.random.default_rng(cfg.seed + 1),
                                   part=part)
        valid_iter = BatchIterator(valid_data, cfg.batch_size, dev)
    train_ds_len = len(train_data)
    if axis.size > 1 and train_ds_len < cfg.batch_size:
        # every batch would be a skipped tail: an epoch of no steps
        raise ValueError("data-parallel training needs at least one full global batch per epoch: {} training "
                         "examples < batch size {}".format(train_ds_len, cfg.batch_size))
    if train_ds_len % cfg.batch_size % axis.size:
        log("the final {}-example batch of each epoch does not split over {} processes and is skipped".format(
            train_ds_len % cfg.batch_size, axis.size))

    last_loss = None
    train_losses, valid_losses, step_seconds = [], [], []
    tot_time_hours = 0.0
    epochs_this_session = 0
    # process 0 alone writes files
    checkpointer = AsyncCheckpointer() if writer else None

    def copy_net(src, dst):
        if checkpointer is not None:
            checkpointer.copy(src, dst)

    def save_net(path, light=False):
        state, opt_state = model.state_dict(), None if light else optimizer.state_dict()
        # the file holds the whole state: every 'model' rank takes part in
        # the gather, the writer writes
        state, opt_state = gather_state(state, dims, tp, opt_state, param_keys)
        if checkpointer is None:
            return
        checkpointer.save(
            path, cfg, state, opt_state,
            sched_state=None if light or lr_sched is None else lr_sched.state_dict(),
            epoch=epoch, best_valid_loss=best_valid_loss, last_loss=last_loss,
            num_restarts=num_restarts, train_idx=train_idx, valid_idx=valid_idx,
        )

    sigterm = SigtermFlag()
    train_loss_out = RunningFloatWriter(train_loss_txt, new_file=not resume) if writer else None
    valid_loss_out = RunningFloatWriter(valid_loss_txt, new_file=not resume) if writer else None
    log("Start Training...")
    completed = False
    batches = None
    try:
        keep_training = True
        while keep_training:
            epoch_start = time.time()
            log("Epoch: {:03d}".format(epoch))
            running_loss_num_iters = max(1, int(0.05 * train_ds_len))
            running_loss, running_loss_iter = 0.0, 0
            epoch_loss, num_batches, num_examples_run = 0.0, 0, 0

            t_mark = time.perf_counter()
            batches = train_iter.epoch()
            for batch in batches:
                lr = lr_sched.get_lr() if lr_sched is not None else cfg.init_lr
                loss = float(train_step(model, optimizer, cfg, aug_train, gen, batch, lr, axis, shard))
                last_loss = loss
                train_losses.append(loss)
                if train_loss_out is not None:
                    train_loss_out.write(loss)
                epoch_loss += loss
                num_batches += 1
                running_loss += loss
                running_loss_iter += 1
                if running_loss_iter == running_loss_num_iters:
                    log("    Running Avg. Loss: {:.6f}".format(running_loss / running_loss_num_iters))
                    running_loss, running_loss_iter = 0.0, 0
                num_examples_run += int(batch[0].shape[0]) * axis.size
                if lrs_is_cos and lr_sched is not None:
                    lr_sched.intra_epoch_step(num_examples_run / train_ds_len)
                now = time.perf_counter()
                step_seconds.append(now - t_mark)
                t_mark = now

            log("  Running validation")
            avg_valid_loss, std_valid_loss = evaluate(model, cfg, aug_eval, valid_iter, axis, shard)
            valid_losses.append(avg_valid_loss)
            if valid_loss_out is not None:
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
                # the saved param groups carry the LR the next epoch runs
                # at, as torch's schedulers leave them (readers of the file
                # take the plateau LR from there)
                set_lr(optimizer, lr_sched.get_lr())
            epoch += 1

            new_best_valid = best_valid_loss is None or avg_valid_loss < best_valid_loss
            if new_best_valid:
                best_valid_loss = avg_valid_loss

            saved_path = None  # a full file written this epoch, a copy source
            if epoch % cfg.checkpoint_freq == 0:
                log("  Saving checkpoint")
                save_net(checkpoint_filename)
                saved_path = checkpoint_filename
            if new_best_valid and cfg.save_best_valid:
                log("  Saving best validation (loss: {:.6f})".format(best_valid_loss))
                # a light best net is never a copy of a full file
                if saved_path is not None and not cfg.light_best_nets:
                    copy_net(saved_path, best_valid_filename)
                else:
                    save_net(best_valid_filename, light=cfg.light_best_nets)
                    if not cfg.light_best_nets:
                        saved_path = best_valid_filename
            if (lrs_is_cos and lr_sched is not None and lr_sched.just_restarted and cfg.save_restart_net_prefix
                    and num_restarts >= cfg.save_after_n_restarts):
                restart_path = "{}_{:02d}.pt".format(cfg.save_restart_net_prefix, num_restarts - 1)
                log("  Saving network before restart {} to {}".format(num_restarts, restart_path))
                if saved_path is not None and not cfg.light_best_nets:
                    copy_net(saved_path, restart_path)
                else:
                    save_net(restart_path, light=cfg.light_best_nets)
                    if not cfg.light_best_nets:
                        saved_path = restart_path

            this_epoch_hours = (time.time() - epoch_start) / 3600.0
            log("  This epoch took {:.4f} hours!".format(this_epoch_hours))
            tot_time_hours += this_epoch_hours
            epochs_this_session += 1
            avg_epoch_time_hours = tot_time_hours / epochs_this_session
            log("  Current average epoch runtime: {:.4f} hours".format(avg_epoch_time_hours))

            if sigterm.requested:
                keep_training = False
                log("  Exiting - termination requested!")
            if cfg.max_hours > 0 and tot_time_hours + avg_epoch_time_hours > cfg.max_hours:
                keep_training = False
                log("  Exiting - did not expect to be able to complete next epoch within time limit!")
            if cfg.max_num_restarts > 0:
                if num_restarts >= cfg.max_num_restarts:
                    keep_training = False
                    log("  Exiting - maximum number of restarts performed!")
            elif epoch >= cfg.max_num_epochs:
                keep_training = False
                log("  Exiting - maximum number of epochs performed!")
            # SIGTERM and the clock are per process: stop everywhere if any
            # process stops, or its peers wait for it at the next collective
            if world.size > 1 and agree_any(not keep_training, world.group) and keep_training:
                keep_training = False
                log("  Exiting - a peer process requested termination!")

            if not keep_training:
                log("    saving checkpoint before exit!")
                if saved_path is None:
                    save_net(checkpoint_filename)
                elif saved_path != checkpoint_filename:
                    copy_net(saved_path, checkpoint_filename)
        log("Training Hours: {:.4f}".format(tot_time_hours))
        completed = True
    finally:
        # on an exception, a checkpointer error must not hide it
        try:
            if checkpointer is not None:
                checkpointer.wait()
        except Exception:
            if completed:
                raise
        for out in (train_loss_out, valid_loss_out):
            if out is not None:
                out.close()
        if batches is not None:
            batches.close()  # stops a prefetch producer before its reader closes
        if reader is not None:
            reader.close()
        sigterm.restore()
    if world.size > 1:
        barrier(world.group)  # every process returns after process 0's files are written

    return {
        "model": model,
        "optimizer": optimizer,
        "cfg": cfg,
        "best_valid_loss": best_valid_loss,
        "epoch": epoch,
        "num_restarts": num_restarts,
        "train_idx": train_idx,
        "valid_idx": valid_idx,
        "train_losses": train_losses,
        "valid_losses": valid_losses,
        "step_seconds": step_seconds,
    }
