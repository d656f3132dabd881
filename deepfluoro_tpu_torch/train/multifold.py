"""Leave-one-specimen-out fold training in lockstep (JAX counterpart:
``deepfluoro_tpu/train/multifold.py``).

The reference builds its 6-member ensemble from six sequential train.py
runs, one per held-out specimen (train_test_code/Readme.md:14-17). Here
the K folds train together: K ``UNet`` modules, K optimizers and K LR
schedules. Each lockstep step draws a (K, B) index grid from the folds'
index streams over ONE copy of the union of all specimens (on the device,
or in host memory with ``stream_data``), prepares the K*B frames with one
``prepare_batch`` call (one warp launch) and then runs each fold's
forward, backward and optimizer step at its own LR. The folds are not
vmapped over stacked weights: BatchNorm's in-place running statistics do
not work under ``torch.func.vmap``, and per-fold weights would make the
convolutions grouped ones.

``fit_multifold`` is ``loop.fit`` per fold: fold k's split of its pool,
plateau or cosine LR, best-validation saves, periodic checkpoints, resume
(all folds or none), pre-warm-restart snapshots, ``max_hours``, SIGTERM
and flip duplication. As in the JAX package, an epoch is
ceil(max_k n_k / B) lockstep steps, and the smaller folds' streams wrap
around and reshuffle.

With a mesh whose 'ensemble' axis spans E processes, one per card, the
fold axis is sharded as in the JAX package: process e owns folds
[e K/E, (e+1) K/E) and steps them in lockstep over the same union
batches, one ``prepare_batch`` of (K/E) B frames per step (one warp
launch), with the augmentation draws one process would make for its
rows. The host loop is the same on every process: all K index streams,
schedules and best losses, fed by the per-fold losses gathered each step
and each epoch. Each fold's files are written by its owner, the loss
logs by process 0.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.data.hdf5 import FluoroData, load_dataset, specimen_counts, split_indices
from deepfluoro_tpu_torch.data.pipeline import BatchIterator, HostToDevice, PrefetchIterator, prefetch_sequence
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.multihost import is_writer
from deepfluoro_tpu_torch.parallel.sharding import agree_any, barrier, gather_folds, sum_over
from deepfluoro_tpu_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.train.loop import (
    SigtermFlag,
    checkpoint_config,
    evaluate,
    flip_duplicate,
    index_list,
    make_scheduler,
    restore_training_state,
)
from deepfluoro_tpu_torch.train.step import make_optimizer, set_lr, update_step
from deepfluoro_tpu_torch.utils.io import RunningFloatWriter
from deepfluoro_tpu_torch.utils.platform import get_device


class _FoldStream:
    """Endless shuffled stream over a fold's training indices; it
    reshuffles when exhausted, so lockstep epochs can draw full batches
    past the fold's own dataset boundary."""

    def __init__(self, indices, seed: int):
        self._indices = np.asarray(indices, np.int32)
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(self._indices)
        self._pos = 0

    def take(self, n: int) -> np.ndarray:
        out = []
        while n > 0:
            avail = len(self._perm) - self._pos
            if avail == 0:
                self._perm = self._rng.permutation(self._indices)
                self._pos = 0
                avail = len(self._perm)
            grab = min(n, avail)
            out.append(self._perm[self._pos : self._pos + grab])
            self._pos += grab
            n -= grab
        return np.concatenate(out)


def _split_pool(pool: np.ndarray, split: float, seed: int):
    """A fold's train/valid split of its index pool, by the split core that
    ``fit`` uses (``split_indices``)."""
    t, v = split_indices(len(pool), split, seed)
    return pool[t], pool[v]


def save_fold_checkpoints(cfg: TrainConfig, models, paths, epoch: int = 0, last_losses=None, train_idx=None,
                          valid_idx=None) -> None:
    """Write each fold's weights as a standard checkpoint (no optimizer
    state) that ``fit_multifold`` resumes and ``load_net_from_checkpoint``
    loads."""
    for k, path in enumerate(paths):
        save_checkpoint(
            path, cfg, models[k], epoch=epoch, last_loss=None if last_losses is None else float(last_losses[k]),
            train_idx=None if train_idx is None else train_idx[k], valid_idx=None if valid_idx is None else valid_idx[k],
        )


def multifold_step(models, optimizers, cfg: TrainConfig, aug_cfg: AugmentConfig, gen, batch, lrs,
                   draw_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """One lockstep step: ``batch`` = (projs, segs, lands) of K*B frames,
    fold-major; one ``prepare_batch`` over all of them (one warp launch),
    then fold k's update on its B frames at ``lrs[k]``. Returns the (K,)
    losses, detached, on the device. ``draw_rows`` as ``prepare_batch``'s:
    these folds' rows of a larger lockstep step."""
    projs, segs, lands = batch
    prepared = prepare_batch(aug_cfg, gen, projs, segs, lands, draw_rows=draw_rows)
    b = projs.shape[0] // len(models)
    return torch.stack([
        update_step(model, opt, cfg, {key: v[k * b : (k + 1) * b] for key, v in prepared.items()}, lr)
        for k, (model, opt, lr) in enumerate(zip(models, optimizers, lrs))
    ])


def _build_models(cfg: TrainConfig, k_folds: int, dev, keep=None):
    # K differently initialised nets from one seeded stream, of which the
    # folds ``keep`` (default all) go to the device; the caller's global
    # RNG state is left as it was
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        models = [build_model(cfg) for _ in range(k_folds)]
    return [models[k].to(dev) for k in (range(k_folds) if keep is None else keep)]


class _ResidentGather:
    """(K, B) union rows -> device batch, gathered from the union held on
    the device."""

    def __init__(self, union: FluoroData, dev):
        put = lambda a: None if a is None else torch.as_tensor(a).to(dev)  # noqa: E731
        self.arrays = (put(union.projs), put(union.segs), put(union.lands))
        self.dev = dev

    def __call__(self, idx: np.ndarray):
        rows = torch.as_tensor(idx.reshape(-1)).to(self.dev)
        return tuple(None if a is None else a.index_select(0, rows) for a in self.arrays)


def fit_multifold(
    data: str | os.PathLike | FluoroData,
    pats,
    cfg: TrainConfig,
    checkpoint_prefix: str = "zz_fold_checkpoint",
    best_prefix: str = "zz_fold_best",
    train_loss_txt_prefix: str | None = None,
    valid_loss_txt_prefix: str | None = None,
    stream_data: bool = False,
    verbose: bool = True,
    device: str | torch.device | None = None,
    mesh=None,
) -> dict:
    """Train the K = len(pats) leave-one-specimen-out folds in lockstep on
    ``device`` (default CUDA; raises without a card unless
    ``device="cpu"``). Fold k holds out pats[k] and splits the rest by
    ``cfg.train_valid_split`` with seed ``cfg.seed + k``; its stream's seed
    is ``cfg.seed + 101 * (k + 1)``. Mirrors (``cfg.dup_lr_flip``) join
    each fold's training indices after its split, as row + N of the union.

    Writes, per fold: ``<checkpoint_prefix>_specXX.pt`` (periodic and on
    exit), ``<best_prefix>_specXX.pt`` (best validation) and, under the
    cosine schedule, ``<cfg.save_restart_net_prefix>_specXX_RR.pt``; with
    the prefixes given, loss logs ``<prefix>_specXX.txt``. All fold
    checkpoints present resume every fold; some of them raise.

    ``data`` is an archive path or a ``FluoroData`` with ``pat_inds``.
    Returns dict(models, optimizers, folds, cfg, epoch, num_restarts,
    best_valid_losses (K,), fold_pats, train_idx, valid_idx, train_losses
    (one (K,) array per step), valid_losses (one (K,) array per epoch),
    step_seconds) for this session; ``models`` and ``optimizers`` are
    those of the folds ``folds`` (all K without a mesh).

    ``mesh`` (``parallel.make_mesh({'ensemble': E})``, every process
    calling in lockstep, each on its own card) shards the folds as the
    module says; E must divide K. Every process must see every fold
    checkpoint to resume.
    """
    writer = is_writer()

    def log(msg):
        if verbose and writer:
            print(msg, flush=True)

    dev = get_device(device)
    k_folds = len(pats)
    assert k_folds >= 2, "need at least two specimens for leave-one-out"
    ens = Axis() if mesh is None else mesh.axis("ensemble")
    if mesh is not None and set(mesh.axis_names) - {"ensemble"}:
        raise ValueError("fit_multifold shards over an 'ensemble' axis only; got mesh axes {}".format(mesh.axes))
    if k_folds % ens.size:
        raise ValueError("{} folds do not shard evenly over the {}-way 'ensemble' mesh axis".format(k_folds, ens.size))
    own = list(range(k_folds))[ens.rows(k_folds)]
    local = {k: i for i, k in enumerate(own)}
    ck_paths = ["{}_spec{:02d}.pt".format(checkpoint_prefix, p) for p in pats]
    best_paths = ["{}_spec{:02d}.pt".format(best_prefix, p) for p in pats]

    have_ck = [os.path.exists(p) for p in ck_paths]
    if ens.size > 1:
        seen = sum_over(have_ck, ens.group)
        if any(c not in (0, ens.size) for c in seen):
            raise RuntimeError("fold checkpoints visible on some processes but not others; a multi-process resume "
                               "needs them on storage every process sees (processes seeing each: {})".format(seen))
    resume = all(have_ck)
    if any(have_ck) and not resume:
        raise RuntimeError(
            "partial fold-checkpoint set: {} exist, {} missing; refusing a mixed resume".format(
                [p for p, h in zip(ck_paths, have_ck) if h], [p for p, h in zip(ck_paths, have_ck) if not h]
            )
        )
    prev = None
    if resume:
        log("loading state from {} fold checkpoints...".format(k_folds))
        prev = [load_checkpoint(p, weights_only=False) for p in ck_paths]
        cfg = checkpoint_config(prev[0], cfg)
        epochs = {int(ck["epoch"]) for ck in prev}
        assert len(epochs) == 1, "fold checkpoints disagree on epoch: {}".format(epochs)
    assert 0.0 < cfg.train_valid_split < 1.0, (
        "fit_multifold validates on a per-fold split of the training pool (the held-out specimen is the test "
        "set); set cfg.train_valid_split"
    )
    assert cfg.lr_sched_meth in ("cos", "plateau", "none")
    lrs_is_cos = cfg.lr_sched_meth == "cos"

    # ----- one union of all specimens
    log("initializing union dataset ({} specimens)".format(k_folds))
    if isinstance(data, FluoroData):
        union = data.select_pats(pats)
        counts = [int(np.sum(data.pat_inds == p)) for p in pats]
    else:
        union = load_dataset(data, pats)
        counts = specimen_counts(data, pats)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_orig = int(offsets[-1])
    if cfg.dup_lr_flip:
        union = flip_duplicate(data, union, log)

    train_idx, valid_idx = [], []
    for k in range(k_folds):
        pool = np.concatenate([np.arange(offsets[j], offsets[j + 1]) for j in range(k_folds) if j != k])
        if resume:
            # stored training indices already hold the mirror rows
            t = np.asarray(index_list(prev[k].get("train-idx")), np.int64)
            v = np.asarray(index_list(prev[k].get("valid-idx")), np.int64)
            assert len(t) and len(v)
            allowed = {int(i) for i in pool}
            if cfg.dup_lr_flip:
                allowed |= {i + n_orig for i in allowed}
            assert {int(i) for i in t} | {int(i) for i in v} <= allowed, (
                "fold {}: checkpoint train/valid indices fall outside this fold's specimen pool; was the run "
                "resumed with a different specimen order than it was started with?".format(k)
            )
        else:
            t, v = _split_pool(pool, cfg.train_valid_split, cfg.seed + k)
            if cfg.dup_lr_flip:
                t = np.concatenate([t, t + n_orig])
        train_idx.append(t)
        valid_idx.append(v)
        log("fold {} (held-out spec {:02d}): {} train / {} valid".format(k, pats[k], len(t), len(v)))

    aug_train = AugmentConfig(
        num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.5 if cfg.data_aug else 0.0
    )
    aug_eval = AugmentConfig(
        num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.0,
        include_heat_map=not cfg.use_dice_valid,
    )

    log("creating {} fold networks".format(k_folds))
    models = _build_models(cfg, k_folds, dev, own)
    optimizers = [make_optimizer(cfg, m.parameters()) for m in models]
    scheds = [make_scheduler(cfg) for _ in range(k_folds)]
    epoch = 0
    num_restarts = 0
    best_valid = [None] * k_folds
    if resume:
        for k in range(k_folds):
            i = local.get(k)
            best_valid[k] = restore_training_state(prev[k], None if i is None else models[i],
                                                   None if i is None else optimizers[i], scheds[k], log)
        epoch = int(prev[0]["epoch"])
        num_restarts = int(prev[0].get("lrs-num-restarts", 0))
        del prev

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1_000_003 * epoch)
    streams = [_FoldStream(train_idx[k], cfg.seed + 101 * (k + 1)) for k in range(k_folds)]
    steps_per_epoch = -(-max(len(t) for t in train_idx) // cfg.batch_size)
    if stream_data:
        feed = HostToDevice((union.projs, union.segs, union.lands), len(own) * cfg.batch_size, dev)
        valid_iters = [PrefetchIterator(union.subset(valid_idx[k]), cfg.batch_size, dev, shuffle=False) for k in own]
    else:
        gather = _ResidentGather(union, dev)
        valid_iters = [BatchIterator(union.subset(valid_idx[k]), cfg.batch_size, dev) for k in own]
    draw_rows = (own[0] * cfg.batch_size, k_folds * cfg.batch_size)

    def draw(_):
        # every fold's stream moves on every process; this one's rows are kept
        return np.stack([st.take(cfg.batch_size) for st in streams])[own]

    def writer_set(prefix):
        if prefix is None or not writer:
            return None
        return [RunningFloatWriter("{}_spec{:02d}.txt".format(prefix, p), new_file=not resume) for p in pats]

    checkpointer = AsyncCheckpointer()
    last_losses = [None] * k_folds

    def save_fold(k, path, light=False):
        checkpointer.save(
            path, cfg, models[local[k]], None if light else optimizers[local[k]],
            sched_state=None if light or scheds[k] is None else scheds[k].state_dict(),
            epoch=epoch, best_valid_loss=best_valid[k], last_loss=last_losses[k], num_restarts=num_restarts,
            train_idx=train_idx[k], valid_idx=valid_idx[k],
        )

    sigterm = SigtermFlag()
    train_losses, valid_losses, step_seconds = [], [], []
    tot_time_hours = 0.0
    epochs_this_session = 0
    train_loss_out = writer_set(train_loss_txt_prefix)
    valid_loss_out = writer_set(valid_loss_txt_prefix)
    log("Start Training ({} folds in lockstep)...".format(k_folds))
    completed = False
    try:
        keep_training = True
        while keep_training:
            epoch_start = time.time()
            log("Epoch: {:03d}".format(epoch))
            epoch_loss_sum = np.zeros((k_folds,), np.float64)
            batches = None
            if stream_data:
                batches = prefetch_sequence(lambda s: feed.put(draw(s).reshape(-1)), steps_per_epoch)
            t_mark = time.perf_counter()
            for s in range(steps_per_epoch):
                lrs = [cfg.init_lr if sc is None else sc.get_lr() for sc in scheds]
                batch = feed.ready(next(batches)) if stream_data else gather(draw(s))
                vals = multifold_step(models, optimizers, cfg, aug_train, gen, batch, [lrs[k] for k in own],
                                      draw_rows).cpu().numpy()
                vals = np.array(gather_folds(vals, ens, k_folds), np.float32)
                train_losses.append(vals)
                last_losses = [float(x) for x in vals]
                epoch_loss_sum += vals
                if train_loss_out is not None:
                    for k in range(k_folds):
                        train_loss_out[k].write(vals[k])
                if lrs_is_cos:
                    for sc in scheds:
                        if sc is not None:
                            sc.intra_epoch_step((s + 1) / steps_per_epoch)
                now = time.perf_counter()
                step_seconds.append(now - t_mark)
                t_mark = now
            if batches is not None:
                batches.close()

            log("  Running validation")
            own_stats = [evaluate(models[i], cfg, aug_eval, valid_iters[i]) for i in range(len(own))]
            stats = list(zip(gather_folds([m for m, _ in own_stats], ens, k_folds),
                             gather_folds([sd for _, sd in own_stats], ens, k_folds)))
            avg_valid = np.array([m for m, _ in stats])
            valid_losses.append(avg_valid)
            if valid_loss_out is not None:
                for k in range(k_folds):
                    valid_loss_out[k].write(avg_valid[k])
            log("  Avg. Training Losses: {}".format(np.round(epoch_loss_sum / steps_per_epoch, 6)))
            for k, (m, sd) in enumerate(stats):
                log("  fold {} (spec {:02d}) valid: {:.6f} +/- {:.6f}".format(k, pats[k], m, sd))

            for k, sc in enumerate(scheds):
                if sc is None:
                    continue
                if cfg.lr_sched_meth == "plateau":
                    sc.step(float(avg_valid[k]))
                else:
                    sc.step()
                if k in local:
                    set_lr(optimizers[local[k]], sc.get_lr())  # what the saved param groups carry
            # cosine restarts follow the config alone, so all folds restart together
            restarted = lrs_is_cos and scheds[0] is not None and scheds[0].just_restarted
            if restarted:
                log("  Next epoch is warm restart...")
                num_restarts += 1
            epoch += 1

            new_best = []
            for k in range(k_folds):
                if best_valid[k] is None or avg_valid[k] < best_valid[k]:
                    best_valid[k] = float(avg_valid[k])
                    new_best.append(k)

            # files written this epoch, by kind: a later save of the same
            # kind copies them (reference train.py:523-531)
            full_src: dict[int, str] = {}
            light_src: dict[int, str] = {}

            def save_or_copy(k, path, light):
                src = light_src if light else full_src
                if k in src:
                    checkpointer.copy(src[k], path)
                else:
                    save_fold(k, path, light=light)
                    src[k] = path

            if epoch % cfg.checkpoint_freq == 0:
                log("  Saving fold checkpoints")
                for k in own:
                    save_fold(k, ck_paths[k])
                    full_src[k] = ck_paths[k]
            if cfg.save_best_valid and new_best:
                log("  Saving best validation for folds {} (losses {})".format(
                    new_best, [round(best_valid[k], 6) for k in new_best]))
                for k in new_best:
                    if k in local:
                        save_or_copy(k, best_paths[k], cfg.light_best_nets)
            if restarted and cfg.save_restart_net_prefix and num_restarts >= cfg.save_after_n_restarts:
                log("  Saving networks before restart {} to {}_specXX_{:02d}.pt".format(
                    num_restarts, cfg.save_restart_net_prefix, num_restarts - 1))
                for k in own:
                    path = "{}_spec{:02d}_{:02d}.pt".format(cfg.save_restart_net_prefix, pats[k], num_restarts - 1)
                    save_or_copy(k, path, cfg.light_best_nets)

            this_epoch_hours = (time.time() - epoch_start) / 3600.0
            log("  This epoch took {:.4f} hours!".format(this_epoch_hours))
            tot_time_hours += this_epoch_hours
            epochs_this_session += 1
            avg_epoch_time_hours = tot_time_hours / epochs_this_session

            if sigterm.requested:
                keep_training = False
                log("  Exiting - termination requested!")
            if cfg.max_hours > 0 and tot_time_hours + avg_epoch_time_hours > cfg.max_hours:
                keep_training = False
                log("  Exiting - did not expect to complete next epoch within time limit!")
            if cfg.max_num_restarts > 0:
                if num_restarts >= cfg.max_num_restarts:
                    keep_training = False
                    log("  Exiting - maximum number of restarts performed!")
            elif epoch >= cfg.max_num_epochs:
                keep_training = False
                log("  Exiting - maximum number of epochs performed!")
            # SIGTERM and the clock are per process: stop everywhere if any stops
            if ens.size > 1 and agree_any(not keep_training, ens.group) and keep_training:
                keep_training = False
                log("  Exiting - a peer process requested termination!")

            if not keep_training and epoch % cfg.checkpoint_freq != 0:
                log("    saving fold checkpoints before exit!")
                for k in own:
                    save_or_copy(k, ck_paths[k], light=False)
        log("Training Hours: {:.4f}".format(tot_time_hours))
        completed = True
    finally:
        try:
            checkpointer.wait()
        except Exception:
            if completed:
                raise
        for ws in (train_loss_out, valid_loss_out):
            for w in ws or ():
                w.close()
        sigterm.restore()
    if ens.size > 1:
        barrier(ens.group)  # every process returns after every fold's files are written

    return {
        "models": models,
        "optimizers": optimizers,
        "folds": own,
        "cfg": cfg,
        "epoch": epoch,
        "num_restarts": num_restarts,
        "best_valid_losses": np.array([math.nan if b is None else b for b in best_valid]),
        "fold_pats": list(pats),
        "train_idx": train_idx,
        "valid_idx": valid_idx,
        "train_losses": train_losses,
        "valid_losses": valid_losses,
        "step_seconds": step_seconds,
    }


def train_multifold(data_per_fold, cfg: TrainConfig, num_epochs: int, lr: float | None = None, seed: int = 0,
                    verbose: bool = True, device: str | torch.device | None = None):
    """Constant-LR lockstep training over explicit per-fold datasets (a
    throughput path; ``fit_multifold`` is the paper recipe). Epochs are
    min_k(n_k // B) steps; fold k's stream has seed ``seed + k``. Returns
    (models, losses_hist): the last step's (K,) losses of each epoch."""
    dev = get_device(device)
    k_folds = len(data_per_fold)
    assert k_folds >= 1
    union = FluoroData(
        projs=np.concatenate([d.projs for d in data_per_fold]),
        segs=None if data_per_fold[0].segs is None else np.concatenate([d.segs for d in data_per_fold]),
        lands=None if data_per_fold[0].lands is None else np.concatenate([d.lands for d in data_per_fold]),
        orig_img_shape=data_per_fold[0].orig_img_shape,
    )
    offsets = np.concatenate([[0], np.cumsum([len(d) for d in data_per_fold])])
    streams = [_FoldStream(np.arange(offsets[k], offsets[k + 1]), seed + k) for k in range(k_folds)]
    steps_per_epoch = min(len(d) // cfg.batch_size for d in data_per_fold)
    assert steps_per_epoch > 0, "batch size exceeds the smallest fold"

    models = _build_models(cfg, k_folds, dev)
    optimizers = [make_optimizer(cfg, m.parameters()) for m in models]
    aug = AugmentConfig(num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim,
                        prob_of_aug=0.5 if cfg.data_aug else 0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    gather = _ResidentGather(union, dev)
    lrs = [cfg.init_lr if lr is None else lr] * k_folds
    losses_hist = []
    for epoch in range(num_epochs):
        for _ in range(steps_per_epoch):
            idx = np.stack([st.take(cfg.batch_size) for st in streams])
            losses = multifold_step(models, optimizers, cfg, aug, gen, gather(idx), lrs)
        losses_hist.append(losses.cpu().numpy())
        if verbose:
            print("multifold epoch {:03d}: losses {}".format(epoch, np.round(losses_hist[-1], 4)))
    return models, losses_hist
