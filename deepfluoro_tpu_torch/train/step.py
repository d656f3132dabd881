"""Train and eval steps (JAX counterpart: ``deepfluoro_tpu/train/step.py``).

A train step gathers nothing itself: it takes a device batch, prepares it
(augmentation with the CUDA warp, pad, z-norm, one-hot, heatmaps), runs
forward and backward, and steps the optimizer. The JAX package imitates
torch's SGD, Adam and RMSprop in optax (step.py:42-85); here they are
torch's own.

Row sharding (a ``RowShard``, ``parallel/mesh.py``): every band of a data
slice prepares the slice's whole frames (the augmentation draws of one
process, one warp launch per step: JAX's ``pre_aug`` constraint keeps
each sample's warp whole on one device, ``train/step.py:248-283``), then
keeps its band of rows of the network input and the crop window's rows of
the targets (``shard_prepared``). The losses sum over the bands; the
gradients are summed over 'spatial' and averaged over 'data'.

On one CUDA card ``fit`` may run its steps through a ``StepGraph``
(``offer_graph``): the whole step, augmentation draws included, captured
once as one CUDA graph and replayed, where the measured rule of
``utils/graphs.py`` says the host's launches set the pace. A replay does
the eager step's arithmetic on the same tensors.
"""

from __future__ import annotations

import logging
import math

import torch

from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.ops.losses import per_sample_dice, per_sample_joint
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.sharding import average_gradients
from deepfluoro_tpu_torch.train.config import TrainConfig
from deepfluoro_tpu_torch.utils.graphs import TIMED_RUNS, capture, graph_pays, on_stream, timed
from deepfluoro_tpu_torch.utils.profiling import count

_log = logging.getLogger(__name__)


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """The optimizer train.py:331-351 builds: SGD (optionally Nesterov),
    Adam or RMSprop, each with L2 weight decay folded into the gradient."""
    if cfg.optim_type == "sgd":
        return torch.optim.SGD(params, lr=cfg.init_lr, momentum=cfg.momentum, nesterov=cfg.nesterov, weight_decay=cfg.wgt_decay)
    if cfg.optim_type == "adam":
        return torch.optim.Adam(params, lr=cfg.init_lr, weight_decay=cfg.wgt_decay)
    if cfg.optim_type == "rmsprop":
        return torch.optim.RMSprop(params, lr=cfg.init_lr, alpha=0.99, eps=1e-8, weight_decay=cfg.wgt_decay, momentum=cfg.momentum)
    raise ValueError("unknown optimizer: {}".format(cfg.optim_type))


def per_sample_losses(cfg: TrainConfig, out, seg: torch.Tensor, heats: torch.Tensor | None, use_lands: bool,
                      shard=None, target_rows: int = 0) -> torch.Tensor:
    """Per-image losses (B,) of a model output: predictions center-cropped
    to the target resolution (train.py:414-417), then the joint or the
    dice-only loss.

    With a ``shard`` the output is this band's rows and ``seg``/``heats``
    the band's rows of the ``target_rows``-row targets (``shard_prepared``):
    the crop cuts rows in frame coordinates and the sums span the bands."""
    pred_seg, pred_heats = out if cfg.num_lands > 0 else (out, None)
    if shard is None:
        pred_seg = center_crop(pred_seg, seg.shape[-2:])
        if use_lands:
            pred_heats = center_crop(pred_heats, heats.shape[-2:])
            return per_sample_joint(pred_seg, pred_heats, seg, heats, cfg.heat_coeff)
        return per_sample_dice(pred_seg, seg, skip_bg=False)
    hw = (target_rows, seg.shape[-1])
    if use_lands:
        return per_sample_joint(shard.crop(pred_seg, hw), shard.crop(pred_heats, hw), seg, heats, cfg.heat_coeff,
                                shard.axis, hw[0] * hw[1])
    return per_sample_dice(shard.crop(pred_seg, hw), seg, skip_bg=False, axis=shard.axis)


def shard_prepared(prepared: dict, shard) -> dict:
    """``prepare_batch``'s dict of whole frames cut to this band (a
    ``RowShard``): the input's rows ``[start, stop)``, the targets' rows
    inside the center crop to their size, and their whole row count as
    ``target_rows``."""
    out = dict(prepared)
    out["proj"] = prepared["proj"][:, :, shard.start : shard.stop]
    target_rows = prepared["seg"].shape[-2]
    _, rows = shard.window(target_rows)
    for k in ("seg", "heats"):
        if prepared.get(k) is not None:
            out[k] = prepared[k][:, :, rows]
    out["target_rows"] = target_rows
    return out


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The LR every param group steps with (and a checkpoint stores)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def update_step(model, optimizer, cfg: TrainConfig, prepared: dict, lr: float, data: Axis = Axis(),
                shard=None) -> torch.Tensor:
    """Forward, backward and one optimizer step on a prepared batch
    (``prepare_batch``'s dict; with a ``shard``, ``shard_prepared``'s).
    Returns the detached scalar loss.

    Over a data axis of several ranks (each with its equal slice of the
    global batch, BatchNorm synchronized over the axis) the gradients and
    the returned loss are the means over the axis: the gradient and loss
    of the global batch. Over a 'spatial' axis too, the bands' gradients
    are summed first."""
    set_lr(optimizer, lr)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(prepared["proj"])
    loss = per_sample_losses(cfg, out, prepared["seg"], prepared.get("heats"), cfg.num_lands > 0, shard,
                             prepared.get("target_rows", 0)).mean()
    loss.backward()
    loss = average_gradients(model.parameters(), loss, data if shard is None else shard.joint)
    optimizer.step()
    return loss.detach()


def train_step(model, optimizer, cfg: TrainConfig, aug_cfg: AugmentConfig, gen, batch, lr: float,
               data: Axis = Axis(), shard=None, graph: StepGraph | None = None) -> torch.Tensor:
    """One optimizer step on a raw device batch (projs, segs, lands): with
    a data axis, this rank's slice of the global batch, whose augmentation
    draws it takes from the shared stream; with a ``shard``, this rank's
    band of the slice's frames. Returns the detached scalar loss; one
    process waits for no device work here. With a ``graph`` (``fit``'s,
    where ``offer_graph`` made one) the step runs through it: eager, or
    replayed as one CUDA graph."""
    if graph is not None:
        return graph(model, optimizer, cfg, aug_cfg, gen, batch, lr)
    return _step(model, optimizer, cfg, aug_cfg, gen, batch, lr, data, shard)


def _step(model, optimizer, cfg: TrainConfig, aug_cfg: AugmentConfig, gen, batch, lr: float, data: Axis = Axis(),
          shard=None) -> torch.Tensor:
    projs, segs, lands = batch
    b = int(projs.shape[0])
    prepared = prepare_batch(aug_cfg, gen, projs, segs, lands, draw_rows=(data.index * b, data.size * b))
    if shard is not None:
        prepared = shard_prepared(prepared, shard)
    return update_step(model, optimizer, cfg, prepared, lr, data, shard)


def offer_graph(cfg: TrainConfig, dev: torch.device, mesh=None) -> StepGraph | None:
    """The ``StepGraph`` that ``fit`` runs its steps through, or None where
    the step is not offered one, which is logged at INFO with the reason.
    Offered: a single-device float32 U-Net step on a CUDA card with torch's
    SGD and an LR that holds through each epoch (the plateau schedule or
    none). Not offered: the CPU; a mesh, whose ranks must not decide apart
    and whose gloo collectives cannot be captured (also with one rank);
    bfloat16 compute and remat, paths of their own; another optimizer, whose
    step torch does not capture as it runs eagerly; the cosine schedule,
    whose LR moves every step; and a TransUNet, Swin UNETR or SAMed, whose
    forward records spans and counters on the host that a replay would not."""
    why = None
    if dev.type != "cuda":
        why = "not on a CUDA card"
    elif mesh is not None:
        why = "on a mesh"
    elif cfg.compute_dtype != "float32" or cfg.remat:
        why = "bfloat16 compute or remat"
    elif cfg.optim_type != "sgd":
        why = "optimizer {}".format(cfg.optim_type)
    elif cfg.lr_sched_meth == "cos":
        why = "the cosine schedule moves the LR every step"
    elif cfg.arch != "unet":
        why = "a {} records its spans on the host".format(cfg.arch)
    if why is not None:
        _log.info("training step: eager (%s)", why)
        return None
    return StepGraph()


class StepGraph:
    """The training step of one ``fit`` call as one CUDA graph, where that
    pays. Its first ``TIMED_RUNS + 1`` full-batch steps run eagerly: the
    first makes SGD's momentum buffers and caches cuDNN's choices, the
    others are timed (``utils/graphs.py::timed``), the last on a CUDA card
    on the stream the capture will use. ``graph_pays`` on the least of
    their dispatch and card times decides, logged at INFO. Where it says
    eager, every step stays eager.

    Otherwise the whole step is captured on static copies of the batch
    (``capture``, by default ``utils/graphs.py::capture`` with ``gen``
    registered) right after the step that decided: the augmentation's
    draws on ``gen``, the warp, pad, z-norm, one-hot and heatmaps,
    forward, loss, backward and the optimizer step, which update the
    model's parameters, BatchNorm buffers and momentum buffers in place.
    Each step from then on copies its batch into those tensors and replays
    the graph (counter ``step_graph_replays``; ``replays`` counts them
    too). The graph holds the LR as a constant: a step at another LR runs
    eagerly on the capture's stream, as the deciding step did, and then
    captures the step again at its LR. A partial batch runs eagerly. A
    patch of the step's functions made before the capture is captured with
    it."""

    def __init__(self, capture=capture, timer=timed):
        self._capture, self._timer = capture, timer
        self.pays = None  # the decision, once made
        self.captures = 0
        self.replays = 0
        self._eager = 0  # full-batch steps run before the decision
        self._times = (math.inf, math.inf)
        self._stream = None  # the stream the capture uses, on a CUDA card
        self._static = None  # the batch's device tensors the graph reads
        self._graph = None  # (graph, loss, lr)

    def __call__(self, model, optimizer, cfg: TrainConfig, aug_cfg: AugmentConfig, gen, batch, lr: float):
        step = lambda: _step(model, optimizer, cfg, aug_cfg, gen, batch, lr)  # noqa: E731
        if int(batch[0].shape[0]) != cfg.batch_size or self.pays is False:
            return step()
        if self.pays is None:
            loss = self._decide(step, cfg, batch[0].device)
        elif self._graph[2] != lr:
            self._graph = None  # the old graph's memory goes before the new one's
            loss = on_stream(step, self._stream)
        else:
            return self._replay(model, optimizer, batch, lr)
        if self.pays:
            self._capture_at(model, optimizer, cfg, aug_cfg, gen, batch, lr)
        return loss

    def _decide(self, step, cfg, device):
        n, self._eager = self._eager, self._eager + 1
        if n == 0:
            return step()
        if n == TIMED_RUNS and device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
        count("host_syncs")
        loss, dispatch_s, device_s = self._timer(lambda: on_stream(step, self._stream))
        self._times = (min(self._times[0], dispatch_s), min(self._times[1], device_s))
        if n == TIMED_RUNS:
            self.pays = graph_pays(*self._times)
            _log.info("training step of batch %d: host dispatch %.3f ms, card %.3f ms: %s", cfg.batch_size,
                      1e3 * self._times[0], 1e3 * self._times[1], "one CUDA graph" if self.pays else "eager")
        return loss

    def _capture_at(self, model, optimizer, cfg, aug_cfg, gen, batch, lr):
        if self._static is None:
            self._static = tuple(None if a is None else a.clone() for a in batch)
        static = self._static
        graph, loss = self._capture(lambda: _step(model, optimizer, cfg, aug_cfg, gen, static, lr), self._stream, gen)
        self._graph = (graph, loss, lr)
        self.captures += 1

    def _replay(self, model, optimizer, batch, lr):
        graph, loss, _ = self._graph
        for static, a in zip(self._static, batch):
            if static is not None:
                static.copy_(a)
        # the host's state an eager step would leave (the graph holds the
        # rest)
        set_lr(optimizer, lr)
        model.train()
        graph.replay()
        self.replays += 1
        count("step_graph_replays")
        return loss.clone()


@torch.no_grad()
def eval_losses(model, cfg: TrainConfig, aug_cfg: AugmentConfig, batch, shard=None) -> torch.Tensor:
    """Per-image eval-mode losses (B,) of a raw device batch; with
    ``cfg.use_dice_valid`` the dice term only (train.py:448-449). With a
    ``shard`` every band of the frames gets their losses."""
    projs, segs, lands = batch
    prepared = prepare_batch(aug_cfg, None, projs, segs, lands)
    if shard is not None:
        prepared = shard_prepared(prepared, shard)
    model.eval()
    out = model(prepared["proj"])
    use_lands = cfg.num_lands > 0 and not cfg.use_dice_valid
    return per_sample_losses(cfg, out, prepared["seg"], prepared.get("heats"), use_lands, shard,
                             prepared.get("target_rows", 0))
