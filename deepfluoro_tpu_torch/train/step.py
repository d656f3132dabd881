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
"""

from __future__ import annotations

import torch

from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.ops.losses import per_sample_dice, per_sample_joint
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.sharding import average_gradients
from deepfluoro_tpu_torch.train.config import TrainConfig


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
               data: Axis = Axis(), shard=None) -> torch.Tensor:
    """One optimizer step on a raw device batch (projs, segs, lands): with
    a data axis, this rank's slice of the global batch, whose augmentation
    draws it takes from the shared stream; with a ``shard``, this rank's
    band of the slice's frames. Returns the detached scalar loss; one
    process waits for no device work here."""
    projs, segs, lands = batch
    b = int(projs.shape[0])
    prepared = prepare_batch(aug_cfg, gen, projs, segs, lands, draw_rows=(data.index * b, data.size * b))
    if shard is not None:
        prepared = shard_prepared(prepared, shard)
    return update_step(model, optimizer, cfg, prepared, lr, data, shard)


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
