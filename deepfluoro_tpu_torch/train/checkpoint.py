"""Checkpoints in the reference train.py ``.pt`` layout (JAX counterpart:
``deepfluoro_tpu/train/checkpoint.py::save_checkpoint``; the layout is the
one ``deepfluoro_tpu/compat/torch_import.py:121-145`` reads).

A checkpoint is one ``torch.save`` dict: every ``TrainConfig`` meta key at
the top level, ``model-state-dict`` (reference-named NCHW weights),
``optimizer-state-dict``, ``scheduler-state-dict``, ``epoch``, ``loss``,
``best-valid-loss``, ``lrs-num-restarts``, ``train-idx`` and ``valid-idx``
(train.py:473-515). Saves are synchronous and atomic (write a temporary
file, then rename).
"""

from __future__ import annotations

import os
import shutil

import torch

from deepfluoro_tpu_torch.train.config import TrainConfig


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(
    path: str,
    cfg: TrainConfig,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer | None = None,
    sched_state: dict | None = None,
    epoch: int = 0,
    best_valid_loss: float | None = None,
    last_loss: float | None = None,
    num_restarts: int = 0,
    train_idx=None,
    valid_idx=None,
) -> None:
    ck = dict(cfg.to_checkpoint_meta())
    ck.update(
        {
            "epoch": int(epoch),
            "model-state-dict": _to_cpu(model.state_dict()),
            "optimizer-state-dict": _to_cpu(optimizer.state_dict()) if optimizer is not None else {},
            "scheduler-state-dict": dict(sched_state or {}),
            # the reference stores the loss as a tensor (test_ensemble.py:92)
            "loss": torch.tensor(-1.0 if last_loss is None else float(last_loss)),
            "best-valid-loss": float("inf") if best_valid_loss is None else float(best_valid_loss),
            "lrs-num-restarts": int(num_restarts),
            "train-idx": [] if train_idx is None else [int(i) for i in train_idx],
            "valid-idx": [] if valid_idx is None else [int(i) for i in valid_idx],
        }
    )
    tmp = "{}.tmp".format(path)
    torch.save(ck, tmp)
    os.replace(tmp, path)


def copy_checkpoint(src: str, dst: str) -> None:
    """Atomic copy (the reference copies instead of re-saving when a file
    was already written this epoch, train.py:523-531)."""
    tmp = "{}.tmp".format(dst)
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def load_checkpoint(path: str) -> dict:
    """The raw checkpoint dict, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
