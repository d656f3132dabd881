"""Sharded checkpoints of a tensor-parallel state (JAX counterpart:
``deepfluoro_tpu/train/sharded_checkpoint.py``, which writes orbax's OCDBT
format).

The single-file checkpoints (``train/checkpoint.py``) hold a whole state
that one process writes. Under tensor parallelism (``parallel/tensor.py``)
each process of the 'model' axis holds only its output-channel shares of
the state, and ``fit`` gathers them before it writes. Here instead every
'model' process writes its own shares:

* ``save_sharded_checkpoint`` is collective: every process calls it. The
  processes of the first data slice (the 'model' group of process 0; the
  writer alone without the axis) each write one shard file, the cut
  leaves' shares and, in shard 0, the whole leaves; process 0 then adds
  the metadata sidecar (the single-file payload without its tensors, plus
  the layout: the 'model' degree and the rule).
* ``load_sharded_checkpoint`` restores onto any 'model' degree: it joins
  the shards into whole tensors and cuts them by the rule for the
  caller's axis (or none: the whole state for one process), the
  optimizer state too unless only the parameters are wanted. The payload
  has ``checkpoint.load_checkpoint``'s key layout.

Atomicity (the reference's contract, train.py:474,515), as the JAX
module's: each save goes into an A/B slot (``slot0``/``slot1``), shards
first, then the sidecar, and only once the slot is whole does process 0
repoint ``CURRENT`` at it (a rename), then delete the old slot. A crash
before the pointer flips leaves the last committed slot readable; the
next save replaces a half-written slot. A directory without ``CURRENT``
is read from its top level (the JAX module's layout before its slots).
Barriers come before and after process 0's host I/O.

The shards are ``torch.save`` files, not orbax's OCDBT (which needs
tensorstore, absent on the card's machine); a JAX sharded checkpoint
reaches the port through the JAX package's single-file format.
"""

from __future__ import annotations

import os
import shutil

import torch

from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.multihost import is_writer
from deepfluoro_tpu_torch.parallel.sharding import barrier
from deepfluoro_tpu_torch.parallel.tensor import channel_dims, is_cut, slice_optimizer_state, slice_state
from deepfluoro_tpu_torch.train.checkpoint import payload

ARRAYS = "arrays"
META = "meta.pt"
CURRENT = "CURRENT"
SLOTS = ("slot0", "slot1")


def _read_current(path: str) -> str | None:
    """The committed slot's name, or None (a fresh or pre-slot layout)."""
    try:
        with open(os.path.join(path, CURRENT)) as f:
            slot = f.read().strip()
    except FileNotFoundError:
        return None
    return slot if slot in SLOTS else None


def _shard_name(t: int, size: int) -> str:
    return "shard-{:02d}-of-{:02d}.pt".format(t, size)


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_sharded_checkpoint(path: str, meta: dict, model: torch.nn.Module, optimizer=None, sched_state=None,
                            epoch: int = 0, best_valid_loss: float | None = None, last_loss: float | None = None,
                            num_restarts: int = 0, train_idx=None, valid_idx=None) -> None:
    """Write ``model``'s (and ``optimizer``'s) state as a sharded
    checkpoint directory at ``path``: every process calls it (the model
    cut by ``parallel/tensor.py::shard_channels``, or whole). ``meta`` is
    ``TrainConfig.to_checkpoint_meta()``; the other arguments as
    ``train/checkpoint.py::save_checkpoint``'s."""
    axis = getattr(model, "channel_axis", Axis())
    dims = getattr(model, "channel_rule", None) or channel_dims(model)
    size = axis.size
    path = os.path.abspath(path)
    # CURRENT changes only at a commit, so every process reads one value
    cur = _read_current(path)
    slot = SLOTS[1] if cur == SLOTS[0] else SLOTS[0]
    slot_dir = os.path.join(path, slot)
    if is_writer():
        os.makedirs(path, exist_ok=True)
        if os.path.exists(slot_dir):  # a half-written slot of a crashed save
            shutil.rmtree(slot_dir)
        os.makedirs(os.path.join(slot_dir, ARRAYS))
    barrier()

    keys = [k for k, _ in model.named_parameters()]
    opt = None if optimizer is None else optimizer.state_dict()
    if (0 in axis.ranks) if size > 1 else is_writer():
        first = axis.index == 0

        def mine(rule, t):
            return torch.is_tensor(t) and (first or (t.ndim and is_cut(rule, size)))

        shard = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()
                           if mine(dims.get(k, (None, 0)), v)}}
        if opt is not None:
            shard["optimizer"] = {i: {k: v.cpu() for k, v in e.items() if mine(dims.get(keys[int(i)], (None, 0)), v)}
                                  for i, e in opt["state"].items()}
        _atomic_save(shard, os.path.join(slot_dir, ARRAYS, _shard_name(axis.index, size)))
    if is_writer():
        ck = payload(meta, {}, {}, sched_state, epoch, best_valid_loss, last_loss, num_restarts, train_idx, valid_idx)
        ck["sharded-layout"] = {"size": size, "rule": dims, "param-keys": keys,
                                "param-groups": None if opt is None else opt["param_groups"],
                                "optimizer-keys": None if opt is None else {i: sorted(e) for i, e in opt["state"].items()}}
        _atomic_save(ck, os.path.join(slot_dir, META))
    barrier()

    if is_writer():
        tmp = os.path.join(path, CURRENT + ".tmp")
        with open(tmp, "w") as f:
            f.write(slot)
        os.replace(tmp, os.path.join(path, CURRENT))
        if cur is not None and os.path.exists(os.path.join(path, cur)):
            shutil.rmtree(os.path.join(path, cur))
        for legacy in (ARRAYS, META):
            p = os.path.join(path, legacy)
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
    barrier()


def load_sharded_checkpoint(path: str, axis: Axis = Axis(), optimizer: bool = True) -> dict:
    """The checkpoint at ``path`` (``save_sharded_checkpoint``'s, at any
    'model' degree) in ``checkpoint.load_checkpoint``'s layout, its
    tensors on the CPU and cut for ``axis`` (a 'model' axis: this rank's
    shares, for a model cut by ``shard_channels`` over it; the default:
    whole). ``optimizer=False`` restores the parameters alone
    (``optimizer-state-dict`` empty). FileNotFoundError for a slot without
    its sidecar."""
    path = os.path.abspath(path)
    cur = _read_current(path)
    root = path if cur is None else os.path.join(path, cur)
    meta_path = os.path.join(root, META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError("incomplete sharded checkpoint (no {}): {}".format(META, root))
    ck = torch.load(meta_path, map_location="cpu", weights_only=True)
    layout = ck.pop("sharded-layout")
    size, dims, keys = layout["size"], layout["rule"], layout["param-keys"]
    shards = [torch.load(os.path.join(root, ARRAYS, _shard_name(t, size)), map_location="cpu", weights_only=True)
              for t in range(size)]

    def join(rule, parts):
        if parts[0].ndim and is_cut(rule, size):
            return torch.cat(parts, dim=rule[0])
        return parts[0]

    whole = {k: join(dims.get(k, (None, 0)), [s["model"].get(k) for s in shards]) for k in shards[0]["model"]}
    ck["model-state-dict"] = slice_state(whole, dims, axis)
    ck["optimizer-state-dict"] = {}
    if optimizer and layout["param-groups"] is not None:
        state = {i: {k: join(dims.get(keys[int(i)], (None, 0)), [s["optimizer"][i].get(k) for s in shards])
                     for k in names} for i, names in layout["optimizer-keys"].items()}
        ck["optimizer-state-dict"] = slice_optimizer_state({"state": state, "param_groups": layout["param-groups"]},
                                                           keys, dims, axis)
    return ck
