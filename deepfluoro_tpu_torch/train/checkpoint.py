"""Checkpoints in the reference train.py ``.pt`` layout (JAX counterpart:
``deepfluoro_tpu/train/checkpoint.py``; the layout is the one
``deepfluoro_tpu/compat/torch_import.py:121-145`` reads).

A checkpoint is one ``torch.save`` dict: every ``TrainConfig`` meta key at
the top level, ``model-state-dict`` (reference-named NCHW weights),
``optimizer-state-dict``, ``scheduler-state-dict``, ``epoch``, ``loss``,
``best-valid-loss``, ``lrs-num-restarts``, ``train-idx`` and ``valid-idx``
(train.py:473-515). A light save leaves the optimizer and scheduler state
empty. Writes are atomic (a temporary file, then a rename), synchronous
with ``save_checkpoint`` and on a worker thread with ``AsyncCheckpointer``.

``load_checkpoint`` also reads the JAX package's checkpoints (flax
msgpack, whatever their extension: ``fit_multifold``'s ``_specXX.pt``
files are msgpack too) into this layout, without JAX
(``compat/from_jax.py::torch_checkpoint_from_jax``), so a run the JAX
package trained resumes here and its nets load for inference.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading

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


def _clone(obj):
    """A copy of every tensor in ``obj`` on its own device (the containers
    rebuilt, other leaves shared)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _pinned(obj):
    """A pinned host copy of every CUDA tensor in ``obj``, enqueued on the
    current stream without waiting."""
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
        out.copy_(obj, non_blocking=True)
        return out
    if isinstance(obj, dict):
        return {k: _pinned(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pinned(v) for v in obj)
    return obj


def _write(path: str, meta: dict, model_sd, optimizer_sd, sched_state, epoch, best_valid_loss, last_loss,
           num_restarts, train_idx, valid_idx) -> None:
    ck = dict(meta)
    ck.update(
        {
            "epoch": int(epoch),
            "model-state-dict": _to_cpu(model_sd),
            "optimizer-state-dict": _to_cpu(optimizer_sd) if optimizer_sd is not None else {},
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
    """Write a checkpoint now. ``optimizer=None`` and ``sched_state=None``
    make a light file."""
    _write(
        path, cfg.to_checkpoint_meta(), model.state_dict(), None if optimizer is None else optimizer.state_dict(),
        sched_state, epoch, best_valid_loss, last_loss, num_restarts, train_idx, valid_idx,
    )


def copy_checkpoint(src: str, dst: str) -> None:
    """Atomic copy (the reference copies instead of re-saving when a file
    was already written this epoch, train.py:523-531)."""
    tmp = "{}.tmp".format(dst)
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


class AsyncCheckpointer:
    """Checkpoint writes on a worker thread, so the next epoch trains while
    a file serialises.

    ``save`` takes ``save_checkpoint``'s arguments. Before it returns it
    copies every tensor of the model's and the optimizer's state on their
    device, in stream order (``torch.optim.SGD`` updates parameters in
    place, so a later read would see later weights); the worker waits for
    those copies, moves them to the host and writes the file. Tasks run in
    submission order, so ``copy`` is ordered behind the save that produced
    its source. On the card the worker copies the snapshot into pinned
    host memory on a side stream, so the copy runs beside the next steps'
    kernels instead of between them. A worker error is raised at the next ``save``, ``copy`` or
    ``wait``, and every task queued before it was raised is dropped.
    ``save`` blocks while ``max_pending`` tasks wait (back-pressure on the
    snapshots held on the card)."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None
        # tasks of a generation before the last raised error never run
        self._gen = 0
        self._min_gen = 0
        self._stream = None  # the side stream of device-to-host copies

    def _worker(self):
        while True:
            gen, fn, args = self._q.get()
            try:
                if self._err is None and gen >= self._min_gen:
                    fn(*args)
            except BaseException as e:
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            # bump the generation before clearing the error: the worker
            # must not run a stale task in between
            self._gen += 1
            self._min_gen = self._gen
            err, self._err = self._err, None
            raise err

    def _submit(self, fn, *args) -> None:
        self._raise_pending()
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        self._q.put((self._gen, fn, args))

    def save(self, path: str, cfg: TrainConfig, model: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None,
             sched_state: dict | None = None, epoch: int = 0, best_valid_loss: float | None = None,
             last_loss: float | None = None, num_restarts: int = 0, train_idx=None, valid_idx=None) -> None:
        meta, sched_state = cfg.to_checkpoint_meta(), dict(sched_state or {})
        snapshot = (_clone(model.state_dict()), None if optimizer is None else _clone(optimizer.state_dict()))
        done = None
        first = next(iter(snapshot[0].values()), None)
        if first is not None and first.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(first.device))

        def write():
            model_sd, optimizer_sd = snapshot if done is None else self._to_host(snapshot, done, first.device)
            _write(path, meta, model_sd, optimizer_sd, sched_state, epoch, best_valid_loss, last_loss, num_restarts,
                   train_idx, valid_idx)

        self._submit(write)

    def _to_host(self, snapshot, done, device):
        """Copy the device snapshot into pinned host memory on a side
        stream (the copy engine, beside the next steps' kernels), once the
        snapshot's copies are done."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        with torch.cuda.device(device), torch.cuda.stream(self._stream):
            self._stream.wait_event(done)
            host = _pinned(snapshot)
        self._stream.synchronize()
        return host

    def copy(self, src: str, dst: str) -> None:
        """An atomic file copy, ordered after every pending save."""
        self._submit(copy_checkpoint, src, dst)

    def wait(self) -> None:
        self._q.join()
        self._raise_pending()


def is_torch_checkpoint(path: str) -> bool:
    """Whether ``path`` is a ``torch.save`` file, told by its content as the
    JAX package tells it (``deepfluoro_tpu/train/checkpoint.py::
    is_torch_checkpoint``): a zip archive (``PK``) or a bare pickle stream
    (the ``\\x80`` PROTO opcode). Anything else is taken for flax msgpack,
    whose top-level map of more than two entries starts 0x82-0x8f, 0xde
    or 0xdf, is neither."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic[:2] == b"PK" or magic[:1] == b"\x80"


def load_checkpoint(path: str, weights_only: bool = True) -> dict:
    """The checkpoint dict, tensors on the CPU: a ``.pt`` file as it is, a
    JAX package msgpack file converted to this layout (its compute dtype,
    remat flag and plateau LR kept, for a resume). Files the JAX package
    or the reference wrote as ``.pt`` may hold numpy scalars, which
    ``weights_only`` refuses: a resume loads them in full (load only files
    you trust)."""
    if not is_torch_checkpoint(path):
        from deepfluoro_tpu_torch.compat.from_jax import torch_checkpoint_from_jax

        return torch_checkpoint_from_jax(path, resume=True)
    return torch.load(path, map_location="cpu", weights_only=weights_only)
