"""Faults planted under the timed path, to show that ``correct`` catches
them (``control.py --fault``, ``tests/test_fluorobench_cells.py``). Each
is a context manager that patches the program while it is open.

- ``unchanged``: every optimizer step returns the state as it was;
- ``half_batch``: the loss is the mean over the first half of the batch,
  the rest left out;
- ``altered``: one label of every frame is changed where the ensemble
  produces it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, replacement):
    orig = getattr(owner, name)
    setattr(owner, name, replacement(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged():
    return _patched(torch.optim.SGD, "step", lambda orig: lambda self, closure=None: None)


def half_batch():
    from deepfluoro_tpu_torch.train import step

    def replacement(orig):
        def per_sample_losses(*args, **kwargs):
            losses = orig(*args, **kwargs)
            return losses[: max(1, losses.shape[0] // 2)]

        return per_sample_losses

    return _patched(step, "per_sample_losses", replacement)


def altered():
    from deepfluoro_tpu_torch.infer import fullres

    def replacement(orig):
        def ensemble_forward(*args, **kwargs):
            seg, heats, labels = orig(*args, **kwargs)
            labels = labels.clone()
            h, w = labels.shape[-2:]
            labels[:, h // 2, w // 2] = (labels[:, h // 2, w // 2] + 1) % seg.shape[1]
            return seg, heats, labels

        return ensemble_forward

    return _patched(fullres, "ensemble_forward", replacement)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}


def planted(name: str | None):
    """The fault ``name`` as a context manager (None: none)."""
    return contextlib.nullcontext() if name in (None, "none") else FAULTS[name]()
