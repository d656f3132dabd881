"""Faults planted under the timed path, to show that ``correct`` catches
them (``control.py --fault``, ``tests/test_fluorobench_cells.py``). Each
is a context manager that patches the program while it is open; a cell of
several cards plants it in each of its processes. Which faults a cell can
have, its runner's ``faults(cell)`` says; a runner may define faults of
its own in a ``FAULTS`` dict, found beside these.

- ``unchanged``: every optimizer step returns the state as it was;
- ``half_batch``: the loss is the mean over the first half of the batch,
  the rest left out;
- ``no_exchange``: the ranks of a data-parallel step skip the gradient
  all-reduce, each stepping on its own slice's gradient and loss;
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


def no_exchange():
    from deepfluoro_tpu_torch.train import step

    return _patched(step, "average_gradients", lambda orig: lambda params, loss, axis: loss)


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


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "no_exchange": no_exchange, "altered": altered}


def planted(name: str | None, runner=None):
    """The fault ``name`` (this module's, or else ``runner``'s own) as a
    context manager (None: none)."""
    if name in (None, "none"):
        return contextlib.nullcontext()
    found = {**getattr(runner, "FAULTS", {}), **FAULTS}
    if name not in found:
        raise KeyError("no fault {!r}; known: {}".format(name, ", ".join(sorted(found))))
    return found[name]()
