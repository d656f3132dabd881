"""The weight bridge: numpy ``params`` and ``batch_stats`` trees of the JAX
package's flax ``UNet`` -> this port's reference-named NCHW state_dict
(JAX counterpart: ``deepfluoro_tpu/compat/torch_import.py::
_export_entries`` and ``export_torch_state_dict``, written anew here).

Layout conversions:
  Conv2d           flax (kh, kw, in, out)                  -> torch (out, in, kh, kw)
  ConvTranspose2d  flax (kh, kw, in, out), spatially flipped -> torch (in, out, kh, kw)
  BatchNorm2d      scale/bias -> weight/bias; batch_stats mean/var ->
                   running_mean/running_var; num_batches_tracked 0
The deepest ``downsample_convs`` conv, which the flax model does not have,
is zero-filled as the JAX export does.

``torch_checkpoint_from_jax`` reads a whole checkpoint the JAX package
wrote (flax msgpack: ``deepfluoro_tpu/train/checkpoint.py``, ``fit``'s and
``fit_multifold``'s fold files alike) into the reference ``.pt`` layout,
without JAX: the export direction of ``deepfluoro_tpu/compat/
torch_import.py::export_torch_checkpoint``, whose output it equals.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn

from deepfluoro_tpu_torch.models.unet import UNet, UNetConvBlock


def _entries(model: UNet):
    """(torch module name, flax path, module) for every module holding
    weights, in registration order."""

    def block(prefix, path, blk: UNetConvBlock):
        if blk.res_conv1x1 is not None:
            yield prefix + ".res_conv1x1", path + ("res_conv1x1",), blk.res_conv1x1
        n_conv = n_bn = 0
        for idx, child in enumerate(blk.block):
            if isinstance(child, nn.Conv2d):
                yield "{}.block.{}".format(prefix, idx), path + ("conv_{}".format(n_conv),), child
                n_conv += 1
            elif isinstance(child, nn.BatchNorm2d):
                yield "{}.block.{}".format(prefix, idx), path + ("bn_{}".format(n_bn),), child
                n_bn += 1

    if model.downsample_convs is not None:
        for i, conv in enumerate(model.downsample_convs):
            yield "downsample_convs.{}".format(i), ("downsample_conv_{}".format(i),), conv
    for i, blk in enumerate(model.down_path):
        yield from block("down_path.{}".format(i), ("down_{}".format(i),), blk)
    for k, up in enumerate(model.up_path):
        if isinstance(up.up, nn.ConvTranspose2d):
            yield "up_path.{}.up".format(k), ("up_{}".format(k), "up_conv"), up.up
        else:
            yield "up_path.{}.up.1".format(k), ("up_{}".format(k), "up_1x1"), up.up[1]
        yield from block("up_path.{}.conv_block".format(k), ("up_{}".format(k), "conv_block"), up.conv_block)
    yield "seg_conv", ("seg_conv",), model.seg_conv
    for d, conv in enumerate(model.lands_block):
        yield "lands_block.{}".format(d), ("lands_block_{}".format(d),), conv
    for j, conv in enumerate(model.lands_1x1):
        yield "lands_1x1.{}".format(j), ("lands_1x1_{}".format(j),), conv


def _get(tree, path):
    for p in path:
        if tree is None or p not in tree:
            return None
        tree = tree[p]
    return tree


def state_dict_from_jax(params, batch_stats, model: UNet) -> "OrderedDict[str, torch.Tensor]":
    """Convert the flax variables of a JAX ``UNet`` built with the same
    flags as ``model`` into a state_dict for ``model`` (CPU tensors, in
    ``model.state_dict()`` order). Raises KeyError when a weight of the
    model has no counterpart in ``params`` (other than the dead conv)."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True))  # noqa: E731
    sd = {}
    for name, path, mod in _entries(model):
        leaf = _get(params, path)
        if leaf is None:
            if not name.startswith("downsample_convs."):
                raise KeyError("no flax parameters at {} for {}".format("/".join(path), name))
            sd[name + ".weight"] = torch.zeros_like(mod.weight, device="cpu")
            sd[name + ".bias"] = torch.zeros_like(mod.bias, device="cpu")
        elif isinstance(mod, nn.BatchNorm2d):
            stats = _get(batch_stats, path)
            sd[name + ".weight"] = t(leaf["scale"])
            sd[name + ".bias"] = t(leaf["bias"])
            sd[name + ".running_mean"] = t(stats["mean"])
            sd[name + ".running_var"] = t(stats["var"])
            sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif isinstance(mod, nn.ConvTranspose2d):
            sd[name + ".weight"] = t(np.transpose(np.asarray(leaf["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
            sd[name + ".bias"] = t(leaf["bias"])
        else:
            sd[name + ".weight"] = t(np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))
            if mod.bias is not None:
                sd[name + ".bias"] = t(leaf["bias"])
    keys = list(model.state_dict())
    assert set(keys) == set(sd), sorted(set(keys) ^ set(sd))
    return OrderedDict((k, sd[k]) for k in keys)


def _param_sources(model: UNet, params) -> dict:
    """{torch parameter name: (flax path, layout transform)} of the
    parameters that have a counterpart in ``params`` (the dead conv has
    none)."""
    conv = lambda a: np.ascontiguousarray(np.transpose(np.asarray(a), (3, 2, 0, 1)))  # noqa: E731
    conv_t = lambda a: np.ascontiguousarray(np.transpose(np.asarray(a)[::-1, ::-1], (2, 3, 0, 1)))  # noqa: E731
    out = {}
    for name, path, mod in _entries(model):
        if _get(params, path) is None:
            continue
        if isinstance(mod, nn.BatchNorm2d):
            out[name + ".weight"] = (path + ("scale",), np.asarray)
        else:
            out[name + ".weight"] = (path + ("kernel",), conv_t if isinstance(mod, nn.ConvTranspose2d) else conv)
        if getattr(mod, "bias", None) is not None:
            out[name + ".bias"] = (path + ("bias",), np.asarray)
    return out


def _optax_moments(opt_state: dict) -> dict:
    """{torch optimizer field: params-shaped tree} of a flax state dict of
    the JAX package's optax chain (``train/step.py::make_optimizer``:
    ``inject_hyperparams`` over add_decayed_weights, trace / scale_by_adam /
    scale_by_rms, scale_by_learning_rate). flax stores the chain's tuple as
    a dict keyed '0', '1', ...; each state is told by its fields, as the
    JAX exporter tells them by type (``_export_torch_opt_state``)."""
    inner = opt_state.get("inner_state", opt_state)
    states = [inner[str(i)] for i in range(len(inner))] if isinstance(inner, dict) else []
    moments = {}
    for st in states:
        keys = set(st) if isinstance(st, dict) else set()
        if keys == {"trace"}:
            moments["momentum_buffer"] = st["trace"]
        elif keys == {"count", "mu", "nu"}:
            moments["exp_avg"], moments["exp_avg_sq"] = st["mu"], st["nu"]
            moments["step"] = int(st["count"])
        elif keys == {"nu"}:
            moments["square_avg"] = st["nu"]
    return moments


def _torch_opt_state(cfg, model: UNet, params, opt_state: dict | None, lr: float) -> dict:
    """The reference torch optimizer state dict of a flax optax state:
    each moment in its parameter's torch layout, keyed by the parameter's
    index in ``model.parameters()``, and the one param group."""
    moments = _optax_moments(opt_state) if opt_state else {}
    step = moments.pop("step", None)
    sources = _param_sources(model, params)
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, name in enumerate(names):
        if name not in sources:
            continue
        path, transform = sources[name]
        entry = {f: torch.from_numpy(np.array(transform(_get(tree, path)), copy=True)) for f, tree in moments.items()}
        if entry and cfg.optim_type in ("adam", "rmsprop"):
            # torch's Adam/RMSprop read a per-parameter 'step' (RMSprop
            # never uses it in the update)
            entry["step"] = torch.tensor(float(step if step is not None else 0))
        if entry:
            state[i] = entry
    group = {"lr": float(lr), "weight_decay": float(cfg.wgt_decay), "params": list(range(len(names)))}
    if cfg.optim_type == "sgd":
        group.update(momentum=float(cfg.momentum), dampening=0.0, nesterov=bool(cfg.nesterov))
    elif cfg.optim_type == "adam":
        group.update(betas=(0.9, 0.999), eps=1e-8, amsgrad=False)
    else:
        group.update(alpha=0.99, eps=1e-8, momentum=float(cfg.momentum), centered=False)
    return {"state": state, "param_groups": [group]}


def _torch_sched_state(cfg, sched: dict, keep_lr: bool) -> dict:
    """The torch-side scheduler state (JAX: ``_export_torch_sched_state``):
    the fields as they are, plus torch's list-valued ones. ``keep_lr``
    keeps the plateau LR, which the port's resume reads."""
    if not sched:
        return {}
    out = dict(sched)
    if cfg.lr_sched_meth == "cos":
        out["base_lrs"] = [float(out.pop("base_lr", cfg.init_lr))]
    elif cfg.lr_sched_meth == "plateau":
        out["min_lrs"] = [float(out.pop("min_lr", 0.0))]
        if not keep_lr:
            out.pop("lr", None)
        out.setdefault("mode", "min")
        out.setdefault("threshold_mode", "rel")
        out.setdefault("mode_worse", float("inf"))
        out.setdefault("eps", 1e-8)
        out.setdefault("last_epoch", 0)
    return out


# meta keys of the JAX package that its exporter leaves out of a
# reference file, and the port's own checkpoints keep
PORT_ONLY_META = ("light-best-nets", "compute-dtype", "remat", "dup-lr-flip")


def torch_checkpoint_from_jax(source, resume: bool = False) -> dict:
    """The reference ``.pt`` checkpoint dict of a JAX package checkpoint
    (``source``: a msgpack file's path, or its decoded tree), equal to what
    ``export_torch_checkpoint`` writes for it: every meta key but the
    four JAX-only ones, the reference-named state dict, the optimizer
    state (optax SGD momentum as torch's ``momentum_buffer``; Adam and
    RMSprop moments), the scheduler state with torch's fields, ``epoch``,
    ``loss`` (a tensor), ``best-valid-loss``, ``lrs-num-restarts`` and the
    split indices. The param group's LR is the one the optimizer last ran
    with (``inject_hyperparams``), else the plateau LR, else ``init-lr``.

    ``resume=True`` gives what the port's ``load_checkpoint`` returns:
    the four meta keys kept (a bf16 or remat run resumes as one), and the
    plateau LR kept in the scheduler state and set in the param group, so
    a resumed run takes the LR the JAX run reached, not the last epoch's.
    Tensors are CPU tensors owning their memory."""
    from deepfluoro_tpu_torch.compat import msgpack_lite
    from deepfluoro_tpu_torch.train.config import TrainConfig, build_model

    payload = source if isinstance(source, dict) else msgpack_lite.read(source)
    meta = dict(payload["meta"])
    cfg = TrainConfig.from_checkpoint_meta(meta)
    params = payload["model-state-dict"]["params"]
    stats = payload["model-state-dict"].get("batch_stats") or {}
    head = {}
    if cfg.num_lands > 0:
        head = dict(lands_block_depth=sum(1 for k in params if k.startswith("lands_block_")),
                    lands_num_1x1=sum(1 for k in params if k.startswith("lands_1x1_")))
    model = build_model(cfg, **head)
    sd = state_dict_from_jax(params, stats, model)

    sched = payload.get("scheduler-state-dict") or {}
    lr = cfg.init_lr
    if cfg.lr_sched_meth == "plateau" and "lr" in sched:
        lr = float(sched["lr"])
    opt_state = payload.get("optimizer-state-dict") or None
    if opt_state and not (resume and cfg.lr_sched_meth == "plateau" and "lr" in sched):
        hyper = opt_state.get("hyperparams") or {}
        if "learning_rate" in hyper:
            lr = float(hyper["learning_rate"])

    ck = cfg.to_checkpoint_meta()
    if not resume:
        for k in PORT_ONLY_META:
            ck.pop(k, None)
    bvl = payload.get("best-valid-loss")
    ck.update({
        "epoch": int(payload.get("epoch", 0)),
        "model-state-dict": dict(sd),
        "optim-type": cfg.optim_type,
        "optimizer-state-dict": _torch_opt_state(cfg, model, params, opt_state, lr),
        "scheduler-state-dict": _torch_sched_state(cfg, sched, keep_lr=resume),
        "loss": torch.tensor(float(payload.get("loss", -1.0))),
        "best-valid-loss": float("inf") if bvl is None or np.isnan(bvl) else float(bvl),
        "lrs-num-restarts": int(payload.get("lrs-num-restarts", 0)),
        "train-idx": list(payload.get("train-idx") or []),
        "valid-idx": list(payload.get("valid-idx") or []),
    })
    return ck


def _fold_slice(tree, k: int):
    if hasattr(tree, "items"):
        return {name: _fold_slice(sub, k) for name, sub in tree.items()}
    return np.asarray(tree)[k]


def fold_state_dict_from_jax(params, batch_stats, k: int, model: UNet) -> "OrderedDict[str, torch.Tensor]":
    """Fold k of a JAX multifold state, whose every leaf carries a leading
    fold axis (``make_multifold_state``; what ``fold_state(stacked, k)``
    takes out), as a state_dict for ``model``."""
    return state_dict_from_jax(_fold_slice(params, k), _fold_slice(batch_stats, k), model)
