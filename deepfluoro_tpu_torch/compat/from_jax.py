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


def _fold_slice(tree, k: int):
    if hasattr(tree, "items"):
        return {name: _fold_slice(sub, k) for name, sub in tree.items()}
    return np.asarray(tree)[k]


def fold_state_dict_from_jax(params, batch_stats, k: int, model: UNet) -> "OrderedDict[str, torch.Tensor]":
    """Fold k of a JAX multifold state, whose every leaf carries a leading
    fold axis (``make_multifold_state``; what ``fold_state(stacked, k)``
    takes out), as a state_dict for ``model``."""
    return state_dict_from_jax(_fold_slice(params, k), _fold_slice(batch_stats, k), model)
