"""The port's NCHW U-Net and weight bridge against the JAX package's flax
UNet: the bridge (deepfluoro_tpu_torch.compat.from_jax) against the JAX
package's own export (compat.torch_import.export_torch_state_dict), then
forwards on the same weights for every flag combination tests/test_unet.py
covers. float32 on both sides; atol 1e-4 covers the different summation
order of the convolutions at these depths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepfluoro_tpu.compat.torch_import import export_torch_state_dict
from deepfluoro_tpu.models import UNet as JaxUNet
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model

ATOL = 1e-4

# (flags, input size): the combinations of tests/test_unet.py, plus
# circular padding and max-pool with BatchNorm
CASES = [
    (dict(n_classes=7, depth=3, wf=3, padding=True, batch_norm=False), 32),
    (dict(n_classes=7, depth=4, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=14), 48),
    (dict(n_classes=2, depth=3, wf=2, padding=False, do_res=False), 92),
    (dict(n_classes=2, depth=3, wf=2, padding=False, do_res=True), 92),
    (dict(n_classes=3, depth=3, wf=2, padding=True, up_mode="upsample"), 32),
    (dict(n_classes=3, depth=2, wf=2, padding=True, do_soft_max=False), 16),
    (dict(n_classes=3, depth=2, wf=3, padding=True, num_lands=4, lands_block_depth=2, lands_num_1x1=2), 16),
    (dict(n_classes=3, depth=2, wf=3, padding=True, num_lands=4, lands_num_1x1=1), 16),
    (dict(n_classes=3, depth=2, wf=2, padding=True, pad_mode="circular", batch_norm=True), 16),
    (dict(n_classes=3, depth=3, wf=2, padding=True, batch_norm=True, block_depth=3, num_lands=2), 32),
]


def _jax_variables(flags, size, seed=0):
    """The flax model and numpy variables drawn from a seed: the tree comes
    from tracing init (compiling and running it costs seconds per net);
    kernels ~ N(0, 1/fan_in), biases and BN affine ~ N(0, 0.1), running
    variances in [0.5, 1.5)."""
    model = JaxUNet(**flags)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shapes.get("batch_stats", {}))
    return model, params, stats


def _port(flags, params, stats):
    model = UNet(**flags)
    model.load_state_dict(state_dict_from_jax(params, stats, model))
    return model


def _nchw(out):
    return [np.asarray(o).transpose(0, 3, 1, 2) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize(
    "cfg_kw",
    [
        dict(num_classes=7, depth=4, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14),
        dict(num_classes=3, depth=3, init_feats_exp=2, padding=True, use_res=False, block_depth=3),
    ],
)
def test_bridge_matches_jax_export(cfg_kw):
    jcfg = JaxTrainConfig(**cfg_kw)
    _, params, stats = _jax_variables(
        dict(n_classes=jcfg.num_classes, depth=jcfg.depth, wf=jcfg.init_feats_exp, padding=jcfg.padding,
             batch_norm=jcfg.batch_norm, max_pool=not jcfg.no_max_pool, num_lands=jcfg.num_lands,
             do_res=jcfg.use_res, block_depth=jcfg.block_depth), 32,
    )
    want, _ = export_torch_state_dict(jcfg, params, stats)
    model = build_model(TrainConfig(**cfg_kw))
    got = state_dict_from_jax(params, stats, model)
    assert list(got) == list(want) == list(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("flags,size", CASES)
def test_eval_forward_matches_flax(flags, size):
    jmodel, params, stats = _jax_variables(flags, size)
    x = np.random.default_rng(1).standard_normal((2, size, size, 1)).astype(np.float32)
    want = _nchw(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    model = _port(flags, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def _train_forwards(flags, size, n_forwards):
    """``n_forwards`` train-mode forwards of the flax net and the port from
    the same weights, each on its own input from a seed: the last outputs of
    both and their running statistics as port state_dicts."""
    jmodel, params, stats = _jax_variables(flags, size)
    model = _port(flags, params, stats).train()
    rng = np.random.default_rng(2)
    for _ in range(n_forwards):
        x = rng.standard_normal((2, size, size, 1)).astype(np.float32)
        jout, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True, mutable=["batch_stats"]
        )
        stats = jax.tree.map(np.asarray, mutated["batch_stats"])
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    return got, _nchw(jout), model, state_dict_from_jax(params, stats, model)


def _assert_running_stats_match(model, want, n_forwards):
    names = [name for name, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    sd = model.state_dict()
    for name in names:
        for stat in ("running_mean", "running_var"):
            key = "{}.{}".format(name, stat)
            np.testing.assert_allclose(sd[key].numpy(), want[key].numpy(), atol=1e-5, err_msg=key)
        assert int(sd[name + ".num_batches_tracked"]) == n_forwards
    return names


def test_batchnorm_train_forward_and_running_stats():
    """One train-mode forward: outputs, running means and running variances
    agree with flax, whose running variance takes the biased batch variance
    (the port corrects torch's unbiased update in UNet.forward)."""
    flags, size = CASES[1]
    got, want, model, new_jax = _train_forwards(flags, size, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL)
    names = _assert_running_stats_match(model, new_jax, 1)
    assert len(names) == 2 * (2 * flags["depth"] - 1)


@pytest.mark.parametrize("flags,size", [CASES[1], CASES[9]])
def test_batchnorm_running_stats_follow_flax_over_three_forwards(flags, size):
    """Three train-mode forwards in a row on different inputs (layers with
    different values per channel, n): the running statistics stay flax's,
    and a backward after them still runs (the correction writes buffers
    that autograd saved)."""
    got, _, model, new_jax = _train_forwards(flags, size, 3)
    _assert_running_stats_match(model, new_jax, 3)
    got[0].sum().backward()
    grad = model.down_path[0].block[0].weight.grad
    assert grad is not None and torch.isfinite(grad).all()


def test_dead_downsample_conv_is_zero_filled_and_unused():
    flags, size = CASES[1]
    _, params, stats = _jax_variables(flags, size)
    model = _port(flags, params, stats)
    dead = "downsample_convs.{}".format(flags["depth"] - 1)
    assert not model.state_dict()[dead + ".weight"].any()
    model(torch.zeros(1, 1, size, size)).__getitem__(0).sum().backward()
    assert model.get_submodule(dead).weight.grad is None
