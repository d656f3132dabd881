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


def test_batchnorm_train_forward_and_running_stats():
    """One train-mode forward: outputs and running means agree with flax;
    running variances keep torch's (the reference's) unbiased update, so
    (var_torch - 0.9 var_old) = n/(n-1) (var_flax - 0.9 var_old) with n the
    values per channel of that layer's batch."""
    flags, size = CASES[1]
    jmodel, params, stats = _jax_variables(flags, size)
    x = np.random.default_rng(2).standard_normal((2, size, size, 1)).astype(np.float32)
    jout, mutated = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True, mutable=["batch_stats"]
    )
    model = _port(flags, params, stats).train()
    old = {k: v.clone() for k, v in model.state_dict().items()}
    n_per_bn = {}
    hooks = [
        m.register_forward_hook(lambda mod, inp, out, name=name: n_per_bn.__setitem__(name, inp[0].numel() // inp[0].shape[1]))
        for name, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)
    ]
    got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for h in hooks:
        h.remove()
    for g, w in zip(got, _nchw(jout)):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL)

    new_jax = state_dict_from_jax(params, jax.tree.map(np.asarray, mutated["batch_stats"]), model)
    sd = model.state_dict()
    assert len(n_per_bn) == 2 * (2 * flags["depth"] - 1)
    for name, n in n_per_bn.items():
        np.testing.assert_allclose(sd[name + ".running_mean"].numpy(), new_jax[name + ".running_mean"].numpy(), atol=1e-5)
        old_var = 0.9 * old[name + ".running_var"].numpy()
        np.testing.assert_allclose(
            sd[name + ".running_var"].numpy() - old_var,
            (new_jax[name + ".running_var"].numpy() - old_var) * n / (n - 1), rtol=1e-4, atol=1e-6,
        )
        assert int(sd[name + ".num_batches_tracked"]) == 1


def test_dead_downsample_conv_is_zero_filled_and_unused():
    flags, size = CASES[1]
    _, params, stats = _jax_variables(flags, size)
    model = _port(flags, params, stats)
    dead = "downsample_convs.{}".format(flags["depth"] - 1)
    assert not model.state_dict()[dead + ".weight"].any()
    model(torch.zeros(1, 1, size, size)).__getitem__(0).sum().backward()
    assert model.get_submodule(dead).weight.grad is None
