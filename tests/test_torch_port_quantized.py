"""The port's post-training int8 inference (deepfluoro_tpu_torch.ops.
int8_conv, infer/quantized.py, the quantized options of infer/ensemble.py,
infer/fullres.py and data/preprocess.py, the --int8 flags of both
inference CLIs) and its profiling hooks (utils/profiling.py,
--profile-dir, --debug-nans) against the JAX package's, on the CPU.

Nets are the JAX tests' CONFIGS (tests/test_quantized.py: paper, upsample,
circular, VALID), depth <= 3, wf 2, frames <= 48^2. Weights are drawn from
a numpy seed for the flax net and carried to the port by compat.from_jax
(or exported as a .pt for the CLIs); inputs come from numpy.random.
default_rng. The int8 convolutions are exact on both sides, so the port and
JAX part only where a float op rounds otherwise before a quantization
point and moves one activation across a rounding boundary. Tolerances
(measured in brackets): float replay within 1e-5 of the module and of
JAX (1.4e-6); int8 forwards of the same int8 weights and scales: seg
within 1e-3 (2.4e-7) and heats within 1e-3 of their largest value
(2.4e-7), >= 99.9 % equal labels; the CLIs, each with its own
calibration, as ``_assert_cli_close`` states; weights bit-equal, weight
scales within 1 ulp, activation scales within 1e-6 relative (4.1e-7);
bf16 members within bf16's 2e-2 (ROADMAP §3's accepted divergence)."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluoro_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from deepfluoro_tpu.data.augment import prepare_batch as jax_prepare_batch
from deepfluoro_tpu.data.preprocess import make_quantized_fullres_infer as jax_quantized_fullres
from deepfluoro_tpu.infer import quantized as jq
from deepfluoro_tpu.models.unet import UNet as JaxUNet
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import (
    make_synthetic_data,
    make_synthetic_fullres_data,
    write_synthetic_dataset,
    write_synthetic_fullres_dataset,
)
from deepfluoro_tpu_torch.data.hdf5 import load_dataset
from deepfluoro_tpu_torch.data.preprocess import make_quantized_fullres_infer
from deepfluoro_tpu_torch.infer import ensemble_batches
from deepfluoro_tpu_torch.infer import quantized as tq
from deepfluoro_tpu_torch.infer import test_dataset_ensemble as port_ensemble_eval
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.ops import int8_conv
from deepfluoro_tpu_torch.utils import profiling
from test_quantized import CONFIGS, _selector_kernel
from test_torch_port_fullres import CALLERS, as_caller, cudnn_flags, inside_scope
from test_torch_port_infer import _export, _jax_members

IDS = ["paper", "upsample", "circ", "valid"]
SEG_ATOL = 1e-3
HEAT_REL = 1e-3
LABEL_AGREE = 0.999
CFG = dict(num_classes=7, depth=3, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dim(kw):
    return 32 if kw.get("padding", False) else 48


def _pair(kw, seed=0, dtype="float32"):
    """A flax UNet of ``kw`` with numpy-drawn variables (kernels ~ N(0,
    1/fan_in), biases and BatchNorm affine ~ N(0, 0.1) about 0 and 1,
    running variances in [0.5, 1.5)) and the port's UNet holding them, in
    eval mode; both at ``dtype``."""
    jmodel = JaxUNet(**kw, dtype=getattr(jnp, dtype))
    dim = _dim(kw)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, dim, dim, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = {k: jax.tree_util.tree_map_with_path(lambda p, l: jnp.asarray(draw(p, l)), v) for k, v in shapes.items()}
    model = UNet(**kw, dtype=getattr(torch, dtype))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables.get("batch_stats", {}), model))
    return jmodel, variables, model.eval()


def _inputs(kw, seed=1, n=2):
    dim = _dim(kw)
    x = np.random.default_rng(seed).standard_normal((n, dim, dim, 1)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _assert_int8_close(got, want):
    """Port against JAX int8 outputs (seg first, heats second): the
    tolerances of the module docstring."""
    got, want = [g.float().numpy() for g in _outs(got)], [_nchw(w) for w in _outs(want)]
    np.testing.assert_allclose(got[0], want[0], atol=SEG_ATOL)
    assert (got[0].argmax(1) == want[0].argmax(1)).mean() >= LABEL_AGREE
    if len(want) > 1:
        np.testing.assert_allclose(got[1], want[1], atol=HEAT_REL * np.abs(want[1]).max())


def _jax_apply(jmodel, float_levels=0):
    """JAX's int8 forward, jitted, as its ensemble and full-res programs run
    it (eager it takes seconds per call here)."""
    f = jq.make_level_filter(float_levels, jmodel.depth)
    return jax.jit(lambda q, v, s, x: jq.quantized_apply(jmodel, q, v, s, x, int8_points=f))


def _to_jax_qweights(qweights):
    """The port's int8 weights in the flax layouts (kh, kw, I, O); the
    transposed convolution's spatially flipped (compat/from_jax.py), so
    both engines run the same integers (JAX's jitted weight quantization
    rounds a few weights otherwise than its eager one, which the port
    equals)."""
    out = {}
    for key, (wq, scale) in qweights.items():
        w = wq.numpy().transpose(2, 3, 0, 1)[::-1, ::-1] if key.endswith("up_conv") else wq.numpy().transpose(2, 3, 1, 0)
        out[key] = (jnp.asarray(np.ascontiguousarray(w)), jnp.asarray(scale.numpy()))
    return out


def _jax_scales_to_port(scales):
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in scales.items()}


# -- the int8 convolutions ----------------------------------------------------------

# (name, batch, in channels, frame (h, w), out channels, kernel, stride, padding, pad mode)
CONV_KINDS = [
    ("3x3-one-channel-K9", 2, 1, (9, 9), 4, 3, 1, 1, "zeros"),
    ("3x3-circular", 2, 5, (7, 8), 8, 3, 1, 1, "circular"),
    ("3x3-valid", 2, 4, (8, 9), 8, 3, 1, 0, "zeros"),
    ("1x1-N7", 2, 16, (6, 6), 7, 1, 1, 0, "zeros"),
    ("1x1-K39-N21", 1, 39, (5, 7), 21, 1, 1, 0, "zeros"),
    ("2x2-stride2-odd", 2, 8, (9, 7), 8, 2, 2, 0, "zeros"),
    ("3x3-M-below-17", 1, 8, (3, 3), 16, 3, 1, 1, "zeros"),
]


def _xla_int8_conv(x, w, stride, padding, pad_mode):
    """The JAX engine's s8 x s8 -> s32 convolution (infer/quantized.py:
    141-164) on NCHW / OIHW numpy int8 operands; NCHW int32 out."""
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    if pad_mode == "circular":
        xj = jnp.pad(xj, ((0, 0), (padding, padding), (padding, padding), (0, 0)), mode="wrap")
        pads = "VALID"
    else:
        pads = [(padding, padding), (padding, padding)]
    kj = jnp.asarray(w.transpose(2, 3, 1, 0))
    dn = jax.lax.conv_dimension_numbers(xj.shape, kj.shape, ("NHWC", "HWIO", "NHWC"))
    y = jax.lax.conv_general_dilated(xj, kj, (stride, stride), pads, dimension_numbers=dn,
                                     preferred_element_type=jnp.int32)
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name,b,c,hw,o,k,stride,pad,mode", CONV_KINDS, ids=[c[0] for c in CONV_KINDS])
def test_int8_conv2d_is_exact(name, b, c, hw, o, k, stride, pad, mode):
    """The plain version, and the card route's im2col + GEMM run here with
    the CPU's ``torch._int_mm``, equal XLA's int8 convolution and an int64
    numpy convolution bit for bit, at full-range int8 values; the CPU
    wrapper launches no GEMM."""
    rng = np.random.default_rng(len(name))
    x = rng.integers(-127, 128, (b, c, *hw)).astype(np.int8)
    w = rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)

    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="wrap" if mode == "circular" else "constant")
    ho, wo = (xp.shape[2] - k) // stride + 1, (xp.shape[3] - k) // stride + 1
    want = np.zeros((b, o, ho, wo), np.int64)
    for di in range(k):
        for dj in range(k):
            patch = xp[:, :, di : di + stride * ho : stride, dj : dj + stride * wo : stride]
            want += np.einsum("bchw,oc->bohw", patch, w[:, :, di, dj].astype(np.int64))

    before = int8_conv.int8_gemm_launches
    plain = int8_conv.int8_conv2d(xt, wt, stride, pad, mode)
    route = int8_conv.im2col_conv2d(xt, wt, stride, pad, mode)
    assert plain.dtype == route.dtype == torch.int32 and int8_conv.int8_gemm_launches == before
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(route.numpy(), want)
    np.testing.assert_array_equal(_xla_int8_conv(x, w, stride, pad, mode), want)
    mat = int8_conv.gemm_weight(wt)
    assert mat.shape[0] % 8 == 0 and mat.shape[1] % 8 == 0 and mat.shape[0] >= o and mat.shape[1] >= k * k * c


@pytest.mark.parametrize("b,i,hw,o", [(2, 16, (5, 6), 8), (1, 3, (2, 2), 7)], ids=["wide", "K3-N7-M4"])
def test_int8_conv_transpose2x2_is_exact(b, i, hw, o):
    """2x2 stride 2 in the ConvTranspose2d layout (I, O, 2, 2): the plain
    version and the GEMM-and-pixel-shuffle route equal XLA's int8
    ``conv_transpose`` on the flipped (kh, kw, I, O) kernel of the flax
    layout (compat/from_jax.py) and an int64 numpy sum."""
    rng = np.random.default_rng(b * 100 + i)
    x = rng.integers(-127, 128, (b, i, *hw)).astype(np.int8)
    w = rng.integers(-127, 128, (i, o, 2, 2)).astype(np.int8)
    want = np.zeros((b, o, 2 * hw[0], 2 * hw[1]), np.int64)
    for di in range(2):
        for dj in range(2):
            want[:, :, di::2, dj::2] = np.einsum("bchw,co->bohw", x.astype(np.int64), w[:, :, di, dj].astype(np.int64))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(int8_conv.int8_conv_transpose2x2(xt, wt).numpy(), want)
    np.testing.assert_array_equal(int8_conv.im2col_conv_transpose2x2(xt, wt).numpy(), want)
    kj = jnp.asarray(np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1]))
    y = jax.lax.conv_transpose(jnp.asarray(x.transpose(0, 2, 3, 1)), kj, (2, 2), "VALID",
                               dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(np.asarray(y).transpose(0, 3, 1, 2), want)


def test_int8_conv_refuses_other_types():
    x = torch.zeros((1, 2, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        int8_conv.int8_conv2d(x.float(), torch.zeros((2, 2, 3, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        int8_conv.int8_conv_transpose2x2(x, torch.zeros((2, 2, 2, 2)))
    with pytest.raises(ValueError, match="pad_mode"):
        int8_conv.int8_conv2d(x, torch.zeros((2, 2, 3, 3), dtype=torch.int8), 1, 1, "reflect")


# -- the engine against the module and the JAX engine ------------------------------


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_float_replay_matches_unet_and_jax(kw):
    jmodel, variables, model = _pair(kw)
    xj, xt = _inputs(kw)
    got = _outs(tq.float_apply(model, xt))
    with torch.no_grad():
        module = _outs(model(xt))
    for g, m, w in zip(got, module, _outs(jq.float_apply(jmodel, variables, xj))):
        np.testing.assert_allclose(g.numpy(), m.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), _nchw(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_quantize_weights_bit_equal_to_jax(kw):
    """Every convolution of the flax net, keyed by its parameter path;
    int8 weights bit-equal after the layout change (per output channel:
    axis 0 of OIHW, axis 1 of the transposed convolution's (I, O, kh, kw)),
    scales within 1 ulp."""
    jmodel, variables, model = _pair(kw, seed=2)
    want = jq.quantize_weights(jmodel, variables)
    got = tq.quantize_weights(model)
    assert sorted(got) == sorted(want)
    n_conv = sum(isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) for m in model.modules())
    dead = 0 if model.downsample_convs is None else 1  # the deepest downsample conv, unused
    assert len(got) == n_conv - dead
    for key, (wq, scale) in got.items():
        kq, kscale = (np.asarray(a) for a in want[key])
        if key.endswith("up_conv"):
            kq = kq[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            kq = kq.transpose(3, 2, 0, 1)
        assert wq.dtype == torch.int8 and tuple(wq.shape) == kq.shape, key
        np.testing.assert_array_equal(wq.numpy(), kq, err_msg=key)
        np.testing.assert_array_max_ulp(scale.numpy(), kscale, maxulp=1)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_calibrate_matches_jax(kw):
    """Two calibration batches: the same quantization points as JAX, each
    scale within 1e-6 relative."""
    jmodel, variables, model = _pair(kw, seed=3)
    (xj1, xt1), (xj2, xt2) = _inputs(kw, seed=4), _inputs(kw, seed=5, n=1)
    want = jq.calibrate(jmodel, variables, [xj1, xj2])
    got = tq.calibrate(model, [xt1, xt2])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("pad_mode", ["zeros", "circular"])
def test_selector_network_int8_equals_float_and_jax(pad_mode):
    """The JAX tests' exact network (test_quantized.py:79): one +-1 tap per
    output channel, zero biases, integer inputs, unit activation scales.
    Every quantization point re-snaps to the same integers, so the port's
    int8 forward is bit-equal to the JAX engine's, and within one float32
    rounding of the final dequantization (127 * fl(1/127)) of its float
    forward."""
    kw = dict(n_classes=3, depth=3, wf=1, padding=True, pad_mode=pad_mode, batch_norm=False, max_pool=False,
              num_lands=2, do_soft_max=False)
    jmodel = JaxUNet(**kw)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)), train=False))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.asarray(_selector_kernel(leaf.shape, rng)) if p[-1].key == "kernel"
        else np.zeros(leaf.shape, np.float32), shapes["params"])
    variables = {"params": params}
    model = UNet(**kw)
    model.load_state_dict(state_dict_from_jax(params, {}, model))
    model.eval()
    x = rng.integers(-7, 8, (2, 16, 16, 1)).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())

    scales = {k: torch.tensor(1.0) for k in tq.calibration_stats(model, xt)[1]}
    qweights = tq.quantize_weights(model)
    got = tq.quantized_apply(model, qweights, scales, xt)
    jscales = {k: jnp.float32(1.0) for k in scales}
    want = _jax_apply(jmodel)(_to_jax_qweights(qweights), variables, jscales, jnp.asarray(x))
    for g, w, f in zip(got, want, tq.float_apply(model, xt)):
        np.testing.assert_array_equal(g.numpy(), _nchw(w))
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=1e-6, atol=0)
        assert np.abs(f.numpy()).max() >= 2  # integer activations, not all zero


@pytest.mark.parametrize("float_levels", [0, 1], ids=["all-int8", "hybrid-1"])
@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_quantized_apply_matches_jax(kw, float_levels):
    """The int8 forward and the hybrid mode (finest level in float) on the
    same weights and JAX's scales."""
    jmodel, variables, model = _pair(kw, seed=6)
    xj, xt = _inputs(kw, seed=7)
    scales = jq.calibrate(jmodel, variables, [xj])
    qweights = tq.quantize_weights(model)
    want = _jax_apply(jmodel, float_levels)(_to_jax_qweights(qweights), variables, scales, xj)
    got = tq.quantized_apply(model, qweights, _jax_scales_to_port(scales), xt,
                             tq.make_level_filter(float_levels, kw["depth"]))
    _assert_int8_close(got, want)
    # and it is not the float forward: quantization moved the outputs
    assert float((_outs(got)[0] - _outs(tq.float_apply(model, xt))[0]).abs().max()) > 1e-5


def test_make_level_filter_matches_jax():
    """Every quantization point of depth-4 nets (learned downsampling and
    upconv, max-pool and upsample, a landmark conv stack), float_levels
    0-4; the all-float filter leaves no point int8."""
    keys = set()
    for extra in (dict(max_pool=False), dict(up_mode="upsample", lands_block_depth=1, lands_num_1x1=3)):
        kw = dict(n_classes=3, depth=4, wf=1, padding=True, num_lands=2, **extra)
        keys |= set(tq.calibration_stats(UNet(**kw).eval(), torch.zeros((1, 1, 32, 32)))[1])
    assert {"downsample_2/x", "up_2/up_in", "up_0/conv_block/x1", "lands_block/x0", "lands_1x1_2/x"} <= keys
    for float_levels in range(5):
        mine, theirs = tq.make_level_filter(float_levels, 4), jq.make_level_filter(float_levels, 4)
        assert (mine is None) == (theirs is None) == (float_levels == 0)
        if mine is not None:
            assert {k: mine(k) for k in keys} == {k: theirs(k) for k in keys}, float_levels
    assert not any(tq.make_level_filter(4, 4)(k) for k in keys)


def test_bf16_member_matches_jax_within_bf16():
    """A bfloat16 member runs its float pieces in bfloat16 by explicit
    casts, each op rounded, as the JAX engine's dtype does (BatchNorm in
    JAX's op order, not fused): on JAX's scales its int8 forward equals
    JAX's within bf16's 2e-2 (measured 6e-8); its float replay, whose
    bfloat16 convolutions sum in another order, and so its own scales, are
    within 2e-2 of JAX's (seg) and 2 % (heats, scales)."""
    kw = CONFIGS[0]
    jmodel, variables, model = _pair(kw, seed=8, dtype="bfloat16")
    xj, xt = _inputs(kw, seed=9)
    jscales = jq.calibrate(jmodel, variables, [xj])
    qweights = tq.quantize_weights(model)
    # eager, as the JAX engine's dtype semantics are written: its jitted
    # program fuses the bfloat16 BatchNorm ops without rounding between
    want = jq.quantized_apply(jmodel, _to_jax_qweights(qweights), variables, jscales, xj)
    got = tq.quantized_apply(model, qweights, _jax_scales_to_port(jscales), xt)
    assert all(g.dtype == torch.float32 for g in got)
    heat_max = np.abs(_nchw(want[1])).max()
    np.testing.assert_allclose(got[0].numpy(), _nchw(want[0]), atol=2e-2)
    np.testing.assert_allclose(got[1].numpy(), _nchw(want[1]), atol=2e-2 * heat_max)
    for g, w in zip(tq.float_apply(model, xt), jax.jit(lambda v, x: jq.float_apply(jmodel, v, x))(variables, xj)):
        np.testing.assert_allclose(g.numpy(), _nchw(w), atol=2e-2 * max(1.0, np.abs(_nchw(w)).max()))
    scales = tq.calibrate(model, [xt])
    for k in jscales:
        np.testing.assert_allclose(float(scales[k]), float(jscales[k]), rtol=2e-2, err_msg=k)


def test_quantized_ensemble_forward_matches_jax():
    """K = 2 members calibrated on one batch: the member mean of softmax
    segs and per-image min-max heats, and the argmax (JAX
    make_quantized_ensemble_forward on the members' own scales and the
    same int8 weights, stacked as its prepare_quantized_ensemble does)."""
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    jmodel, members = _jax_members(jcfg, 2, seed=21)
    projs = make_synthetic_data(num_specimens=1, num_projs=3, img_dim=32, seed=4).projs
    jproj = jax_prepare_batch(JaxAugmentConfig(proj_pad_dim=36, prob_of_aug=0.0, include_heat_map=False),
                              jax.random.PRNGKey(0), jnp.asarray(projs))["proj"]
    models = _port_models(members)
    proj = torch.from_numpy(np.asarray(jproj).transpose(0, 3, 1, 2).copy())
    prepared = tq.prepare_quantized_ensemble(models, [proj])
    stats = jax.jit(lambda v, x: jq.calibration_stats(jmodel, v, x)[1])
    trees = [(v, _to_jax_qweights(p.qweights), jq.calibrate(jmodel, v, [jproj], stats_fn=stats))
             for v, p in zip(members, prepared)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    want = [np.asarray(a) for a in jq.make_quantized_ensemble_forward(jmodel, 14, (32, 32))(stacked, jproj)]
    seg, heats, labels = tq.quantized_ensemble_forward(prepared, proj, (32, 32), 14)
    assert labels.dtype == torch.uint8 and tuple(labels.shape) == (3, 32, 32)
    np.testing.assert_allclose(seg.numpy(), _nchw(want[0]), atol=SEG_ATOL)
    np.testing.assert_allclose(heats.numpy(), _nchw(want[1]), atol=HEAT_REL)
    assert (labels.numpy() == want[2]).mean() >= LABEL_AGREE


def test_quantized_fullres_infer_matches_jax():
    """``make_quantized_fullres_infer``: scales from two raw frames through
    the fused prep, then int8 labels and raw heats at 2x (148^2 -> 24^2,
    padded to 36^2)."""
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    jmodel, (variables,) = _jax_members(jcfg, 1, seed=23)
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=3, img_dim=148, seed=6)[0]
    projs, rots = spec["projs"], spec["rots"]
    want = jax_quantized_fullres(jmodel, variables, 2, 36, (148, 148), projs[:2], rots[:2])(
        jnp.asarray(projs), jnp.asarray(rots))
    model = UNet(n_classes=7, depth=3, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=14)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], model))
    infer = make_quantized_fullres_infer(model, 2, 36, (148, 148), torch.from_numpy(projs[:2]),
                                         torch.from_numpy(rots[:2]))
    labels, heats = infer(torch.from_numpy(projs), torch.from_numpy(rots))
    assert labels.dtype == torch.uint8 and tuple(labels.shape) == (3, 24, 24)
    assert (labels.numpy() == np.asarray(want[0])).mean() >= LABEL_AGREE
    np.testing.assert_allclose(heats.numpy(), _nchw(want[1]), atol=HEAT_REL * np.abs(np.asarray(want[1])).max())
    with pytest.raises(ValueError, match="at least one"):
        make_quantized_fullres_infer(model, 2, 36, (148, 148), torch.zeros((0, 148, 148)), torch.zeros((0,)))


# -- the ensemble paths -------------------------------------------------------------


def _port_models(members, **kw):
    out = []
    for v in members:
        m = UNet(n_classes=7, depth=3, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=14, **kw)
        m.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], m))
        out.append(m.eval())
    return out


def test_ensemble_batches_calibrate_on_the_leading_batches():
    """Batches of 2 over 5 frames with 2 calibration batches: the scales
    are those of the first 4 frames, the outputs the int8 ensemble's over
    all frames in order; the calibration errors."""
    _, members = _jax_members(JaxTrainConfig(**CFG, proj_unet_dim=36), 2, seed=25)
    models = _port_models(members)
    data = make_synthetic_data(num_specimens=1, num_projs=5, img_dim=32, seed=8)
    times = []
    got = list(ensemble_batches(data, models, 14, times, 2, 36, quantized=True, calib_batches=2))
    assert [(s, l.shape[0]) for s, l, _ in got] == [(0, 2), (2, 2), (4, 1)] and len(times) == 5

    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch

    proj = prepare_batch(AugmentConfig(proj_pad_dim=36, prob_of_aug=0.0), None, torch.from_numpy(data.projs))["proj"]
    prepared = tq.prepare_quantized_ensemble(models, [proj[:2], proj[2:4]])
    _, heats, labels = tq.quantized_ensemble_forward(prepared, proj, (32, 32), 14)
    np.testing.assert_array_equal(np.concatenate([l for _, l, _ in got]), labels.numpy())
    np.testing.assert_allclose(np.concatenate([h for _, _, h in got]), heats.numpy(), atol=1e-6)

    with pytest.raises(ValueError, match="at least one calibration batch"):
        next(ensemble_batches(data, models, 14, None, 2, 36, quantized=True, calib_batches=0))
    empty = data.subset([])
    with pytest.raises(ValueError, match="empty dataset"):
        next(ensemble_batches(empty, models, 14, None, 2, 36, quantized=True))


def test_quantized_test_dataset_ensemble_scores_the_int8_members(tmp_path):
    """The int8 ensemble's validation loss (the JAX package has no int8
    loss evaluation): scales from the first batch of 4, then per batch the
    cropped member mean of the int8 forwards (``quantized_ensemble_forward``'s
    members, held against JAX above) scored by the joint loss."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.ops.image import center_crop
    from deepfluoro_tpu_torch.ops.losses import per_sample_joint

    path = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=1, num_projs=6, img_dim=32, seed=2)
    _, members = _jax_members(JaxTrainConfig(**CFG, proj_unet_dim=36), 2, seed=27)
    models = _port_models(members)
    data = load_dataset(path, [1])
    got = port_ensemble_eval(data, models, 14, batch_size=4, pad_img_dim=36, heat_coeff=0.3, quantized=True,
                             calib_batches=1)
    float_loss = port_ensemble_eval(data, models, 14, batch_size=4, pad_img_dim=36, heat_coeff=0.3)

    aug = AugmentConfig(proj_pad_dim=36, prob_of_aug=0.0, include_heat_map=True)
    batches = [prepare_batch(aug, None, *(torch.from_numpy(a[i:i + 4]) for a in (data.projs, data.segs, data.lands)))
               for i in (0, 4)]
    fwds = tq.member_forwards(tq.prepare_quantized_ensemble(models, [batches[0]["proj"]]))
    losses = []
    for bt in batches:
        outs = [f(bt["proj"]) for f in fwds]
        seg = sum(center_crop(o[0], (32, 32)) for o in outs) / 2
        heats = sum(center_crop(o[1], (32, 32)) for o in outs) / 2
        losses.append(per_sample_joint(seg, heats, bt["seg"], bt["heats"], 0.3))
    losses = torch.cat(losses).numpy()
    np.testing.assert_allclose(got, (losses.mean(), losses.std(ddof=1)), rtol=1e-6)
    assert abs(got[0] - float_loss[0]) > 1e-7  # the int8 path ran


# -- the CLIs -----------------------------------------------------------------------


def _assert_cli_close(port, jax_file):
    """The nn-files of two CLIs that each calibrated their own scales on
    their own float replay and prep: a float difference of one rounding
    (or the full-res prep's 3.8e-6, ROADMAP §3) moves a few activations
    across a rounding boundary at a quantization point. The heats, min-max
    normalized to [0, 1], within 2e-2 everywhere and 1e-3 on >= 99.9 % of
    values (measured: 9.3e-3 and 0.077 % for full-res all-int8, <= 2.4e-7
    for full-res hybrid and test_ensemble int8, 2.0e-3 and 0.008 % for
    test_ensemble hybrid); labels >= 99.9 % equal (measured 100 %)."""
    d = np.abs(port["nn-heats"][:] - jax_file["nn-heats"][:])
    assert d.max() <= 2e-2 and (d > HEAT_REL).mean() <= 1e-3, (d.max(), (d > HEAT_REL).mean())
    assert (port["nn-segs"][:] == jax_file["nn-segs"][:]).mean() >= LABEL_AGREE


@pytest.fixture(scope="module")
def te_outputs(tmp_path_factory):
    """Both test_ensemble CLIs with --int8 (the default 4 calibration
    batches: both batches of 4 over 6 frames) and with --int8-float-levels
    1, on one fixture archive and the same two exported nets."""
    from deepfluoro_tpu.cli import test_ensemble as jax_cli
    from deepfluoro_tpu_torch.cli import test_ensemble as port_cli

    d = tmp_path_factory.mktemp("te_int8")
    ds = write_synthetic_dataset(str(d / "ds.h5"), num_specimens=2, num_projs=6, img_dim=32, seed=3)
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    _, members = _jax_members(jcfg, 2, seed=29)
    nets = [_export(jcfg, v, d / "net{}.pt".format(i)) for i, v in enumerate(members)]
    out = {}
    for mode, extra in (("int8", []), ("hybrid", ["--int8-float-levels", "1"])):
        for name, cli in (("jax", jax_cli), ("port", port_cli)):
            out[name, mode] = str(d / "{}_{}.h5".format(name, mode))
            cli.main([ds, out[name, mode], "--pats", "2", "--nets", *nets, "--batch-size", "4", "--no-gpu", "--int8",
                      *extra, "--times", str(d / "{}_{}_times.txt".format(name, mode))])
    return d, ds, nets, out


@pytest.mark.parametrize("mode", ["int8", "hybrid"])
def test_test_ensemble_int8_cli_matches_jax(te_outputs, mode):
    d, _, _, out = te_outputs
    with h5py.File(out["jax", mode], "r") as fj, h5py.File(out["port", mode], "r") as fp:
        for name in ("nn-segs", "nn-heats"):
            a, b = fj[name], fp[name]
            assert (b.shape, b.dtype, b.chunks, b.compression_opts) == (a.shape, a.dtype, a.chunks, a.compression_opts)
        _assert_cli_close(fp, fj)
    assert len(open(d / "port_{}_times.txt".format(mode)).read().split()) == 6


def test_int8_cli_refuses_zero_calibration_batches(te_outputs, tmp_path):
    from deepfluoro_tpu.cli import test_ensemble as jax_cli
    from deepfluoro_tpu_torch.cli import test_ensemble as port_cli

    _, ds, nets, _ = te_outputs
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        with pytest.raises(ValueError, match="at least one calibration batch"):
            cli.main([ds, str(tmp_path / (name + ".h5")), "--pats", "2", "--nets", *nets, "--no-gpu", "--int8",
                      "--int8-calib-batches", "0"])


@pytest.mark.parametrize("extra", [[], ["--int8-float-levels", "1"]], ids=["int8", "hybrid"])
def test_seg_fullres_int8_cli_matches_jax(tmp_path, extra):
    """Both seg_fullres CLIs with --int8 at 2x over five raw frames at batch
    2 (scales from the first two frames through the fused prep)."""
    from deepfluoro_tpu.cli import seg_fullres as jax_cli
    from deepfluoro_tpu_torch.cli import seg_fullres as port_cli

    archive = write_synthetic_fullres_dataset(str(tmp_path / "full.h5"), num_specimens=1, num_projs=5, seed=7)
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    _, members = _jax_members(jcfg, 2, seed=31)
    nets = [_export(jcfg, v, tmp_path / "net{}.pt".format(i)) for i, v in enumerate(members)]
    out = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out[name] = str(tmp_path / "{}.h5".format(name))
        cli.main([archive, out[name], "--ds-factor", "2", "--nets", *nets, "--batch-size", "2", "--no-gpu", "--int8",
                  *extra])
    with h5py.File(out["port"], "r") as a, h5py.File(out["jax"], "r") as b:
        assert a["nn-segs"].shape == b["nn-segs"].shape == (5, 24, 24)
        _assert_cli_close(a, b)


def test_fullres_batches_int8_calibrate_on_the_first_batch():
    """Five frames at batch 2: the int8 outputs equal
    ``make_quantized_fullres_infer`` calibrated on the first two frames,
    with its heats min-max normalized per image."""
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    _, members = _jax_members(jcfg, 1, seed=33)
    (model,) = _port_models(members)
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    got = list(fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (148, 148), [model],
                               2, 14, None, 2, 36, quantized=True))
    labels, heats = make_quantized_fullres_infer(model, 2, 36, (148, 148), torch.from_numpy(spec["projs"][:2]),
                                                 torch.from_numpy(spec["rots"][:2]))(
        torch.from_numpy(spec["projs"]), torch.from_numpy(spec["rots"]))
    hmin = heats.amin(dim=(1, 2, 3), keepdim=True)
    heats = (heats - hmin) / (heats.amax(dim=(1, 2, 3), keepdim=True) - hmin)
    np.testing.assert_array_equal(np.concatenate([l for _, l, _ in got]), labels.numpy())
    np.testing.assert_allclose(np.concatenate([h for _, _, h in got]), heats.numpy(), atol=1e-6)


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_fullres_batches_int8_calibrate_and_run_under_measured_algorithms(caller, monkeypatch):
    """The int8 calibration forward and every int8 batch forward run under
    the flags of ``fullres_batches``' float forwards, with the caller's
    TF32 and ``enabled``; the caller's flags are back while the consumer
    holds a batch and after the generator ends."""
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    _, members = _jax_members(jcfg, 1, seed=33)
    (model,) = _port_models(members)
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    seen = {"calibrate": [], "forward": []}

    def recorded(fn, key):
        def call(*args, **kw):
            seen[key].append(cudnn_flags())
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(tq, "calibration_stats", recorded(tq.calibration_stats, "calibrate"))
    monkeypatch.setattr(tq, "quantized_apply", recorded(tq.quantized_apply, "forward"))
    with as_caller(CALLERS[caller]):
        for _ in fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (148, 148), [model],
                                 2, 14, None, 2, 36, quantized=True, int8_float_levels=1):
            assert cudnn_flags() == CALLERS[caller]
        assert cudnn_flags() == CALLERS[caller]
    # one calibration forward on the first batch; the warm-up and three batches
    assert [len(seen["calibrate"]), len(seen["forward"])] == [1, 4]
    assert all(flags == inside_scope(CALLERS[caller]) for flags in seen["calibrate"] + seen["forward"])


# -- profiling ----------------------------------------------------------------------


def test_profile_trace_writes_a_trace_and_is_a_noop_without_a_dir(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json") and files[0].stat().st_size > 0
    with profiling.profile_trace(""):
        torch.ones(8).sum()
    with profiling.profile_trace(None):
        pass


def test_train_cli_profile_dir_and_debug_nans(tmp_path, monkeypatch):
    """--profile-dir writes a trace of the run; --debug-nans turns on
    autograd's anomaly mode."""
    from deepfluoro_tpu_torch.cli import train as port_train

    monkeypatch.chdir(tmp_path)
    path = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=2, num_projs=3, img_dim=32, seed=1)
    assert not torch.is_anomaly_enabled()
    try:
        port_train.main([path, "--train-pats", "1,2", "--num-classes", "7", "--unet-img-dim", "36", "--unet-num-lvls",
                         "2", "--unet-init-feats-exp", "2", "--batch-size", "2", "--max-num-epochs", "1",
                         "--unet-padding", "--train-valid-split", "0.75", "--no-gpu", "--profile-dir",
                         str(tmp_path / "prof"), "--debug-nans"])
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
    assert (tmp_path / "zz_checkpoint.pt").exists()


def test_inference_clis_write_a_profile(tmp_path):
    """--profile-dir on test_ensemble and seg_fullres (with --int8)."""
    from deepfluoro_tpu_torch.cli import seg_fullres as port_fullres
    from deepfluoro_tpu_torch.cli import test_ensemble as port_te

    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    _, (variables,) = _jax_members(jcfg, 1, seed=35)
    net = _export(jcfg, variables, tmp_path / "net.pt")
    ds = write_synthetic_dataset(str(tmp_path / "ds.h5"), num_specimens=1, num_projs=2, img_dim=32, seed=3)
    port_te.main([ds, str(tmp_path / "o.h5"), "--pats", "1", "--nets", net, "--no-gpu", "--int8", "--profile-dir",
                  str(tmp_path / "te")])
    full = write_synthetic_fullres_dataset(str(tmp_path / "full.h5"), num_specimens=1, num_projs=2, seed=7)
    port_fullres.main([full, str(tmp_path / "f.h5"), "--ds-factor", "2", "--nets", net, "--no-gpu", "--int8",
                       "--profile-dir", str(tmp_path / "fr")])
    for sub in ("te", "fr"):
        assert len(list((tmp_path / sub).glob("*.pt.trace.json"))) == 1
