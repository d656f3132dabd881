"""The port's full-resolution inference (deepfluoro_tpu_torch.data.
preprocess.make_fused_fullres_infer, infer/fullres.py and the seg_fullres
CLI) against the JAX package's, on the CPU, on the same weights: flax
variables drawn from a numpy seed, written as a reference-layout .pt by
the JAX package's exporter and read by both packages' loaders.

Raw 148^2 frames come from the full-res fixture (crop 48^2, 2x -> 24^2
padded to 36^2). Tolerances: heats within 1e-4 (float32 on both sides,
convolutions summed in another order); labels equal wherever JAX's top
two mean probabilities differ by more than 1e-4. The cuDNN flags that
the batch driver of ``fullres_batches`` and ``ensemble_batches`` sets
around their forwards (``infer/batches.py::measured_algorithms``) are
read by hooks, and so is its choice between eager forwards and one CUDA
graph (never on the CPU, a mesh or int8); they have no JAX counterpart."""

import contextlib
import gc

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepfluoro_tpu.cli import seg_fullres as jax_cli
from deepfluoro_tpu.data.preprocess import make_fullres_prep as jax_prep
from deepfluoro_tpu.data.preprocess import make_fused_fullres_infer as jax_fused
from deepfluoro_tpu.infer import fullres as jfull
from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint as jax_load_net
from deepfluoro_tpu.infer.ensemble import make_ensemble_forward, stack_variables
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu_torch.cli import seg_fullres as port_cli
from deepfluoro_tpu_torch.data.fixtures import (
    make_synthetic_data, make_synthetic_fullres_data, write_synthetic_fullres_dataset,
)
from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep, make_fused_fullres_infer
from deepfluoro_tpu_torch.infer import ensemble_batches, ensemble_forward, load_net_from_checkpoint
from deepfluoro_tpu_torch.infer.batches import MEASURED_CANDIDATES
from deepfluoro_tpu_torch.infer import batches as tbatches
from deepfluoro_tpu_torch.infer import ensemble as tens
from deepfluoro_tpu_torch.infer import fullres as tfull
from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.parallel.mesh import make_mesh
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.utils import profiling
from test_torch_port_infer import _export, _jax_members

ATOL = 1e-4
MARGIN = 1e-4
CFG = dict(num_classes=7, depth=3, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14)
CUDNN_FLAGS = ("benchmark", "deterministic", "benchmark_limit", "allow_tf32", "enabled")
# the caller's cuDNN flags: the recipe's (TF32 off), and a caller who
# already asked for deterministic algorithms and for every candidate to be
# timed, with TF32 on and cuDNN off
CALLERS = {
    "float32": dict(benchmark=False, deterministic=False, benchmark_limit=10, allow_tf32=False, enabled=True),
    "deterministic": dict(benchmark=False, deterministic=True, benchmark_limit=0, allow_tf32=True, enabled=False),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Two members for 36^2 input, exported by the JAX package."""
    d = tmp_path_factory.mktemp("fullres_nets")
    jcfg = JaxTrainConfig(**CFG, proj_unet_dim=36)
    jmodel, members = _jax_members(jcfg, 2, seed=13)
    return jmodel, members, [_export(jcfg, v, d / "net{}.pt".format(i)) for i, v in enumerate(members)]


def _clear(labels_port, labels_jax, mean_seg_nchw):
    """Pixels whose top two JAX probabilities differ by more than MARGIN:
    the labels must agree there."""
    top2 = np.sort(mean_seg_nchw, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels_port[clear], labels_jax[clear])


@pytest.mark.parametrize("factor,pad_dim", [(2, 36), (4, 20)])
def test_fused_fullres_infer_matches_jax(nets, factor, pad_dim):
    """One net behind the fused prep: uint8 labels and the raw heatmaps,
    frames with and without the rot-180 flag."""
    jmodel, members, _ = nets
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=3, img_dim=148, seed=5)[0]
    projs, rots = spec["projs"], spec["rots"]
    want_labels, want_heats = (np.asarray(a) for a in jax_fused(jmodel, members[0], factor, pad_dim, (148, 148))(
        jnp.asarray(projs), jnp.asarray(rots)))
    jp, (hc, wc) = jax_prep(factor, pad_dim, (148, 148))
    jseg = np.asarray(jmodel.apply(members[0], jp(jnp.asarray(projs), jnp.asarray(rots)), train=False)[0])
    seg_nchw = center_crop(torch.from_numpy(jseg.transpose(0, 3, 1, 2).copy()), (hc, wc)).numpy()
    model, _ = load_net_from_checkpoint(nets[2][0], device="cpu", verbose=False)
    labels, heats = make_fused_fullres_infer(model, factor, pad_dim, (148, 148))(torch.from_numpy(projs),
                                                                                 torch.from_numpy(rots))
    assert labels.dtype == torch.uint8 and tuple(labels.shape) == (3, 48 // factor, 48 // factor)
    np.testing.assert_allclose(heats.numpy(), want_heats.transpose(0, 3, 1, 2), atol=ATOL)
    _clear(labels.numpy(), want_labels, seg_nchw)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """One specimen of five raw frames: batches of 2 end with a partial one."""
    d = tmp_path_factory.mktemp("fullres")
    return str(write_synthetic_fullres_dataset(str(d / "full.h5"), num_specimens=1, num_projs=5, seed=7))


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory, archive, nets):
    d = tmp_path_factory.mktemp("fullres_out")
    out = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out[name] = str(d / "{}.h5".format(name))
        cli.main([archive, out[name], "--ds-factor", "2", "--nets", *nets[2], "--batch-size", "2", "--no-gpu",
                  "--times", str(d / "{}_times.txt".format(name))])
    return d, out


def test_seg_fullres_cli_matches_jax(archive, nets, cli_outputs):
    jmodel, members, _ = nets
    d, out = cli_outputs
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    jp, hw = jax_prep(2, 36, (148, 148))
    mean_seg = np.asarray(make_ensemble_forward(jmodel, 14, hw)(
        stack_variables(members), jp(jnp.asarray(spec["projs"]), jnp.asarray(spec["rots"])))[0])
    with h5py.File(out["port"], "r") as a, h5py.File(out["jax"], "r") as b:
        for key in ("nn-segs", "nn-heats"):
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
            assert a[key].chunks == b[key].chunks and a[key].compression == b[key].compression == "gzip", key
            assert a[key].compression_opts == b[key].compression_opts == 9
        assert a["nn-segs"].shape == (5, 24, 24) and a["nn-heats"].shape == (5, 14, 24, 24)
        np.testing.assert_allclose(a["nn-heats"][:], b["nn-heats"][:], atol=ATOL)
        _clear(a["nn-segs"][:], b["nn-segs"][:], mean_seg.transpose(0, 3, 1, 2))
        names = [a["land-names"]["land-{:02d}".format(i)][()] for i in range(a["land-names/num-lands"][()])]
        assert names == [b["land-names"]["land-{:02d}".format(i)][()] for i in range(14)]
    for name in ("port", "jax"):
        assert len(np.loadtxt(str(d / "{}_times.txt".format(name)))) == 5


def test_fullres_batches_pad_the_final_batch_and_time_real_frames(nets):
    """Five frames at batch 2: three batches, the last padded with its last
    frame but yielded at one frame; one time per real frame; the outputs
    equal one ensemble pass over all five."""
    models = [load_net_from_checkpoint(p, device="cpu", verbose=False)[0] for p in nets[2]]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    reads = []

    def read_batch(i0, i1):
        reads.append((i0, i1))
        return spec["projs"][i0:i1], spec["rots"][i0:i1]

    times = []
    batches = list(tfull.fullres_batches(read_batch, 5, (148, 148), models, 2, 14, times, 2, 36))
    assert reads == [(0, 2), (2, 4), (4, 5)]
    assert [(s, l.shape[0], h.shape[0]) for s, l, h in batches] == [(0, 2, 2), (2, 2, 2), (4, 1, 1)]
    assert len(times) == 5 and times[0] == times[1] and times[4] > 0
    prep, hw = make_fullres_prep(2, 36, (148, 148))
    _, heats, labels = ensemble_forward(models, prep(torch.from_numpy(spec["projs"]), torch.from_numpy(spec["rots"])),
                                        hw, 14)
    np.testing.assert_array_equal(np.concatenate([l for _, l, _ in batches]), labels.numpy())
    np.testing.assert_allclose(np.concatenate([h for _, _, h in batches]), heats.numpy(), atol=1e-6)


def _memory_holder(a):
    """The array or tensor whose memory ``a`` views (``a`` itself if it
    owns its data): ``a`` keeps it alive."""
    while isinstance(a, np.ndarray) and not a.flags.owndata:
        a = a.base
    return a


def test_fullres_batches_yield_arrays_the_consumer_owns(nets):
    """Batch 0's arrays, kept while three more batches of other frames are
    read back and dropped, still equal one ensemble pass over their frames
    and their own values when yielded; every yielded array is C-contiguous,
    of its dtype, shares memory with no other batch's, and keeps alive the
    memory it views."""
    models = [load_net_from_checkpoint(p, device="cpu", verbose=False)[0] for p in nets[2]]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=8, img_dim=148, seed=11)[0]
    gen = tfull.fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 8, (148, 148), models,
                                2, 14, None, 2, 36)
    i0, labels0, heats0 = next(gen)
    as_yielded = labels0.copy(), heats0.copy()
    later = list(gen)
    del gen
    gc.collect()
    assert i0 == 0 and [s for s, _, _ in later] == [2, 4, 6]
    prep, hw = make_fullres_prep(2, 36, (148, 148))
    _, heats, labels = ensemble_forward(models, prep(torch.from_numpy(spec["projs"][:2]),
                                                     torch.from_numpy(spec["rots"][:2])), hw, 14)
    np.testing.assert_array_equal(labels0, as_yielded[0])
    np.testing.assert_array_equal(heats0, as_yielded[1])
    np.testing.assert_array_equal(labels0, labels.numpy())
    np.testing.assert_allclose(heats0, heats.numpy(), atol=1e-6)
    yielded = [a for _, l, h in [(i0, labels0, heats0), *later] for a in (l, h)]
    for a, dtype in zip(yielded, [np.uint8, np.float32] * 4):
        assert a.dtype == dtype and a.flags.c_contiguous
        assert isinstance(_memory_holder(a), (np.ndarray, torch.Tensor))
    for j, a in enumerate(yielded):
        assert not any(np.shares_memory(a, b) for b in yielded[j + 1 :])


def cudnn_flags() -> dict:
    return {k: getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS}


@contextlib.contextmanager
def as_caller(flags):
    """Set the cuDNN flags ``flags`` for the body, the test's own back after."""
    saved = cudnn_flags()
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def inside_scope(caller) -> dict:
    """The flags a forward of the batch driver runs under."""
    return dict(caller, benchmark=True, deterministic=True, benchmark_limit=MEASURED_CANDIDATES)


def _front_batches(front, model):
    """Five frames at batch 2 through ``model`` (padded to 36): raw 148^2
    frames (``fullres_batches`` at 2x) or a preprocessed archive of 32^2
    frames (``ensemble_batches``)."""
    if front == "ensemble":
        return ensemble_batches(make_synthetic_data(num_specimens=1, num_projs=5, img_dim=32, seed=7), [model], 14,
                                None, 2, 36)
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    return tfull.fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (148, 148), [model],
                                 2, 14, None, 2, 36)


@pytest.mark.parametrize("front", ["fullres", "ensemble"])
@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("consumer", ["reads_every_batch", "closes_early", "run_raises"])
def test_fullres_forwards_measure_algorithms_and_the_caller_keeps_its_flags(nets, front, caller, consumer):
    """The warm-up and every batch's member calls of either front end run
    with cuDNN's benchmark and deterministic on, ``MEASURED_CANDIDATES``
    candidates timed, and the caller's TF32 and ``enabled``; the caller's
    flags are back while the consumer holds a batch, after an early
    ``close()``, and after an exception inside the forward."""
    model = load_net_from_checkpoint(nets[2][0], device="cpu", verbose=False)[0]
    seen = []

    def record(module, args, out):
        seen.append(cudnn_flags())
        if consumer == "run_raises" and len(seen) == 2:
            raise RuntimeError("forward failed")

    model.register_forward_hook(record)
    with as_caller(CALLERS[caller]):
        gen = _front_batches(front, model)
        if consumer == "run_raises":
            with pytest.raises(RuntimeError, match="forward failed"):
                next(gen)
        else:
            for _ in gen:
                assert cudnn_flags() == CALLERS[caller]
                if consumer == "closes_early":
                    gen.close()
        assert cudnn_flags() == CALLERS[caller]
    # the warm-up and then one call a batch
    assert len(seen) == {"reads_every_batch": 4, "closes_early": 2, "run_raises": 2}[consumer]
    assert all(flags == inside_scope(CALLERS[caller]) for flags in seen)


@pytest.mark.parametrize("dispatch_s,device_s,pays", [(0.5, 1.0, True), (0.4999, 1.0, False)],
                         ids=["on-the-line", "just-below"])
def test_a_graph_pays_where_dispatch_is_half_the_card_time(dispatch_s, device_s, pays):
    """The capture decision is a function of the two measured times alone:
    a CUDA graph where the host's dispatch is at least half the card's time,
    eager below."""
    assert tbatches.graph_pays(dispatch_s, device_s) is pays


@pytest.mark.parametrize("front", ["fullres", "ensemble"])
def test_batches_on_the_cpu_never_capture_a_graph(nets, front, monkeypatch):
    """On the CPU the batch driver captures nothing even where a graph would
    pay: no second warm-up forward, no ``graph_replays``, and the same
    arrays as a run whose decision says eager."""
    model = load_net_from_checkpoint(nets[2][0], device="cpu", verbose=False)[0]
    calls = []
    model.register_forward_hook(lambda *_: calls.append(1))
    eager = list(_front_batches(front, model))
    monkeypatch.setattr(tbatches, "graph_pays", lambda dispatch_s, device_s: True)

    def no_capture(*args):
        raise AssertionError("captured a CUDA graph on the CPU")

    monkeypatch.setattr(tbatches, "_captured", no_capture)
    calls.clear()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        offered = list(_front_batches(front, model))
    counts = profiling.recorded()[1]
    profiling.reset()
    # the warm-up and then one call a batch
    assert len(calls) == 1 + len(offered) == 4
    assert counts == {"host_syncs": 1 + 2 * len(offered)}
    for (i0, labels, heats), (j0, labels_e, heats_e) in zip(offered, eager, strict=True):
        assert i0 == j0
        np.testing.assert_array_equal(labels, labels_e)
        np.testing.assert_array_equal(heats, heats_e)


@pytest.mark.parametrize("path", ["float", "mesh", "int8", "transunet"])
@pytest.mark.parametrize("front", ["fullres", "ensemble"])
def test_only_single_device_float_unet_forwards_are_offered_for_capture(nets, front, path, monkeypatch):
    """``fullres_batches`` and ``ensemble_batches`` offer their forward to
    the batch driver's CUDA graph only on one device, in float, over U-Net
    members: a mesh's ranks must not decide apart and gloo's collectives
    cannot be captured, the int8 forwards stay eager, and a TransUNet's
    forward records spans and ``attention_calls`` that a replay would not."""
    if path == "transunet":
        torch.manual_seed(0)
        model = build_model(TrainConfig(arch="transunet", num_classes=7, num_lands=14, proj_unet_dim=48, hidden_size=32,
                                        num_heads=4, mlp_dim=64, num_layers=2, resnet_units=(1, 2, 1), resnet_width=8,
                                        gn_groups=4, decoder_channels=(16, 8, 8, 4))).eval()
        pad = 48
    else:
        model, pad = load_net_from_checkpoint(nets[2][0], device="cpu", verbose=False)[0], 36
    offered = []

    def driver(*args, graphable=False, **kwargs):
        offered.append(graphable)
        return iter(())

    owner = tfull if front == "fullres" else tens
    monkeypatch.setattr(owner, "run_batches", driver)
    kw = {"mesh": {"mesh": make_mesh({"data": 1})}, "int8": {"quantized": True}}.get(path, {})
    if front == "fullres":
        spec = make_synthetic_fullres_data(num_specimens=1, num_projs=2, img_dim=148, seed=7)[0]
        tfull.fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 2, (148, 148), [model],
                              2, 14, None, 2, pad, **kw)
    else:
        ensemble_batches(make_synthetic_data(num_specimens=1, num_projs=2, img_dim=32, seed=7), [model], 14, None, 2,
                         pad, **kw)
    assert offered == [path == "float"]


def test_wrong_rung_int8_and_missing_card_are_refused(tmp_path, archive, nets):
    """Nets padded to 36^2 cannot serve the 1x rung (48^2 frames): both CLIs
    refuse, with and without --int8 (int8 itself is held against JAX in
    test_torch_port_quantized.py); without a card the port's CLI refuses
    unless given --no-gpu."""
    for cli in (jax_cli, port_cli):
        for extra in ([], ["--int8"]):
            with pytest.raises(ValueError, match="different downsample factor"):
                cli.main([archive, str(tmp_path / "o.h5"), "--ds-factor", "1", "--nets", *nets[2], "--no-gpu", *extra])
    models = [load_net_from_checkpoint(nets[2][0], device="cpu", verbose=False)[0]]
    with h5py.File(archive, "r") as src, h5py.File(str(tmp_path / "q.h5"), "w") as f:
        with pytest.raises(ValueError, match="different downsample factor"):
            tfull.seg_fullres_dataset(src, None, models, f, 1, 14, pad_img_dim=36, quantized=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main([archive, str(tmp_path / "c.h5"), "--ds-factor", "2", "--nets", *nets[2]])


def test_frame_index_and_land_names_equal_jax(tmp_path):
    path = write_synthetic_fullres_dataset(str(tmp_path / "two.h5"), num_specimens=2, num_projs=3, seed=2)
    with h5py.File(path, "r") as src:
        for specimens in (None, ["18-1109", "17-1882"], ["18-1109"]):
            got = tfull.list_fullres_frames(src, specimens)
            assert got == jfull.list_fullres_frames(src, specimens)
            assert tfull.fullres_land_names(src, got) == jfull.fullres_land_names(src, got)
        assert tfull.list_fullres_frames(src)[:2] == [("17-1882", "000"), ("17-1882", "001")]
        with pytest.raises(ValueError, match="not in the archive"):
            tfull.list_fullres_frames(src, ["99-0000"])


def test_bf16_members_serve_full_res_frames(tmp_path, nets):
    """A member whose checkpoint asks for bfloat16 runs in bfloat16 on the
    full-res path too (the JAX loader builds it at the checkpoint's dtype)."""
    ck = torch.load(nets[2][0], weights_only=False)
    ck["compute-dtype"] = "bfloat16"
    path = str(tmp_path / "bf16.pt")
    torch.save(ck, path)
    model, cfg = load_net_from_checkpoint(path, device="cpu", verbose=False)
    assert model.dtype == torch.bfloat16 and jax_load_net(path, verbose=False)[2].compute_dtype == "bfloat16"
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=2, img_dim=148, seed=5)[0]
    labels, heats = make_fused_fullres_infer(model, 2, 36, (148, 148))(torch.from_numpy(spec["projs"]),
                                                                      torch.from_numpy(spec["rots"]))
    assert heats.dtype == torch.float32 and torch.isfinite(heats).all() and int(labels.max()) < 7
