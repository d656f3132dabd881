"""The port's full-resolution inference (deepfluoro_tpu_torch.data.
preprocess.make_fused_fullres_infer, infer/fullres.py and the seg_fullres
CLI) against the JAX package's, on the CPU, on the same weights: flax
variables drawn from a numpy seed, written as a reference-layout .pt by
the JAX package's exporter and read by both packages' loaders.

Raw 148^2 frames come from the full-res fixture (crop 48^2, 2x -> 24^2
padded to 36^2). Tolerances: heats within 1e-4 (float32 on both sides,
convolutions summed in another order); labels equal wherever JAX's top
two mean probabilities differ by more than 1e-4."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfluoro_tpu.cli import seg_fullres as jax_cli
from deepfluoro_tpu.data.preprocess import make_fullres_prep as jax_prep
from deepfluoro_tpu.data.preprocess import make_fused_fullres_infer as jax_fused
from deepfluoro_tpu.infer import fullres as jfull
from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint as jax_load_net
from deepfluoro_tpu.infer.ensemble import make_ensemble_forward, stack_variables
from deepfluoro_tpu.train.config import TrainConfig as JaxTrainConfig
from deepfluoro_tpu_torch.cli import seg_fullres as port_cli
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data, write_synthetic_fullres_dataset
from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep, make_fused_fullres_infer
from deepfluoro_tpu_torch.infer import ensemble_forward, load_net_from_checkpoint
from deepfluoro_tpu_torch.infer import fullres as tfull
from deepfluoro_tpu_torch.ops.image import center_crop
from test_torch_port_infer import _export, _jax_members

ATOL = 1e-4
MARGIN = 1e-4
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
