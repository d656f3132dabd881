"""The spatial axis's repairs (``parallel/halo.py``'s row exchanges,
``UNet.set_bands``): row sharding of an unpadded U-Net, of 'upsample',
and of frames whose padded rows are not whole coarsest-level blocks (an
odd 49-row frame at depth 3, like the real 8x archive's 193 rows at depth
6), each against one process and against the JAX package's unsharded
forward; ``cli/train.py --spatial-devices 2`` without ``--unet-padding``;
int8 full-res inference on {'data': 2, 'spatial': 2}
(``tests/test_infer_more.py``'s sharded int8 case); and the recipe's
layout keeping its exchanges. Ranks are gloo processes on the CPU with
one torch thread each: one spawn of two ranks and one of four.

Tolerances: a row-sharded loss within 1e-6 relative of one process's
float32 loss, and every gradient as close to one process's float64
gradient as one process's float32 gradient is (the worst ratio of the two
errors at most 2, with a floor of 1e-5 of the tensor's largest value:
float32's rounding of a sum), as ``chip_smoke.py`` phase 11(b) gates the
recipe's step; the eval-mode forward within 1e-6 of one process's and
within 1e-4 of JAX's (the CPU's and XLA's convolutions sum in other
orders). int8 against one process: labels equal, heats within 1e-5; the
CLI's loss files within rtol 1e-5 of one process's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from deepfluoro_tpu.models import UNet as JaxUNet
from deepfluoro_tpu_torch.cli import train as cli_train
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.models.unet import Conv3x3
from deepfluoro_tpu_torch.parallel.halo import Bands
from deepfluoro_tpu_torch.parallel.mesh import Axis, row_layout
from deepfluoro_tpu_torch.parallel.multihost import Ranks
from deepfluoro_tpu_torch.train import TrainConfig
from deepfluoro_tpu_torch.train.step import per_sample_losses
from deepfluoro_tpu_torch.utils.io import read_floats_from_txt

BASE = dict(n_classes=7, depth=3, wf=2, batch_norm=True, max_pool=False, num_lands=4)
# (flags, padded input rows, 'spatial' size)
REPAIRS = {
    "valid": (dict(BASE, padding=False), 64, 2),
    "upsample": (dict(BASE, padding=True, up_mode="upsample"), 40, 2),
    "odd_rows": (dict(BASE, padding=True), 49, 2),
    "valid_upsample_maxpool_odd": (dict(BASE, padding=False, up_mode="upsample", max_pool=True), 61, 2),
    # bands 12 + 12 + 12 + 12 of 48 rows: the output's 8 rows lie on the
    # two middle bands, the outer two hold none of the deep levels' rows
    "valid_empty_bands": (dict(BASE, padding=False), 48, 4),
    "odd_rows_four": (dict(BASE, padding=True, pad_mode="circular"), 49, 4),
}
# the three repairs, held against JAX's unsharded forward too
JAX_HELD = ("valid", "upsample", "odd_rows")
CFG = dict(num_classes=7, num_lands=4, optim_type="sgd", init_lr=0.1, momentum=0.9, nesterov=True, wgt_decay=1e-4,
           depth=3)

FULLRES_FLAGS = dict(n_classes=7, depth=2, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test files run at once under pytest-xdist; torch's OpenMP
    threads in each would spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _out_rows(flags, rows):
    with torch.no_grad():
        return UNet(**flags).eval()(torch.zeros(1, 1, rows, rows))[0].shape[-1]


def _inputs():
    """Per repair: seeded weights, a batch of 2 frames and targets 2 rows
    inside the output; per int8 case the full-res net and 2 raw frames."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (flags, rows, _) in REPAIRS.items():
        torch.manual_seed(1)
        sd = _np(UNet(**flags).state_dict())
        t = max(_out_rows(flags, rows) - 2, 2)
        proj = rng.standard_normal((2, 1, rows, rows)).astype(np.float32)
        seg = np.ascontiguousarray(np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, t, t))].transpose(0, 3, 1, 2))
        heats = rng.random((2, 4, t, t)).astype(np.float32)
        out[name] = {"flags": flags, "sd": sd, "batch": (proj, seg, heats)}
    torch.manual_seed(2)
    out["fullres"] = {"sd": _np(UNet(**FULLRES_FLAGS).state_dict()),
                      "projs": np.asarray(rng.random((2, 148, 148)), np.float32) + 0.1, "rots": np.array([True, False])}
    return out


def _call(name, case):
    return "spatial_grads", (case["flags"], CFG, case["sd"], *case["batch"], {"spatial": REPAIRS[name][2]})


def _one(case, dtype):
    """One process: (loss, {name: float64 gradient}, eval-mode forward)."""
    model = UNet(**case["flags"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["sd"].items()})
    model.to(dtype).eval()
    proj, seg, heats = (torch.from_numpy(a).to(dtype) for a in case["batch"])
    with torch.no_grad():
        fwd = [o.double().numpy() for o in model(proj)]
    model.train()
    loss = per_sample_losses(TrainConfig(**CFG), model(proj), seg, heats, True).mean()
    loss.backward()
    return float(loss.detach()), {k: p.grad.double().numpy() for k, p in model.named_parameters() if p.grad is not None}, fwd


def _jax_forward(case):
    """The JAX package's unsharded eval-mode forward from the same weights
    (flax trees built from the port's state dict by the port's own module
    paths; the port's importer must give the weights back)."""
    from deepfluoro_tpu_torch.compat.from_jax import _entries

    flags, sd = case["flags"], case["sd"]
    port = UNet(**flags)
    params, stats = {}, {}

    def put(tree, path, leaves):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = leaves

    for name, path, mod in _entries(port):
        if name == "downsample_convs.{}".format(flags["depth"] - 1):
            continue  # the dead deepest conv, which flax never makes
        if isinstance(mod, torch.nn.BatchNorm2d):
            put(params, path, {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]})
            put(stats, path, {"mean": sd[name + ".running_mean"], "var": sd[name + ".running_var"]})
        elif isinstance(mod, torch.nn.ConvTranspose2d):
            put(params, path, {"kernel": np.ascontiguousarray(sd[name + ".weight"].transpose(2, 3, 0, 1)[::-1, ::-1]),
                               "bias": sd[name + ".bias"]})
        else:
            leaves = {"kernel": np.ascontiguousarray(sd[name + ".weight"].transpose(2, 3, 1, 0))}
            if name + ".bias" in sd:
                leaves["bias"] = sd[name + ".bias"]
            put(params, path, leaves)
    back = state_dict_from_jax(params, stats, port)
    for k, v in back.items():
        if not k.startswith("downsample_convs.{}".format(flags["depth"] - 1)):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    proj = case["batch"][0].transpose(0, 2, 3, 1)
    seg, heats = JaxUNet(**flags).apply({"params": params, "batch_stats": stats}, jnp.asarray(proj), train=False)
    return [np.asarray(seg).transpose(0, 3, 1, 2), np.asarray(heats).transpose(0, 3, 1, 2)]


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("repairs") / "ds.h5"), num_specimens=2, num_projs=4,
                                   img_dim=32, seed=1)


@pytest.fixture(scope="module")
def runs():
    """The ranks start, then the one-process and JAX references run here."""
    cases = _inputs()
    two = [_call(n, cases[n]) for n in REPAIRS if REPAIRS[n][2] == 2]
    fr = cases["fullres"]
    four = [_call(n, cases[n]) for n in REPAIRS if REPAIRS[n][2] == 4] + [
        ("quantized_fullres", (FULLRES_FLAGS, fr["sd"], fr["projs"], fr["rots"], 2, 28, {"data": 2, "spatial": 2},
                               2))]
    spawned = [Ranks(ranks.run_all, 2, args=(two,), device="cpu"), Ranks(ranks.run_all, 4, args=(four,), device="cpu")]
    try:
        refs = {n: {"one32": _one(cases[n], torch.float32), "one64": _one(cases[n], torch.float64)} for n in REPAIRS}
        for n in JAX_HELD:
            refs[n]["jax"] = _jax_forward(cases[n])
        got2, got4 = (r.results(timeout=600) for r in spawned)
    finally:
        for r in spawned:
            r.close()
    names2 = [n for n in REPAIRS if REPAIRS[n][2] == 2]
    names4 = [n for n in REPAIRS if REPAIRS[n][2] == 4]
    got = {n: [r[i] for r in got2] for i, n in enumerate(names2)}
    got.update({n: [r[i] for r in got4] for i, n in enumerate(names4)})
    return {"cases": cases, "refs": refs, "got": got, "int8": [r[len(names4)] for r in got4]}


def _forward_whole(results):
    """The output map's rows, each band's in order, joined."""
    parts = sorted(results, key=lambda r: r["out"][0])
    return [np.concatenate([r["forward"][j] for r in parts], axis=2) for j in range(2)]


@pytest.mark.parametrize("name", list(REPAIRS))
def test_row_sharded_step_is_as_exact_as_one_process(runs, name):
    loss32, g32, _ = runs["refs"][name]["one32"]
    _, g64, _ = runs["refs"][name]["one64"]
    for r in runs["got"][name]:
        assert r["loss"] == pytest.approx(loss32, rel=1e-6)
        assert sorted(r["grads"]) == sorted(g64)
        for k, want in g64.items():
            floor = 1e-5 * np.abs(want).max()
            ratio = np.abs(r["grads"][k] - want).max() / max(np.abs(g32[k] - want).max(), floor)
            assert ratio <= 2.0, (k, ratio)


@pytest.mark.parametrize("name", list(REPAIRS))
def test_row_sharded_forward_equals_one_process_and_jax(runs, name):
    got = _forward_whole(runs["got"][name])
    one = runs["refs"][name]["one32"][2]
    for j, (g, o) in enumerate(zip(got, one)):
        assert g.shape == o.shape
        np.testing.assert_allclose(g, o, rtol=0, atol=1e-6)
        if name in JAX_HELD:
            np.testing.assert_allclose(g, runs["refs"][name]["jax"][j], rtol=0, atol=1e-4)


def test_layouts_and_empty_bands(runs):
    """The odd frame's last band takes the row past the whole blocks; the
    valid U-Net's output map leaves the outer bands of four empty, and
    they still ran every collective (their steps above completed)."""
    assert [r["layout"] for r in runs["got"]["odd_rows"]] == [(0, 24), (24, 49)]
    outs = [r["out"] for r in runs["got"]["valid_empty_bands"]]
    assert outs[0][0] == outs[0][1] == 0 and outs[-1][0] == outs[-1][1] == outs[-1][2]
    assert sum(hi - lo for lo, hi, _ in outs) == outs[0][2] == _out_rows(REPAIRS["valid_empty_bands"][0], 48)


@pytest.mark.parametrize("rows,parts", [(192, 2), (1440, 2), (736, 2), (1440, 4), (192, 4)])
def test_recipe_layout_keeps_its_exchanges(rows, parts):
    """A padded 'upconv' U-Net at depth 6 on bands of whole blocks: each
    3x3 convolution trades one row with each neighbour; no other layer
    (downsampling, upsampling, crops) trades anything."""
    model = UNet(n_classes=7, depth=6, wf=1, padding=True, batch_norm=True, max_pool=False, num_lands=2)
    bounds = np.cumsum((0,) + row_layout(rows, parts, 32)).tolist()
    for k in range(parts):
        model.set_bands(Bands(Axis(parts, k, None, tuple(range(parts))), bounds))
        convs = [m.rows for m in model.modules() if isinstance(m, Conv3x3)]
        others = list(model.pool_rows) + [model.lands_rows] + [
            p for up in model.up_path for p in (up.up_rows, up.bridge_rows)] + [
            m.res_rows for m in model.modules() if hasattr(m, "res_rows") and m.res_rows is not None]
        assert len(convs) == 2 * 11 and all(p.view and not p.sends for p in others)
        neighbours = (k > 0) + (k < parts - 1)
        for p in convs:
            assert len(p.sends) == len(p.recvs) == neighbours
            assert all(len(rows_) == 1 for _, rows_ in p.sends + p.recvs)


def test_real_8x_archive_geometry_plans():
    """179 -> 193 rows at depth 6 (the real 8x archive), two bands of 96 +
    97: every layer planned, the 193rd row's levels on the last band."""
    model = UNet(n_classes=7, depth=6, wf=1, padding=True, batch_norm=True, max_pool=False, num_lands=2)
    assert row_layout(193, 2, 32) == (96, 97)
    outs = [model.set_bands(Bands(Axis(2, k, None, (0, 1)), (0, 96, 193))) for k in range(2)]
    assert outs[0][:2] == (0, 96) and outs[1][:2] == (96, 192) and outs[1][2] == 192


def test_int8_bands_equal_one_process(runs):
    """``make_quantized_fullres_infer(mesh=...)`` on {'data': 2, 'spatial':
    2} against one process's int8 program, and ``fullres_batches(mesh=...,
    quantized=True)`` against one process's; scales from the whole frames
    on every rank."""
    from deepfluoro_tpu_torch.data.preprocess import make_quantized_fullres_infer

    fr = runs["cases"]["fullres"]
    model = UNet(**FULLRES_FLAGS)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in fr["sd"].items()})
    model.eval()
    p, r = torch.from_numpy(fr["projs"]), torch.from_numpy(fr["rots"])
    labels, heats = make_quantized_fullres_infer(model, 2, 28, (148, 148), p, r)(p, r)
    want = list(fullres_batches(lambda i0, i1: (fr["projs"][i0:i1], fr["rots"][i0:i1]), 2, (148, 148), [model], 2,
                                num_lands=4, batch_size=2, pad_img_dim=28, quantized=True))
    for got in runs["int8"]:
        np.testing.assert_array_equal(got["labels"], labels.numpy())
        np.testing.assert_allclose(got["heats"], heats.numpy(), rtol=0, atol=1e-5)
    got = runs["int8"][0]["batches"]
    assert [b[0] for b in got] == [b[0] for b in want] == [0]
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_allclose(got[0][2], want[0][2], rtol=0, atol=1e-5)
    assert all(b[1] is None for r_ in runs["int8"][1:] for b in r_["batches"])


def _files(d, tag):
    return {k: os.path.join(str(d), "{}_{}".format(tag, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}


def test_cli_spatial_devices_without_padding_equal_one_process(tmp_path, archive):
    common = [archive, "--train-pats", "1,2", "--num-classes", "7", "--unet-img-dim", "52", "--unet-num-lvls", "2",
              "--unet-init-feats-exp", "2", "--batch-size", "2", "--max-num-epochs", "1", "--unet-batch-norm",
              "--unet-no-max-pool", "--use-lands", "--train-valid-split", "0.75", "--no-gpu", "--init-lr", "0.1",
              "--nesterov", "--data-aug"]
    out = {}
    for tag, extra in (("one", []), ("sp", ["--spatial-devices", "2"])):
        files = _files(tmp_path, tag)
        cli_train.main(common + extra + ["--checkpoint-net", files["checkpoint_filename"], "--best-net",
                                         files["best_valid_filename"], "--train-loss-txt", files["train_loss_txt"],
                                         "--valid-loss-txt", files["valid_loss_txt"]])
        out[tag] = (read_floats_from_txt(files["train_loss_txt"]), read_floats_from_txt(files["valid_loss_txt"]))
    assert len(out["sp"][0]) == len(out["one"][0]) > 0
    np.testing.assert_allclose(out["sp"][0], out["one"][0], rtol=1e-5)
    np.testing.assert_allclose(out["sp"][1], out["one"][1], rtol=1e-5)
