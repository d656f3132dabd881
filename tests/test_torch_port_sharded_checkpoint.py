"""The port's sharded checkpoints (``train/sharded_checkpoint.py``), each
case of ``tests/test_sharded_checkpoint.py`` whose subject the port has:
the round trip and its payload, a params-only restore, tensor-parallel
save -> whole restore, whole save -> tensor-parallel restore and a step,
the incomplete directory, the torn re-save, the layout without slots and
a re-save; and between 'model' degrees 1, 2 and 4 (two gloo ranks, then
four, on the CPU with one torch thread each).

Tolerances: saves and restores move bits (equal); a step from a restored
state against one process's step from the same state as
``test_torch_port_tp.py``'s against one process (loss within 1e-6
relative, parameters within 1e-5)."""

import os
import shutil

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.parallel import run_ranks
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.tensor import channel_dims, slice_optimizer_state, slice_state
from deepfluoro_tpu_torch.train import TrainConfig, load_checkpoint, load_sharded_checkpoint, save_sharded_checkpoint
from deepfluoro_tpu_torch.train.step import make_optimizer, update_step

FLAGS = dict(n_classes=7, depth=2, wf=2, padding=True, batch_norm=True, max_pool=False, num_lands=4)
CFG = dict(num_classes=7, batch_size=4, proj_unet_dim=32, depth=2, init_feats_exp=2, batch_norm=True, padding=True,
           no_max_pool=True, num_lands=4, optim_type="sgd", init_lr=0.1, momentum=0.9, nesterov=True, wgt_decay=1e-4)


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


@pytest.fixture(scope="module")
def case():
    torch.manual_seed(0)
    sd = _np(UNet(**FLAGS).state_dict())
    rng = np.random.default_rng(3)
    proj = rng.random((4, 1, 32, 32)).astype(np.float32)
    seg = np.ascontiguousarray(np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4, 32, 32))].transpose(0, 3, 1, 2))
    heats = rng.random((4, 4, 32, 32)).astype(np.float32)
    return {"sd": sd, "batch": (proj, seg, heats)}


def _trained(case, state=None, optimizer_state=None):
    """A whole model and optimizer from ``state`` (default: the case's
    weights, fresh optimizer), after one step on the case's batch."""
    model = UNet(**FLAGS)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in (state or case["sd"]).items()})
    cfg = TrainConfig(**CFG)
    opt = make_optimizer(cfg, model.parameters())
    if optimizer_state is not None:
        opt.load_state_dict(optimizer_state)
    proj, seg, heats = (torch.from_numpy(a) for a in case["batch"])
    loss = update_step(model, opt, cfg, {"proj": proj, "seg": seg, "heats": heats}, 0.1)
    return model, opt, float(loss)


def _save(path, model, opt, **kw):
    save_sharded_checkpoint(str(path), TrainConfig(**CFG).to_checkpoint_meta(), model, opt, **kw)


def _momentum(opt_state, model):
    keys = [k for k, _ in model.named_parameters()]
    return {keys[int(i)]: e["momentum_buffer"].numpy() for i, e in opt_state["state"].items()}


@pytest.fixture(scope="module")
def degrees(case, tmp_path_factory):
    """A one-process checkpoint after a step; the two ranks save theirs at
    T = 2 and restore the one-process one; the four save at T = 4 and
    restore the one-process one and T = 2's."""
    d = tmp_path_factory.mktemp("sharded")
    model, opt, loss = _trained(case)
    whole = str(d / "whole")
    _save(whole, model, opt, epoch=7)
    paths = {1: whole, 2: str(d / "tp2"), 4: str(d / "tp4")}
    out = {"paths": paths, "loss": loss, "state": _np(model.state_dict()),
           "momentum": _momentum(opt.state_dict(), model)}
    for size, loads in ((2, [whole]), (4, [whole, paths[2]])):
        got = run_ranks(ranks.run_all, size, args=([("sharded_checkpoints", (
            FLAGS, CFG, case["sd"], *case["batch"], 0.1, {"model": size}, paths[size], loads))],), device="cpu",
            timeout=600)
        out[size] = [r[0] for r in got]
    return out


def test_round_trip_and_payload_contract(case, tmp_path):
    """One process: the payload has ``load_checkpoint``'s layout and
    values, and the tensors come back bit for bit."""
    model, opt, loss = _trained(case)
    path = tmp_path / "ck"
    _save(path, model, opt, sched_state={"T_cur": 1.5}, epoch=7, best_valid_loss=-0.25, last_loss=-0.5,
          num_restarts=2, train_idx=[0, 2], valid_idx=[1])
    out = load_sharded_checkpoint(str(path))
    single = tmp_path / "single.pt"
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(str(single), TrainConfig(**CFG), model, opt, {"T_cur": 1.5}, 7, -0.25, -0.5, 2, [0, 2], [1])
    want = load_checkpoint(str(single))
    assert sorted(out) == sorted(want)
    assert out["epoch"] == 7 and float(out["loss"]) == pytest.approx(-0.5)
    assert out["best-valid-loss"] == pytest.approx(-0.25) and out["lrs-num-restarts"] == 2
    assert out["scheduler-state-dict"]["T_cur"] == pytest.approx(1.5)
    assert out["train-idx"] == [0, 2] and out["valid-idx"] == [1]
    assert TrainConfig.from_checkpoint_meta({k: v for k, v in out.items() if not k.endswith("state-dict")}).depth == 2
    for k, v in model.state_dict().items():
        assert torch.equal(out["model-state-dict"][k], v), k
    assert out["optimizer-state-dict"]["param_groups"] == want["optimizer-state-dict"]["param_groups"]
    for i, e in opt.state_dict()["state"].items():
        assert torch.equal(out["optimizer-state-dict"]["state"][i]["momentum_buffer"], e["momentum_buffer"])


def test_partial_restore_params_only(case, tmp_path):
    model, opt, _ = _trained(case)
    _save(tmp_path / "ck", model, opt, epoch=3)
    out = load_sharded_checkpoint(str(tmp_path / "ck"), optimizer=False)
    assert out["epoch"] == 3 and out["optimizer-state-dict"] == {}
    fresh = UNet(**FLAGS)
    fresh.load_state_dict(out["model-state-dict"])
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_partial_restore_onto_tp_shares(case, tmp_path):
    """A params-only restore cut for a 'model' rank: this rank's shares of
    each cut leaf, the whole leaves whole."""
    model, opt, _ = _trained(case)
    _save(tmp_path / "ck", model, opt)
    dims = channel_dims(UNet(**FLAGS))
    for index in range(4):
        axis = Axis(4, index, None, (0, 1, 2, 3))
        out = load_sharded_checkpoint(str(tmp_path / "ck"), axis, optimizer=False)
        want = slice_state(model.state_dict(), dims, axis)
        assert any(out["model-state-dict"][k].shape != v.shape for k, v in model.state_dict().items())
        for k, v in want.items():
            assert torch.equal(out["model-state-dict"][k], v), k


@pytest.mark.parametrize("size", [2, 4])
def test_save_tp_restore_whole(degrees, size):
    """Each rank held its shares at save time; one process restores the
    whole state bit for bit as the ranks gathered it."""
    out = load_sharded_checkpoint(degrees["paths"][size])
    ranks_ = degrees[size]
    assert all(r["reload_equal"] for r in ranks_)
    model = UNet(**FLAGS)
    for k, v in out["model-state-dict"].items():
        np.testing.assert_array_equal(v.numpy(), ranks_[0]["state"][k], err_msg=k)
    for k, v in _momentum(out["optimizer-state-dict"], model).items():
        np.testing.assert_array_equal(v, ranks_[0]["momentum"][k], err_msg=k)
    # and the ranks' step from the same weights is one process's
    assert ranks_[0]["loss"] == pytest.approx(degrees["loss"], rel=1e-6)
    for k, v in degrees["state"].items():
        np.testing.assert_allclose(ranks_[0]["state"][k], v, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("size,source", [(2, 1), (4, 1), (4, 2)])
def test_save_restore_across_degrees_and_step(case, degrees, size, source):
    """A checkpoint of degree ``source`` restored onto ``size`` ranks (whole
    -> TP, and T = 2 -> T = 4) takes the step one process takes from the
    same restored state."""
    path = degrees["paths"][source]
    whole = load_sharded_checkpoint(path)
    model, _, loss = _trained(case, {k: v.numpy() for k, v in whole["model-state-dict"].items()},
                              whole["optimizer-state-dict"])
    got = degrees[size][0]["loaded"][path]
    assert got["epoch"] == whole["epoch"]
    assert got["loss"] == pytest.approx(loss, rel=1e-6)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_slices_follow_the_rule(case):
    """Momentum buffers are cut like their parameters (a resume of a
    whole checkpoint onto 'model' ranks)."""
    model, opt, _ = _trained(case)
    dims = channel_dims(UNet(**FLAGS))
    keys = [k for k, _ in model.named_parameters()]
    axis = Axis(2, 1, None, (0, 1))
    cut = slice_optimizer_state(opt.state_dict(), keys, dims, axis)
    params = slice_state(dict(model.named_parameters()), dims, axis)
    for i, e in cut["state"].items():
        assert e["momentum_buffer"].shape == params[keys[int(i)]].shape


def test_incomplete_dir_raises(case, tmp_path):
    model, opt, _ = _trained(case)
    path = tmp_path / "ck"
    _save(path, model, opt)
    slot = (path / "CURRENT").read_text().strip()
    os.remove(path / slot / "meta.pt")
    with pytest.raises(FileNotFoundError):
        load_sharded_checkpoint(str(path))


def test_torn_resave_preserves_previous(case, tmp_path):
    """A crash mid-resave (the other slot half-written, CURRENT not yet
    flipped) leaves the previous checkpoint readable; the next save
    reclaims the torn slot."""
    model, opt, _ = _trained(case)
    path = tmp_path / "ck"
    _save(path, model, opt, epoch=7)
    slot = (path / "CURRENT").read_text().strip()
    other = "slot1" if slot == "slot0" else "slot0"
    os.makedirs(path / other / "arrays")
    (path / other / "arrays" / "shard-00-of-01.pt").write_bytes(b"torn")
    out = load_sharded_checkpoint(str(path))
    assert out["epoch"] == 7
    for k, v in model.state_dict().items():
        assert torch.equal(out["model-state-dict"][k], v), k
    _save(path, model, opt, epoch=8)
    assert load_sharded_checkpoint(str(path))["epoch"] == 8
    assert (path / "CURRENT").read_text().strip() == other and not (path / slot).exists()


def test_legacy_layout_still_loads(case, tmp_path):
    """A directory without CURRENT (arrays/ and the sidecar at its top) is
    read from its top level; a save over it moves it into a slot."""
    model, opt, _ = _trained(case)
    path = tmp_path / "ck"
    _save(path, model, opt, epoch=3)
    slot = (path / "CURRENT").read_text().strip()
    for name in ("arrays", "meta.pt"):
        shutil.move(str(path / slot / name), str(path / name))
    shutil.rmtree(path / slot)
    os.remove(path / "CURRENT")
    assert load_sharded_checkpoint(str(path))["epoch"] == 3
    _save(path, model, opt, epoch=4)
    assert load_sharded_checkpoint(str(path))["epoch"] == 4
    assert not (path / "arrays").exists() and not (path / "meta.pt").exists()


def test_resave_overwrites(case, tmp_path):
    model, opt, _ = _trained(case)
    path = tmp_path / "ck"
    _save(path, model, opt, epoch=1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    _save(path, model, opt, epoch=2)
    out = load_sharded_checkpoint(str(path))
    assert out["epoch"] == 2
    for k, v in model.state_dict().items():
        assert torch.equal(out["model-state-dict"][k], v), k
