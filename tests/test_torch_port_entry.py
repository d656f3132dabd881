"""The port's entry points (deepfluoro_tpu_torch/entry.py) against the JAX
package's (__graft_entry__.py at the repository root), on the CPU.

``entry``: the flagship model's JAX variables carried to the port's model
by compat.from_jax; one 192^2 bf16 forward of each agrees within the bf16
tolerances the port pins (ROADMAP §3: softmax within 2e-2, heats within
2 % of the largest; the two round to bfloat16 at other points).
``dryrun_multichip``: two and four gloo ranks on the CPU run the four parts
and print JAX's OK lines; the row-sharded step's loss equals one process's
step from the same weights within 1e-5 relative (float32 sums over bands),
and the other parts equal one process's the same way."""

import contextlib
import importlib
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from deepfluoro_tpu_torch import entry as port_entry
from deepfluoro_tpu_torch.compat import state_dict_from_jax
from deepfluoro_tpu_torch.infer.ensemble import ensemble_forward
from deepfluoro_tpu_torch.train.config import TrainConfig
from deepfluoro_tpu_torch.train.multifold import _build_models, multifold_step
from deepfluoro_tpu_torch.train.step import make_optimizer, update_step

BF16_ATOL = 2e-2
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_entry():
    """The repository root's ``__graft_entry__``, imported through a path
    shim that is removed afterwards (as tests/test_parallel.py does)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        return importlib.import_module("__graft_entry__")
    finally:
        sys.path.remove(root)


def test_entry_forward_matches_jax_within_bf16():
    jfn, (variables, jx) = _jax_entry().entry()
    want = [np.asarray(a).transpose(0, 3, 1, 2) for a in jax.jit(jfn)(variables, jx)]
    fn, (model, x) = port_entry.entry(device="cpu")
    assert x.device.type == "cpu" and tuple(x.shape) == (1, 1, 192, 192) and not model.training
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx).transpose(0, 3, 1, 2))
    assert (len(model.down_path), model.dtype) == (6, torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], model))
    seg, heats = fn(model, x)
    assert (tuple(seg.shape), tuple(heats.shape)) == ((1, 7, 192, 192), (1, 14, 192, 192))
    assert seg.dtype == heats.dtype == torch.float32
    np.testing.assert_allclose(seg.numpy(), want[0], atol=BF16_ATOL)
    np.testing.assert_allclose(heats.numpy(), want[1], atol=BF16_ATOL * float(np.abs(want[1]).max()))


def test_entry_and_dryrun_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot happen")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)


@pytest.mark.parametrize("cards,nprocs,want", [(0, 2, "gloo"), (1, 2, "gloo"), (2, 2, "nccl"), (4, 2, "nccl"),
                                               (2, 4, "gloo")])
def test_ranks_take_nccl_only_with_a_card_each(monkeypatch, cards, nprocs, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert port_entry.rank_backend(torch.device("cuda"), nprocs) == want
    assert port_entry.rank_backend(torch.device("cpu"), nprocs) == "gloo"


@pytest.fixture(scope="module", params=[2, 4])
def dryrun(request):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        parts = port_entry.dryrun_multichip(request.param, device="cpu")
    return request.param, parts, out.getvalue().splitlines()


def test_dryrun_prints_jaxs_ok_lines_for_all_four_parts(dryrun):
    n, parts, lines = dryrun
    axes = "{'data': 1, 'spatial': 2}" if n == 2 else "{'data': 2, 'spatial': 2}"
    patterns = [
        r"dryrun_multichip OK: mesh=" + re.escape(axes) + r" loss=-?\d+\.\d{6}$",
        r"dryrun_multichip OK: mesh=\{'model': 2\} loss=-?\d+\.\d{6}$",
        r"dryrun_multichip OK: mesh=\{'ensemble': 2\} ensemble forward$",
        r"dryrun_multichip OK: mesh=\{'ensemble': 2\} multifold step$",
    ]
    assert len(lines) == 4 and all(re.match(p, ln) for p, ln in zip(patterns, lines)), lines
    assert [p["part"] for p in parts] == ["data_spatial", "tp", "ensemble", "multifold"]
    assert [len(p["ranks"]) for p in parts] == [n, 2, 2, 2] and all(p["backend"] == "gloo" for p in parts)
    assert all(r["warp_launches"] == 0 for p in parts for r in p["ranks"])


def _one_process_step(model_seed, batch_seed, batch_rows, cfg):
    model = port_entry.seeded_model(cfg, model_seed)
    batch = port_entry.dryrun_batch(np.random.default_rng(batch_seed), batch_rows, cfg.proj_unet_dim)
    return float(update_step(model, make_optimizer(cfg, model.parameters()), cfg, batch, port_entry.DRYRUN_LR))


def test_dryrun_steps_equal_one_process(dryrun):
    """The data x spatial step (global batch 2 per data shard) and the
    tensor-parallel step against one process's step from the same weights
    and batch; every rank reports the same loss."""
    n, parts, _ = dryrun
    cfg = TrainConfig(**port_entry.DRYRUN)
    for part, seed, rows in ((parts[0], 0, parts[0]["mesh"]["data"] * 2), (parts[1], 1, 2)):
        # the model's seed is the batch's too (JAX: PRNGKey(0) with rng 0, PRNGKey(1) with rng 1)
        losses = [r["loss"] for r in part["ranks"]]
        assert len(set(losses)) == 1, (part["part"], losses)
        want = _one_process_step(seed, seed, rows, cfg)
        assert abs(losses[0] - want) <= REL * abs(want), (part["part"], losses[0], want)


def test_dryrun_folds_equal_one_process(dryrun):
    """The two folds' lockstep losses, gathered on both ranks, against both
    folds stepped in one process from fit_multifold's initialization."""
    _, parts, _ = dryrun
    cfg = TrainConfig(**port_entry.DRYRUN, seed=4)
    models = _build_models(cfg, 2, torch.device("cpu"))
    union, idx, aug = port_entry.dryrun_fold_step(cfg)
    want = multifold_step(models, [make_optimizer(cfg, m.parameters()) for m in models], cfg, aug, None,
                          tuple(t[idx.reshape(-1)] for t in union), [port_entry.DRYRUN_LR] * 2).tolist()
    for r in parts[3]["ranks"]:
        np.testing.assert_allclose(r["losses"], want, rtol=REL)


def test_dryrun_ensemble_equals_one_process(dryrun):
    """The 2-member ensemble over two ranks against one process's ensemble
    of the same seeded members: each rank's sum is one member's, so the
    reduction adds the same two terms and the result is equal."""
    _, parts, _ = dryrun
    cfg = TrainConfig(**port_entry.DRYRUN)
    members = [port_entry.seeded_model(cfg, s).eval() for s in (2, 3)]
    proj = port_entry.dryrun_batch(np.random.default_rng(1), 2, cfg.proj_unet_dim)["proj"]
    _, heats, labels = ensemble_forward(members, proj, (48, 48), cfg.num_lands)
    for r in parts[2]["ranks"]:
        assert r["labels"].shape == (2, 48, 48)
        np.testing.assert_array_equal(r["labels"], labels.numpy())
        np.testing.assert_allclose(r["heats"], heats.numpy(), rtol=0, atol=1e-6)
