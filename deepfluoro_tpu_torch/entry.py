"""Entry points of the port (JAX counterpart: ``__graft_entry__.py`` at the
repository root, which stays the JAX package's).

- ``entry(device=None)`` returns ``(fn, (model, x))``: the flagship model
  (the IPCAI paper configuration: depth-6, wf-5 U-Net with BatchNorm,
  learned downsampling and padding, joint 7-class seg and 14-landmark
  heatmap heads at 192^2, bfloat16 compute under the port's autocast as
  JAX's ``compute_dtype="bfloat16"``) on ``device`` with one seeded input
  frame; ``fn(model, x)`` is the eval-mode forward, ``(seg, heats)``.
- ``dryrun_multichip(n, device=None)`` runs one of each parallel path on
  ``n`` ranks at a small size (depth 3, wf 3, 48^2, 14 landmarks, Nesterov
  SGD at LR 0.1), as JAX's ``_dryrun_impl`` does on an n-device mesh: a
  training step on {'data': n/2, 'spatial': 2} ({'data': n} for odd n)
  with 2 frames per data shard; a tensor-parallel step on {'model': 2};
  the ensemble forward of 2 members over {'ensemble': 2}; a fold-parallel
  lockstep step of 2 folds over {'ensemble': 2}, augmentation off. It
  prints JAX's ``dryrun_multichip OK: mesh=...`` line for each part and
  returns the parts' results.

Device rule. ``device=None`` means CUDA, and a host without a card raises
(``utils/platform.py::get_device``); the CPU runs only when the caller
passes ``device="cpu"``. The JAX version moves to ``n`` virtual CPU devices
when fewer chips are present; the port does not. With ``n`` or more cards
each rank takes its own card and the ranks join over NCCL; with fewer, the
ranks share the cards (rank r on card r modulo the count) and join over
gloo, since NCCL refuses two ranks on one card; on the CPU they join over
gloo. The ranks are spawned processes (``parallel/multihost.py::
run_ranks``), so a script that calls ``dryrun_multichip`` needs an ``if
__name__ == "__main__":`` guard.
"""

from __future__ import annotations

import numpy as np
import torch

from deepfluoro_tpu_torch.parallel.multihost import run_ranks
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.utils.platform import get_device

FLAGSHIP = dict(num_classes=7, depth=6, init_feats_exp=5, batch_norm=True, padding=True, no_max_pool=True,
                num_lands=14, proj_unet_dim=192, compute_dtype="bfloat16")
DRYRUN = dict(num_classes=7, depth=3, init_feats_exp=3, batch_norm=True, padding=True, no_max_pool=True,
              num_lands=14, proj_unet_dim=48, optim_type="sgd", init_lr=0.1, momentum=0.9, nesterov=True,
              wgt_decay=1e-4)
DRYRUN_LR = 0.1


def seeded_model(cfg: TrainConfig, seed: int):
    """``build_model(cfg)`` with torch's initialization drawn from ``seed``;
    the caller's global RNG state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(cfg)


def entry(device=None):
    """(fn, (model, x)): the flagship model in eval mode on ``device`` and a
    (1, 1, 192, 192) float32 frame (numpy's ``default_rng(0).random``, as
    JAX's ``entry``); ``fn(model, x)`` -> (seg softmax (1, 7, 192, 192),
    heats (1, 14, 192, 192)), float32 from bfloat16 compute."""
    dev = get_device(device)
    cfg = TrainConfig(**FLAGSHIP)
    model = seeded_model(cfg, 0).to(dev).eval()
    x = np.random.default_rng(0).random((1, cfg.proj_unet_dim, cfg.proj_unet_dim, 1)).astype(np.float32)
    x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dev)

    def fn(model, x):
        model.train(False)
        with torch.no_grad():
            seg, heats = model(x)
        return seg, heats

    return fn, (model, x)


def dryrun_batch(rng: np.random.Generator, b: int, hw: int = 48, num_classes: int = 7, num_lands: int = 14):
    """JAX ``_dryrun_impl``'s prepared batch, channels first: proj (b, 1,
    hw, hw) uniform, seg one-hot (b, C, hw, hw) of uniform labels, heats
    (b, L, hw, hw) uniform, drawn in that order from ``rng``."""
    proj = rng.random((b, hw, hw, 1)).astype(np.float32)
    seg = np.eye(num_classes, dtype=np.float32)[rng.integers(0, num_classes, (b, hw, hw))]
    heats = rng.random((b, hw, hw, num_lands)).astype(np.float32)
    return {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in
            (("proj", proj), ("seg", seg), ("heats", heats))}


def _rank_device(device: str) -> torch.device:
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _part_data_spatial(n_devices: int, dev) -> dict:
    """One training step on {'data': n/2, 'spatial': 2} from seed 0's
    weights: this rank's data slice of 2 frames per shard, its band of
    rows."""
    from deepfluoro_tpu_torch.parallel import make_mesh, shard_rows, sync_batch_norm
    from deepfluoro_tpu_torch.train.step import make_optimizer, shard_prepared, update_step

    # data x spatial where n is even, as JAX's 2-D mesh; else data alone
    axes = {"data": n_devices // 2, "spatial": 2} if n_devices % 2 == 0 else {"data": n_devices}
    cfg = TrainConfig(**DRYRUN)
    mesh = make_mesh(axes)
    data = mesh.axis("data")
    model = seeded_model(cfg, 0).to(dev)
    batch = dryrun_batch(np.random.default_rng(0), axes["data"] * 2, cfg.proj_unet_dim)
    rows = data.rows(axes["data"] * 2)
    prepared = {k: v[rows].to(dev) for k, v in batch.items()}
    shard = None
    if "spatial" in axes:
        shard = shard_rows(model, mesh, cfg.proj_unet_dim)
        prepared = shard_prepared(prepared, shard)
    else:
        sync_batch_norm(model, data)
    loss = update_step(model, make_optimizer(cfg, model.parameters()), cfg, prepared, DRYRUN_LR, data, shard)
    return {"mesh": axes, "loss": float(loss)}


def _part_tp(dev) -> dict:
    """One tensor-parallel training step on {'model': 2} from seed 1's
    weights."""
    from deepfluoro_tpu_torch.parallel import make_mesh, shard_channels
    from deepfluoro_tpu_torch.train.step import make_optimizer, update_step

    cfg = TrainConfig(**DRYRUN)
    mesh = make_mesh({"model": 2})
    model = seeded_model(cfg, 1).to(dev)
    shard_channels(model, mesh.axis("model"))
    batch = dryrun_batch(np.random.default_rng(1), 2, cfg.proj_unet_dim)
    prepared = {k: v.to(dev) for k, v in batch.items()}
    loss = update_step(model, make_optimizer(cfg, model.parameters()), cfg, prepared, DRYRUN_LR)
    return {"mesh": {"model": 2}, "loss": float(loss)}


def _part_ensemble(dev) -> dict:
    """The ensemble forward of 2 members (seeds 2 and 3), one per rank of
    {'ensemble': 2}, on 2 frames."""
    from deepfluoro_tpu_torch.infer.ensemble import ensemble_forward
    from deepfluoro_tpu_torch.parallel import make_mesh

    cfg = TrainConfig(**DRYRUN)
    mesh = make_mesh({"ensemble": 2})
    member = seeded_model(cfg, 2 + mesh.axis("ensemble").index).to(dev).eval()
    proj = dryrun_batch(np.random.default_rng(1), 2, cfg.proj_unet_dim)["proj"].to(dev)
    hw = (cfg.proj_unet_dim,) * 2
    _, heats, labels = ensemble_forward([member], proj, hw, cfg.num_lands, mesh)
    if tuple(labels.shape) != (2, *hw) or not bool(torch.isfinite(heats).all()):
        raise AssertionError("ensemble forward: labels {}, finite heats {}".format(
            tuple(labels.shape), bool(torch.isfinite(heats).all())))
    return {"mesh": {"ensemble": 2}, "labels": labels.cpu().numpy(), "heats": heats.cpu().numpy()}


def dryrun_fold_step(cfg: TrainConfig):
    """JAX ``_dryrun_impl``'s fold step inputs, drawn after the other parts'
    2-frame batch from ``default_rng(1)``: 6 union frames, their labels and
    landmarks, and the (2, 2) grid of each fold's rows; plus the step's
    augmentation (off)."""
    from deepfluoro_tpu_torch.data.augment import AugmentConfig

    h = cfg.proj_unet_dim
    rng = np.random.default_rng(1)
    dryrun_batch(rng, 2, h)
    projs = torch.from_numpy(rng.random((6, h, h)).astype(np.float32))
    segs = torch.from_numpy(rng.integers(0, cfg.num_classes, (6, h, h)).astype(np.uint8))
    lands = torch.from_numpy((rng.random((6, 2, cfg.num_lands)) * h).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 6, (2, 2)))
    return (projs, segs, lands), idx, AugmentConfig(num_classes=cfg.num_classes, proj_pad_dim=h, prob_of_aug=0.0)


def _part_multifold(dev) -> dict:
    """One lockstep step of 2 folds (``fit_multifold``'s initialization
    from seed 4), one per rank of {'ensemble': 2}, augmentation off; the
    folds' losses gathered on every rank."""
    from deepfluoro_tpu_torch.parallel import make_mesh
    from deepfluoro_tpu_torch.parallel.sharding import gather_folds
    from deepfluoro_tpu_torch.train.multifold import _build_models, multifold_step
    from deepfluoro_tpu_torch.train.step import make_optimizer

    cfg = TrainConfig(**DRYRUN, seed=4)
    mesh = make_mesh({"ensemble": 2})
    fold = mesh.axis("ensemble")
    (model,) = _build_models(cfg, 2, dev, keep=[fold.index])
    union, idx, aug = dryrun_fold_step(cfg)
    batch = tuple(t[idx[fold.index]].to(dev) for t in union)
    losses = multifold_step([model], [make_optimizer(cfg, model.parameters())], cfg, aug, None, batch,
                            [DRYRUN_LR], draw_rows=(fold.index * 2, 4))
    losses = gather_folds(losses.tolist(), fold, 2)
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError("multifold losses {}".format(losses))
    return {"mesh": {"ensemble": 2}, "losses": losses}


def _dryrun_rank(parts, n_devices: int, device: str) -> list[dict]:
    """What each rank of ``dryrun_multichip`` runs: ``parts`` in order, each
    with the warp kernel's launches this rank made in it."""
    from deepfluoro_tpu_torch.ops import warp

    dev = _rank_device(device)
    out = []
    for name in parts:
        warp.warp_launches = 0
        if name == "data_spatial":
            result = _part_data_spatial(n_devices, dev)
        else:
            result = {"tp": _part_tp, "ensemble": _part_ensemble, "multifold": _part_multifold}[name](dev)
        result.update(part=name, warp_launches=warp.warp_launches)
        out.append(result)
    return out


def _ok_line(part: dict) -> str:
    mesh = part["mesh"]
    if part["part"] == "ensemble":
        return "dryrun_multichip OK: mesh={} ensemble forward".format(mesh)
    if part["part"] == "multifold":
        return "dryrun_multichip OK: mesh={} multifold step".format(mesh)
    return "dryrun_multichip OK: mesh={} loss={:.6f}".format(mesh, part["loss"])


def rank_backend(dev: torch.device, nprocs: int) -> str:
    """NCCL when every one of ``nprocs`` CUDA ranks has a card of its own;
    gloo when they share cards (NCCL refuses two ranks on one card) or run
    on the CPU."""
    return "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= nprocs else "gloo"


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """Run the four parts (the last three only for ``n_devices`` >= 2) on
    ranks of ``device`` by the module's device rule; print an OK line per
    part and return each part's results on every rank: [{'part', 'mesh',
    'ranks': [per-rank dict with 'loss' or 'losses', 'warp_launches', ...]}].
    Raises when a rank fails or a loss is not finite."""
    dev = get_device(device)
    if n_devices < 1:
        raise ValueError("dryrun_multichip needs at least one rank, got {}".format(n_devices))
    later = ["tp", "ensemble", "multifold"] if n_devices >= 2 else []
    # the later parts run on 2 ranks, as JAX's on devices[:2]
    runs = [(n_devices, ["data_spatial"] + (later if n_devices == 2 else []))]
    if n_devices > 2:
        runs.append((2, later))
    parts = []
    for nprocs, names in runs:
        backend = rank_backend(dev, nprocs)
        per_rank = run_ranks(_dryrun_rank, nprocs, args=(names, n_devices, dev.type), device=dev.type,
                             backend=backend)
        for i, name in enumerate(names):
            ranks = [r[i] for r in per_rank]
            part = {"part": name, "mesh": ranks[0]["mesh"], "backend": backend, "ranks": ranks}
            for r in ranks:
                for loss in [r["loss"]] if "loss" in r else r.get("losses", []):
                    if not np.isfinite(loss):
                        raise AssertionError("{}: loss {} is not finite".format(name, loss))
            print(_ok_line(dict(ranks[0], part=name)), flush=True)
            parts.append(part)
    return parts


if __name__ == "__main__":
    fn, args = entry()
    seg, heats = fn(*args)
    print("entry OK:", {"seg": (tuple(seg.shape), str(seg.dtype)), "heats": (tuple(heats.shape), str(heats.dtype))})
