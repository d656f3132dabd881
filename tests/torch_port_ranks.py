"""What each rank runs in the port's multi-process tests
(``tests/test_torch_port_parallel.py``, ``tests/test_torch_port_multiprocess.py``).

``deepfluoro_tpu_torch.parallel.run_ranks`` starts the ranks with the
``spawn`` method, so each worker imports this module afresh: it imports
torch, numpy and the port, never JAX. Inputs and results cross the process
boundary as numpy arrays and plain values."""

from __future__ import annotations

import numpy as np
import torch

from deepfluoro_tpu_torch.data import hdf5
from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.data.pipeline import BatchIterator
from deepfluoro_tpu_torch.infer import load_net_from_checkpoint, seg_dataset_ensemble
from deepfluoro_tpu_torch.infer.ensemble import ensemble_forward
from deepfluoro_tpu_torch.infer.quantized import int8_forwards
from deepfluoro_tpu_torch.models import UNet
from deepfluoro_tpu_torch.parallel import average_gradients, is_writer, make_mesh, process_index, sync_batch_norm
from deepfluoro_tpu_torch.train import TrainConfig, fit, fit_multifold


def mesh_layouts() -> dict:
    """Axis sizes and indices of the layouts two ranks can take, and the
    error of one they cannot."""
    out = {}
    for name, axes in (("data", {"data": 2}), ("ens_data", {"ensemble": 1, "data": 2}), ("default", None)):
        mesh = make_mesh(axes)
        out[name] = {a: (mesh.axis(a).size, mesh.axis(a).index, mesh.axis(a).group is not None)
                     for a in ("data", "ensemble")}
    try:
        make_mesh({"ensemble": 2, "data": 2})
    except ValueError as e:
        out["error"] = str(e)
    return out


def unet_loss(out, weights):
    """A per-sample scalar of a U-Net output, averaged over the batch: the
    loss whose gradients the BatchNorm checks compare."""
    seg, heats = out
    w_seg, w_heats = weights
    return ((seg * w_seg).sum((1, 2, 3)) + (heats * w_heats).sum((1, 2, 3))).mean()


def sync_bn_unet(flags: dict, state_dict: dict, x: np.ndarray, weights, n_forwards: int) -> dict:
    """This rank's rows of ``n_forwards`` train-mode forwards of the U-Net
    over the global batches ``x`` (n_forwards, B, 1, H, W) with BatchNorm
    synchronized over a 'data' axis of every rank; after the last, the
    loss's gradients averaged over the ranks. Returns the last outputs
    (this rank's rows), the gradients and the state_dict."""
    model = UNet(**flags)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    axis = make_mesh({"data": torch.distributed.get_world_size()}).axis("data")
    sync_batch_norm(model, axis)
    model.train()
    rows = axis.rows(x.shape[1])
    for xi in x:
        out = model(torch.from_numpy(xi[rows]))
    w = tuple(torch.from_numpy(a[rows]) for a in weights)
    loss = unet_loss(out, w)
    loss.backward()
    average_gradients(model.parameters(), loss.detach(), axis)
    return {
        "out": [o.detach().numpy() for o in out],
        "grads": {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None},
        "state": {k: v.numpy() for k, v in model.state_dict().items()},
    }


def dp_fits(runs) -> list:
    """``fit`` on a 'data' mesh of every rank, once per dict of ``runs``:
    source (an archive path), pats, cfg_kw, files and stream_data. Each
    result records which archive rows this rank's ``LazyFluoroReader``
    read, in order."""
    read = []
    take = hdf5.LazyFluoroReader.take

    def recording_take(self, indices):
        read.extend(int(i) for i in np.asarray(indices).reshape(-1))
        return take(self, indices)

    hdf5.LazyFluoroReader.take = recording_take
    mesh = make_mesh({"data": torch.distributed.get_world_size()})
    results = []
    for run in runs:
        read.clear()
        out = fit(run["source"], run["pats"], TrainConfig(**run["cfg_kw"]), verbose=False, device="cpu",
                  stream_data=run.get("stream_data", False), mesh=mesh, **run["files"])
        results.append({
            "train_losses": out["train_losses"],
            "valid_losses": out["valid_losses"],
            "epoch": out["epoch"],
            "train_idx": out["train_idx"],
            "valid_idx": out["valid_idx"],
            "read": list(read),
            "state": {k: v.numpy() for k, v in out["model"].state_dict().items()},
        })
    return results


def folds_fit(source, pats, cfg_kw: dict, prefixes: dict, train_loss_prefix: str) -> dict:
    """``fit_multifold`` on an 'ensemble' mesh of every rank."""
    mesh = make_mesh({"ensemble": torch.distributed.get_world_size()})
    out = fit_multifold(source, pats, TrainConfig(**cfg_kw), train_loss_txt_prefix=train_loss_prefix, verbose=False,
                        device="cpu", mesh=mesh, **prefixes)
    return {
        "folds": out["folds"],
        "train_losses": np.array(out["train_losses"]),
        "valid_losses": np.array(out["valid_losses"]),
        "best_valid_losses": out["best_valid_losses"],
        "epoch": out["epoch"],
    }


def fail_on_rank(bad: int) -> None:
    """Rank ``bad`` raises; the others wait for it at a collective."""
    if process_index() == bad:
        raise ValueError("rank {} fails on purpose".format(bad))
    torch.distributed.all_reduce(torch.zeros(1))


def ensemble_runs(paths, projs: np.ndarray, batch_size: int, calib_batches: int, runs) -> list:
    """For each (mesh axes, quantized, output path) of ``runs``:
    ``seg_dataset_ensemble`` over ``projs`` with this rank's share of the
    members at ``paths`` (process 0 writes the file, the others pass
    None; a file from another process is refused), and the sharded
    forward's mean seg and heats of the first batch. Returns process 0's
    (seg, heats) per run."""
    import h5py

    data = hdf5.FluoroData(projs=projs, segs=None, lands=None, orig_img_shape=projs.shape[1:])
    out = []
    for axes, quantized, path in runs:
        mesh = make_mesh(axes)
        own = paths[mesh.axis("ensemble").rows(len(paths))]
        models = [load_net_from_checkpoint(p, device="cpu", verbose=False)[0] for p in own]
        cfg = load_net_from_checkpoint(own[0], device="cpu", verbose=False)[1]
        kw = dict(num_lands=cfg.num_lands, batch_size=batch_size, pad_img_dim=cfg.proj_unet_dim,
                  num_classes=cfg.num_classes, quantized=quantized, calib_batches=calib_batches, mesh=mesh)
        if is_writer():
            with h5py.File(path, "w") as f:
                seg_dataset_ensemble(data, models, f, **kw)
        else:
            try:
                seg_dataset_ensemble(data, models, object(), **kw)
                raise AssertionError("a process other than 0 wrote the output")
            except ValueError:
                pass
            seg_dataset_ensemble(data, models, None, **kw)

        aug = AugmentConfig(num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.0,
                            include_heat_map=False)
        prep = [prepare_batch(aug, None, b[0])["proj"] for b in BatchIterator(data, batch_size, "cpu").epoch()]
        fwds = int8_forwards(models, prep[:calib_batches]) if quantized else models
        seg, heats, _ = ensemble_forward(fwds, prep[0], projs.shape[1:], cfg.num_lands, mesh)
        out.append((seg.numpy(), heats.numpy()))
    return out if is_writer() else None


def die_on_rank(bad: int) -> None:
    """Rank ``bad`` exits at once, without a result; the others wait."""
    import os
    import time

    if process_index() == bad:
        os._exit(3)
    time.sleep(30)


def halo_cases(x: np.ndarray, w: np.ndarray, k: np.ndarray, modes) -> dict:
    """This rank's band (over a 'spatial' axis of every rank,
    ``row_layout`` of x's rows in whole rows) of ``halo_exchange`` for
    each mode, with the gradient of sum(out * w_band) for the band's rows;
    and ``sharded_conv2d`` (reflect) with the gradients of sum(out * x
    band) for the band and the kernel."""
    from deepfluoro_tpu_torch.parallel.halo import halo_exchange, sharded_conv2d
    from deepfluoro_tpu_torch.parallel.mesh import row_layout

    mesh = make_mesh({"spatial": torch.distributed.get_world_size()})
    axis = mesh.axis("spatial")
    layout = row_layout(x.shape[2], axis.size, 1)
    start = sum(layout[: axis.index])
    rows = slice(start, start + layout[axis.index])
    out = {}
    for mode in modes:
        band = torch.from_numpy(x[:, :, rows]).requires_grad_(True)
        haloed = halo_exchange(band, 1, axis, mode)
        wb = torch.from_numpy(w[:, :, start + 2 * axis.index : start + 2 * axis.index + haloed.shape[2]])
        (haloed * wb).sum().backward()
        out[mode] = (haloed.detach().numpy(), band.grad.numpy())
    band = torch.from_numpy(x[:, :, rows]).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    conv = sharded_conv2d(band, kt, None, axis, "reflect")
    (conv * band.detach()[:, :1]).sum().backward()
    out["conv"] = (conv.detach().numpy(), band.grad.numpy(), kt.grad.numpy())
    return out


def spatial_step(flags: dict, cfg_kw: dict, state_dict: dict, proj, seg, heats, lr: float, axes: dict) -> dict:
    """One ``update_step`` of a U-Net of ``flags`` from ``state_dict`` on
    the global batch (proj (B, 1, P, P), seg (B, C, H, W), heats) over a
    mesh of ``axes``: this rank's data slice, row-sharded over 'spatial'.
    Returns the loss, the parameters and buffers after the step."""
    from deepfluoro_tpu_torch.parallel.mesh import row_shard
    from deepfluoro_tpu_torch.parallel.sharding import shard_rows
    from deepfluoro_tpu_torch.train.step import make_optimizer, shard_prepared, update_step

    model = UNet(**flags)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    cfg = TrainConfig(**cfg_kw)
    mesh = make_mesh(axes)
    data = mesh.axis("data")
    sync_batch_norm(model, data)
    shard = row_shard(mesh, proj.shape[-2], 2 ** (flags["depth"] - 1))
    shard_rows(model, shard)
    rows = data.rows(proj.shape[0])
    prepared = {"proj": torch.from_numpy(proj[rows]), "seg": torch.from_numpy(seg[rows]),
                "heats": None if heats is None else torch.from_numpy(heats[rows])}
    prepared = shard_prepared(prepared, shard)
    opt = make_optimizer(cfg, model.parameters())
    loss = update_step(model, opt, cfg, prepared, lr, data, shard)
    return {"loss": float(loss), "state": {k: v.detach().numpy() for k, v in model.state_dict().items()},
            "layout": (shard.start, shard.stop, shard.counts)}


def spatial_fits(runs) -> list:
    """``fit(shard_spatial=True)`` on a mesh of each run's ``axes``, per
    dict of ``runs``: source, pats, cfg_kw, files, axes, stream_data."""
    results = []
    for run in runs:
        mesh = make_mesh(run["axes"])
        out = fit(run["source"], run["pats"], TrainConfig(**run["cfg_kw"]), verbose=False, device="cpu",
                  stream_data=run.get("stream_data", False), mesh=mesh, shard_spatial=True, **run["files"])
        results.append({"train_losses": out["train_losses"], "valid_losses": out["valid_losses"],
                        "epoch": out["epoch"],
                        "state": {k: v.numpy() for k, v in out["model"].state_dict().items()}})
    return results


def sharded_fullres(flags: dict, state_dicts, projs: np.ndarray, rots: np.ndarray, ds_factor: int, pad: int,
                    axes: dict, batch_size: int) -> dict:
    """On a mesh of ``axes``: ``make_sharded_fullres_infer`` of the first
    net on the frames, and ``fullres_batches`` of the ensemble of all of
    them (process 0's arrays)."""
    from deepfluoro_tpu_torch.data.preprocess import make_sharded_fullres_infer
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches

    def net(sd):
        m = UNet(**flags)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return m.eval()

    mesh = make_mesh(axes)
    infer = make_sharded_fullres_infer(net(state_dicts[0]), ds_factor, pad, projs.shape[1:], mesh)
    labels, heats = infer(torch.from_numpy(projs), torch.from_numpy(rots))
    batches = list(fullres_batches(lambda i0, i1: (projs[i0:i1], rots[i0:i1]), len(projs), projs.shape[1:],
                                   [net(sd) for sd in state_dicts], ds_factor, num_lands=flags["num_lands"],
                                   batch_size=batch_size, pad_img_dim=pad, mesh=mesh))
    return {"labels": labels.numpy(), "heats": heats.numpy(), "batches": batches}


def remat_bn_counts(flags: dict, state_dict: dict, x: np.ndarray) -> dict:
    """One train-mode forward and backward of the U-Net with BatchNorm
    synchronized over a 'data' axis of every rank, with and without
    remat: the BatchNorm buffers after each (the recompute inside
    backward runs the synchronized statistics again)."""
    out = {}
    for remat in (False, True):
        model = UNet(**dict(flags, remat=remat))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
        axis = make_mesh({"data": torch.distributed.get_world_size()}).axis("data")
        sync_batch_norm(model, axis)
        model.train()
        seg, heats = model(torch.from_numpy(x[axis.rows(x.shape[0])]))
        (seg.square().sum() + heats.square().sum()).backward()
        out[remat] = {k: v.numpy() for k, v in model.state_dict().items() if "running" in k or "num_batches" in k}
    return out


def mesh_axes(layouts) -> list:
    """For each mesh of ``layouts``: (size, index, ranks) of its 'data',
    'spatial' and joint axes, and whether each has a group."""
    out = []
    for axes in layouts:
        mesh = make_mesh(axes)
        out.append({name: (a.size, a.index, a.ranks, a.group is not None) for name, a in (
            ("data", mesh.axis("data")), ("spatial", mesh.axis("spatial")),
            ("joint", mesh.joint("data", "spatial")))})
    return out


def run_all(calls) -> list:
    """Several of this module's functions in one set of ranks: ``calls``
    is a list of (function name, args); returns their results in order."""
    import sys

    here = sys.modules[__name__]
    return [getattr(here, name)(*args) for name, args in calls]
