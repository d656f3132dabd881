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
