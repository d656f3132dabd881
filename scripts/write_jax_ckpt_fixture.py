#!/usr/bin/env python3
"""Write the JAX checkpoint fixture that ``chip_smoke.py``'s phase 11(a)
loads on the card, where JAX is not installed. Needs the JAX package (and
h5py); runs on the CPU in about a minute:

    JAX_PLATFORMS=cpu python3 scripts/write_jax_ckpt_fixture.py [OUT_DIR]

OUT_DIR defaults to ``tests/fixtures/torch_port/``. It holds:

- ``jax_fit_d6_wf1.msgpack``: the checkpoint the JAX package's ``fit``
  writes after one epoch of the 8x recipe's layout at depth 6, wf 1,
  192^2 input from 180^2 frames (Nesterov SGD with weight decay, so the
  momentum is there; plateau LR, so the scheduler state is; augmentation
  off), on the synthetic archive of ``DATA`` (``make_synthetic_data`` of
  the same arguments gives the same arrays without h5py);
- ``jax_fit_d6_wf1.npz``: what the card is held to: the JAX forward's
  outputs on ``forward_input`` (eval mode, every fourth row and column of
  the softmax seg and the heatmaps), the JAX exporter's state dict
  (``sd/<name>``) and momentum buffers (``mom/<index>``) and param-group
  LR, and the per-step train losses and the validation loss of one more
  epoch of the JAX ``fit`` resumed from the checkpoint.

``tests/test_torch_port_checkpoint_jax.py`` regenerates both and holds
them against the committed files.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_port")
NAME = "jax_fit_d6_wf1"
DATA = dict(num_specimens=2, num_projs=4, img_dim=180, seed=7)
RECIPE = dict(
    num_classes=7, batch_size=2, proj_unet_dim=192, optim_type="sgd", init_lr=0.1, nesterov=True, momentum=0.9,
    wgt_decay=1e-4, lr_sched_meth="plateau", depth=6, init_feats_exp=1, batch_norm=True, padding=True,
    no_max_pool=True, data_aug=False, num_lands=14, heat_coeff=0.5, train_valid_split=0.75, checkpoint_freq=1,
    seed=0, max_num_epochs=1,
)
PATS = [1, 2]
FORWARD_SEED = 11
SUBSAMPLE = 4


def write(out_dir: str = OUT_DIR) -> tuple[str, str]:
    """Run the JAX package and write ``<NAME>.msgpack`` and ``<NAME>.npz``
    into ``out_dir``; returns their paths."""
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    import torch

    from deepfluoro_tpu.compat.torch_import import export_torch_checkpoint
    from deepfluoro_tpu.infer.ensemble import load_net_from_checkpoint
    from deepfluoro_tpu.train.config import TrainConfig
    from deepfluoro_tpu.train.loop import fit
    from deepfluoro_tpu_torch.data.fixtures import write_synthetic_dataset

    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="jax_ckpt_fixture_")
    try:
        archive = write_synthetic_dataset(os.path.join(work, "ds.h5"), **DATA)

        def files(tag):
            return {k: os.path.join(work, "{}_{}".format(tag, v)) for k, v in dict(
                checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
                valid_loss_txt="valid.txt").items()}

        first, resumed = files("first"), files("resumed")
        fit(archive, PATS, TrainConfig(**RECIPE), verbose=False, **first)
        shutil.copy(first["checkpoint_filename"], resumed["checkpoint_filename"])
        fit(archive, PATS, TrainConfig(**dict(RECIPE, max_num_epochs=2)), verbose=False, **resumed)
        train_losses = np.loadtxt(resumed["train_loss_txt"], dtype=np.float64, ndmin=1)
        valid_losses = np.loadtxt(resumed["valid_loss_txt"], dtype=np.float64, ndmin=1)

        model, variables, _ = load_net_from_checkpoint(first["checkpoint_filename"], verbose=False)
        x = np.random.default_rng(FORWARD_SEED).standard_normal((1, 192, 192, 1)).astype(np.float32)
        seg, heats = model.apply(variables, jnp.asarray(x), train=False)
        sub = (slice(None), slice(None), slice(None, None, SUBSAMPLE), slice(None, None, SUBSAMPLE))
        exported = os.path.join(work, "exported.pt")
        export_torch_checkpoint(first["checkpoint_filename"], exported)
        ck = torch.load(exported, map_location="cpu", weights_only=False)

        arrays = {
            "forward_input": x.transpose(0, 3, 1, 2),
            "forward_seg": np.asarray(seg).transpose(0, 3, 1, 2)[sub],
            "forward_heats": np.asarray(heats).transpose(0, 3, 1, 2)[sub],
            "forward_subsample": np.asarray(SUBSAMPLE),
            "resumed_train_losses": train_losses,
            "resumed_valid_losses": valid_losses,
            "param_group_lr": np.asarray(ck["optimizer-state-dict"]["param_groups"][0]["lr"]),
        }
        for k, v in ck["model-state-dict"].items():
            arrays["sd/" + k] = v.numpy()
        for i, entry in ck["optimizer-state-dict"]["state"].items():
            arrays["mom/{}".format(i)] = entry["momentum_buffer"].numpy()
        ck_path = os.path.join(out_dir, NAME + ".msgpack")
        npz_path = os.path.join(out_dir, NAME + ".npz")
        shutil.copy(first["checkpoint_filename"], ck_path)
        np.savez(npz_path, **arrays)
        return ck_path, npz_path
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    for p in write(sys.argv[1] if len(sys.argv) > 1 else OUT_DIR):
        print(p, os.path.getsize(p))
