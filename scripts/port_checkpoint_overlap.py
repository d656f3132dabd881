#!/usr/bin/env python3
"""How the port's checkpoint writes interact with training steps on one
CUDA card.

    python3 scripts/port_checkpoint_overlap.py

Runs ``deepfluoro_tpu_torch``'s ``fit`` on ``chip_smoke.py``'s full-width
8x recipe and synthetic data for 3 epochs (checkpoint and best net every
epoch) six times, in turns, with three ways of writing the checkpoints:

  side    ``AsyncCheckpointer`` as shipped: the worker thread copies the
          device snapshot into pinned memory on a side stream, then saves;
  inline  the worker moves the snapshot to the host with ``.cpu()`` on the
          default stream (pageable memory), then saves;
  sync    every save runs on the training thread before the next epoch.

Prints the card's name and power limit, then per run each epoch's steps/s
after its first step and ``fit``'s wall time. Run from the repository root.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepfluoro_tpu_torch.train import fit  # noqa: E402
from deepfluoro_tpu_torch.train.checkpoint import AsyncCheckpointer  # noqa: E402

ORDER = ["side", "inline", "sync", "sync", "inline", "side"]
EPOCHS = 3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    side_to_host, submit = AsyncCheckpointer._to_host, AsyncCheckpointer._submit
    variants = {
        "side": (side_to_host, submit),
        "inline": (lambda self, snapshot, done, device: (done.synchronize(), snapshot)[1], submit),
        "sync": (side_to_host, lambda self, fn, *args: fn(*args)),
    }
    data = cs._smoke_data(0)
    for name in ORDER:
        AsyncCheckpointer._to_host, AsyncCheckpointer._submit = variants[name]
        workdir = tempfile.mkdtemp()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fit(data, [2, 3, 4, 5, 6], cs._recipe_cfg(data, 0, max_num_epochs=EPOCHS), verbose=False,
                      device="cuda", checkpoint_filename=os.path.join(workdir, "ck.pt"),
                      best_valid_filename=os.path.join(workdir, "best.pt"),
                      train_loss_txt=os.path.join(workdir, "train.txt"),
                      valid_loss_txt=os.path.join(workdir, "valid.txt"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(workdir)
        per_epoch = len(out["step_seconds"]) // EPOCHS
        rates = [(per_epoch - 1) / sum(out["step_seconds"][e * per_epoch + 1:(e + 1) * per_epoch])
                 for e in range(EPOCHS)]
        print("{:6s} steps/s per epoch after its first step {} ; fit wall {:.2f} s".format(
            name, ["%.3f" % r for r in rates], wall), flush=True)
    AsyncCheckpointer._to_host, AsyncCheckpointer._submit = side_to_host, submit


if __name__ == "__main__":
    main()
