#!/usr/bin/env python3
"""Per-rank rates of ``chip_smoke.py``'s row-sharded paths (phase 11(b)-
(d)) for several source trees, in turns, on one CUDA card:

    python3 scripts/port_spatial_ab.py TREE [TREE ...] [--rounds N] [--seed N]

Each TREE is a checkout of the repository (say the parent commit unpacked
with ``git archive`` under ``build/``, and ``.``). Per round, every tree
runs in a fresh process from its own root: its ``chip_smoke.py`` builds
the warp kernel, makes phase 8's 1x member (a seeded member padded to
1440) and runs its phase-11 ranks (two gloo ranks on ``cuda:0``,
{'spatial': 2}, deterministic cuDNN): the 8x recipe's ``fit`` for 2
epochs, the 2x rung for 1 epoch, 1x full-res inference over two raw
frames. Rounds visit the trees in order, then in reverse (A B B A), so a
drift of the host favours neither. Prints the card's name and power
limit, then per run and tree the steps/s per rank of the two fits (after
each one's first step) and the frames/s of the inference, and the median
of each over the runs. Run from the repository root.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile


def child(seed):
    """One tree's run, in a process started from the tree's root: its own
    ``chip_smoke.py`` and package."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from deepfluoro_tpu_torch.ops._build import load_library
    from deepfluoro_tpu_torch.parallel.multihost import Ranks
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    workdir = tempfile.mkdtemp(prefix="spatial_ab_")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library("affine_warp")
    data = cs._smoke_data(seed)
    pad = cs.FULLRES_RUNGS[-1][2]
    cfg = cs._recipe_cfg(data, seed, proj_unet_dim=pad)
    path = os.path.join(workdir, "fullres_1x.pt")
    save_checkpoint(path, cfg, cs._seeded_member(cfg, seed + 3, torch.randn(1, 1, pad, pad, device="cuda")))
    settings = {k: getattr(cs, k) for k in cs.SPATIAL_SETTINGS}
    go = os.path.join(workdir, "go")
    open(go, "w").close()
    got = Ranks(cs._rank_spatial, 2, args=(seed, workdir, path, settings, go), device="cuda",
                backend="gloo").results(900)

    def rate(s):
        return len(s[1:]) / sum(s[1:])

    print("RESULT " + json.dumps({"8x_steps_per_s": [rate(r["b"]["step_seconds"]) for r in got],
                                  "2x_steps_per_s": [rate(r["c"]["step_seconds"]) for r in got],
                                  "1x_frames_per_s": got[0]["d"]["fps"]}), flush=True)


def run_tree(tree, seed):
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", str(seed)], cwd=tree,
                         capture_output=True, text=True, timeout=1200)
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError("{} gave no result:\n{}\n{}".format(tree, out.stdout[-4000:], out.stderr[-4000:]))


def main(argv=None):
    if argv is None and sys.argv[1:2] == ["--child"]:
        return child(int(sys.argv[2]))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="+", help="repository checkouts to time, each from its own root")
    p.add_argument("--rounds", type=int, default=2, help="rounds; odd rounds visit the trees in reverse")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("card: {}".format(card), flush=True)
    runs = {t: [] for t in args.trees}
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else list(reversed(args.trees))):
            res = run_tree(os.path.abspath(tree), args.seed)
            runs[tree].append(res)
            print("round {} {}: {}".format(r, tree, json.dumps(res)), flush=True)
    for tree, rs in runs.items():
        med = {k: statistics.median(v if isinstance(v, float) else min(v) for v in (x[k] for x in rs))
               for k in rs[0]}
        print("median {} ({} runs; the slower rank of each run): {}".format(tree, len(rs), json.dumps(med)),
              flush=True)


if __name__ == "__main__":
    main()
