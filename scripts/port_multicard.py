#!/usr/bin/env python3
"""The port's parallel paths across several CUDA cards of one host, NCCL
(the default backend), one process per card, against one process.

    python3 scripts/port_multicard.py [--seed N]

Needs two or more cards; uses all of them (N). Float32, TF32 off,
deterministic cuDNN in every process. Three runs, each against the same
run in one process on card 0:

  data     ``fit`` of ``chip_smoke.py``'s 8x recipe, augmentation on, 2
           epochs, on a {'data': N} mesh at global batch 5 N (5 frames per
           card); 5 training specimens of 4 N frames, so every global
           batch splits evenly, and one validation specimen. Losses: the
           first epoch within 1e-4 relative, both within 1e-3 (as
           ``chip_smoke.py`` phase 10(b)); buffers equal across ranks; one
           warp launch per step per rank. Steps/s per rank, beside one
           process at batch 5 N and at batch 5.
  folds    ``fit_multifold``, K = 6 folds of ``chip_smoke.py``'s data, 1
           epoch, augmentation on, on an {'ensemble': E} mesh, E the
           largest divisor of 6 up to N: every fold within 1e-3 relative;
           lockstep steps/s per rank beside one process's.
  ensemble K = 6 seeded members (``chip_smoke.py``'s ``_seeded_member``)
           on an {'ensemble': 2, 'data': N / 2} mesh (N even) over 256
           frames of 180^2 at batch 64: labels and heats of
           ``ensemble_batches`` against one process (heats within 1e-5,
           labels differing on < 0.1 %), frames/s by the --times contract
           beside one process's.
  spatial  (four or more cards: the first four) the 2x rung (718^2 ->
           736^2, ``chip_smoke.py``'s ``LADDER``) with bf16, remat and the
           streamed feed, augmentation on, 1 epoch, on a {'data': 2,
           'spatial': 2} mesh at global batch 10 (bands 384 + 352, NCCL
           halo exchanges), against one card at batch 10: losses within
           5e-3 relative (the bf16 tolerance), one warp launch per step
           per rank; steps/s and peak memory less baseline per rank beside
           one card's. Then a seeded 1x member (1440^2 padded input)
           over raw 1536^2 frames through ``fullres_batches`` on a
           {'spatial': 4} mesh (bands 384 + 352 + 352 + 352) against one
           card: labels differing on < 0.1 % of pixels, heats within
           1e-4; frames/s and peaks beside one card's.

Prints the cards' names and power limits, one line per run, and a
summary JSON as the last line. Run from the repository root.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PER_CARD_BATCH = 5
FRAMES = 256
BATCH = 64
SPATIAL_BATCH = 10  # the 2x rung's global batch on {'data': 2, 'spatial': 2}: 5 frames per data slice
SPATIAL_FRAMES = 46  # 2x frames: 40 train (four global batches), 6 validation
FULLRES_FRAMES = 16  # raw 1x frames through the {'spatial': 4} ensemble
FULLRES_BATCH = 2


def _data(seed, n_cards):
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data

    return make_synthetic_data(num_specimens=6, num_projs=4 * n_cards, img_dim=cs.TRAIN_FRAME, seed=seed)


def _fit(seed, workdir, tag, n_cards, batch, mesh=None):
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import fit

    data = _data(seed, n_cards)
    cfg = cs._recipe_cfg(data, seed, max_num_epochs=2, batch_size=batch, train_valid_split=-1.0)
    warp.warp_launches = 0
    out = fit(data, [2, 3, 4, 5, 6], cfg, valid_pats=[1], verbose=False, device=cs.DEVICE, mesh=mesh,
              **cs._fit_files(workdir, tag))
    cs._sync()
    sec = out["step_seconds"][1:]
    return {"train": out["train_losses"], "valid": out["valid_losses"], "steps": len(out["train_losses"]),
            "launches": warp.warp_launches, "steps_per_s": len(sec) / sum(sec),
            "bn": {k: v.cpu().numpy() for k, v in out["model"].state_dict().items() if k.endswith("running_var")}}


def rank_data(seed, workdir, settings, n_cards):
    from deepfluoro_tpu_torch.parallel import make_mesh

    cs._rank_setup(True, settings)
    return _fit(seed, workdir, "dp", n_cards, PER_CARD_BATCH * n_cards, make_mesh({"data": n_cards}))


def rank_folds(seed, workdir, settings):
    from deepfluoro_tpu_torch.parallel import make_mesh
    from deepfluoro_tpu_torch.train.multifold import fit_multifold

    cs._rank_setup(True, settings)
    data = cs._smoke_data(seed)
    out = fit_multifold(data, cs.FOLD_PATS, cs._recipe_cfg(data, seed, max_num_epochs=1), verbose=False,
                        device=cs.DEVICE, mesh=make_mesh({"ensemble": torch.distributed.get_world_size()}),
                        checkpoint_prefix=os.path.join(workdir, "mfold_ck"), best_prefix=os.path.join(workdir, "mfold_b"))
    sec = out["step_seconds"][1:]
    return {"train": np.array(out["train_losses"]), "valid": np.array(out["valid_losses"]),
            "steps_per_s": len(sec) / sum(sec)}


def _ensemble(paths, seed, mesh=None):
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.infer import ensemble_batches, load_net_from_checkpoint

    if mesh is not None:
        paths = paths[mesh.axis("ensemble").rows(len(paths))]
    models = [load_net_from_checkpoint(p, device=cs.DEVICE, verbose=False)[0] for p in paths]
    bulk = make_synthetic_data(num_specimens=1, num_projs=FRAMES, img_dim=cs.INFER_FRAME, seed=seed + 4)
    times = []
    out = [(l, h) for _, l, h in ensemble_batches(bulk, models, models[0].num_lands, times, BATCH, cs.TRAIN_PAD,
                                                   mesh=mesh)]
    return {"batches": out, "frames_per_s": len(times) / sum(times)}


def rank_ensemble(paths, seed, settings, axes):
    from deepfluoro_tpu_torch.parallel import make_mesh

    cs._rank_setup(True, settings)
    return _ensemble(paths, seed, make_mesh(axes))


def _spatial_fit(seed, workdir, tag, mesh=None):
    """The 2x rung's ``fit`` (bf16, remat, streamed feed), one epoch at
    global batch SPATIAL_BATCH, row-sharded on ``mesh`` if given."""
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.ops import warp
    from deepfluoro_tpu_torch.train import fit

    _, frame, pad, _, _ = cs.LADDER[0]
    data = make_synthetic_data(num_specimens=1, num_projs=SPATIAL_FRAMES, img_dim=frame, seed=seed + frame)
    cfg = cs._recipe_cfg(data, seed, proj_unet_dim=pad, batch_size=SPATIAL_BATCH, max_num_epochs=1,
                         compute_dtype="bfloat16", remat=True)
    baseline = cs._peak_start()
    warp.warp_launches = 0
    out = fit(data, [1], cfg, verbose=False, device=cs.DEVICE, stream_data=True, mesh=mesh,
              shard_spatial=mesh is not None, **cs._fit_files(workdir, tag))
    cs._sync()
    sec = out["step_seconds"][1:]
    return {"train": out["train_losses"], "valid": out["valid_losses"], "steps": len(out["train_losses"]),
            "launches": warp.warp_launches, "steps_per_s": len(sec) / sum(sec), "peak": cs._peak_since(baseline)}


def rank_spatial(seed, workdir, settings):
    from deepfluoro_tpu_torch.parallel import make_mesh

    cs._rank_setup(True, settings)
    return _spatial_fit(seed, workdir, "sp2x", make_mesh({"data": 2, "spatial": 2}))


def _fullres_1x(seed, member_path, mesh=None):
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data
    from deepfluoro_tpu_torch.infer import load_net_from_checkpoint
    from deepfluoro_tpu_torch.infer.fullres import fullres_batches

    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=FULLRES_FRAMES, img_dim=cs.FULLRES_DIM,
                                       seed=seed + 5)[0]
    model, cfg = load_net_from_checkpoint(member_path, device=cs.DEVICE, verbose=False)
    baseline = cs._peak_start()
    times = []
    out = [(l, h) for _, l, h in fullres_batches(
        lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), FULLRES_FRAMES, spec["projs"].shape[1:], [model],
        1, model.num_lands, times, FULLRES_BATCH, cfg.proj_unet_dim, mesh=mesh)]
    return {"batches": out, "frames_per_s": len(times) / sum(times), "peak": cs._peak_since(baseline)}


def rank_fullres(seed, member_path, settings):
    from deepfluoro_tpu_torch.parallel import make_mesh

    cs._rank_setup(True, settings)
    return _fullres_1x(seed, member_path, make_mesh({"spatial": torch.distributed.get_world_size()}))


def _fullres_member(seed, workdir):
    """A seeded 1x member (``chip_smoke.py``'s ``_seeded_member``, its
    BatchNorm statistics from prepared raw frames), saved."""
    import types

    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_fullres_data
    from deepfluoro_tpu_torch.data.preprocess import make_fullres_prep
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    _, factor, pad, _, batch = cs.FULLRES_RUNGS[-1]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=batch, img_dim=cs.FULLRES_DIM, seed=seed + 6)[0]
    cfg = cs._recipe_cfg(types.SimpleNamespace(num_lands=spec["lands"].shape[-1]), seed, proj_unet_dim=pad)
    prep, _ = make_fullres_prep(factor, pad, spec["projs"].shape[1:])
    calib = prep(torch.from_numpy(spec["projs"]).to(cs.DEVICE), torch.from_numpy(spec["rots"]).to(cs.DEVICE))
    path = os.path.join(workdir, "member_1x.pt")
    save_checkpoint(path, cfg, cs._seeded_member(cfg, seed * 1000 + pad, calib))
    return path


def _spatial_runs(seed, workdir, settings, summary):
    """The 'spatial' runs on the first four cards; returns whether they
    pass."""
    one = _spatial_fit(seed, workdir, "sp2x_one")
    ranks = run_ranks_4(rank_spatial, (seed, workdir, settings))
    rel = max(max(cs._rel(r["train"], one["train"]), cs._rel(r["valid"], one["valid"])) for r in ranks)
    summary["spatial_2x"] = {"mesh": {"data": 2, "spatial": 2}, "global_batch": SPATIAL_BATCH,
                             "steps": ranks[0]["steps"], "warp_launches": [r["launches"] for r in ranks],
                             "max_rel": rel, "steps_per_s_per_rank": [r["steps_per_s"] for r in ranks],
                             "peak_per_rank": [r["peak"] for r in ranks],
                             "one_card_steps_per_s": one["steps_per_s"], "one_card_peak": one["peak"]}
    print("spatial: 2x rung, bf16 + remat + streamed feed, global batch {} on {{'data': 2, 'spatial': 2}}: losses "
          "within {:.2e} relative of one card (<= 5e-3), warp launches {} for {} steps each; steps/s per rank {} "
          "against one card {:.3f}; peaks less baseline per rank {} bytes against one card's {}".format(
              SPATIAL_BATCH, rel, [r["launches"] for r in ranks], ranks[0]["steps"],
              ["%.3f" % r["steps_per_s"] for r in ranks], one["steps_per_s"], [r["peak"] for r in ranks],
              one["peak"]))
    ok = rel <= 5e-3 and all(r["launches"] == r["steps"] for r in ranks)

    member = _fullres_member(seed, workdir)
    want = _fullres_1x(seed, member)
    got = run_ranks_4(rank_fullres, (seed, member, settings))
    heat = max(float(np.abs(g[1] - w[1]).max()) for g, w in zip(got[0]["batches"], want["batches"]))
    differ = float(np.mean(np.concatenate([(g[0] != w[0]).ravel() for g, w in zip(got[0]["batches"],
                                                                                 want["batches"])])))
    summary["spatial_fullres_1x"] = {"mesh": {"spatial": 4}, "frames": FULLRES_FRAMES, "batch": FULLRES_BATCH,
                                     "heats_max_abs": heat, "label_share_differ": differ,
                                     "frames_per_s": got[0]["frames_per_s"], "peak_per_rank": [r["peak"] for r in got],
                                     "one_card_frames_per_s": want["frames_per_s"], "one_card_peak": want["peak"]}
    print("spatial: 1x full-res inference on {{'spatial': 4}}, {} raw {}^2 frames at batch {}: heats within {:.2e} "
          "(<= 1e-4), labels differ on {:.4%} (< 0.1 %); {:.3f} frames/s against one card {:.3f}; peaks less "
          "baseline per rank {} bytes against one card's {}".format(
              FULLRES_FRAMES, cs.FULLRES_DIM, FULLRES_BATCH, heat, differ, got[0]["frames_per_s"],
              want["frames_per_s"], [r["peak"] for r in got], want["peak"]))
    return ok and heat <= 1e-4 and differ < 1e-3


def run_ranks_4(fn, args):
    from deepfluoro_tpu_torch.parallel import run_ranks

    return run_ranks(fn, 4, args=args, device=cs.DEVICE, timeout=1200)


def _members(seed, workdir):
    from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
    from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint

    data = cs._smoke_data(seed)
    cfg = cs._recipe_cfg(data, seed)
    frames = make_synthetic_data(num_specimens=1, num_projs=cs.CHECK_FRAMES, img_dim=cs.INFER_FRAME, seed=seed + 1)
    calib = prepare_batch(AugmentConfig(proj_pad_dim=cs.TRAIN_PAD, prob_of_aug=0.0), None,
                          torch.from_numpy(frames.projs).to(cs.DEVICE))["proj"]
    paths = []
    for i in range(cs.ENSEMBLE_K):
        paths.append(os.path.join(workdir, "member_{}.pt".format(i)))
        save_checkpoint(paths[-1], cfg, cs._seeded_member(cfg, seed * 1000 + i, calib))
    return paths


def main(argv=None) -> int:
    from deepfluoro_tpu_torch.parallel import run_ranks

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("all", "spatial"), default="all",
                        help="run every path, or only the spatial runs")
    args = parser.parse_args(argv)
    n = torch.cuda.device_count() if cs.DEVICE == "cuda" else 4
    if n < 2:
        print("port_multicard: needs two or more CUDA cards, found {}".format(n), file=sys.stderr)
        return 1
    if cs.DEVICE == "cuda":
        print(cs._run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    cs._rank_setup(True)
    settings = {k: getattr(cs, k) for k in cs.SPATIAL_SETTINGS}
    workdir = tempfile.mkdtemp(prefix="port_multicard_")
    summary = {"cards": n}
    if args.only == "spatial":
        if n < 4:
            print("port_multicard: the spatial runs need four cards, found {}".format(n), file=sys.stderr)
            return 1
        ok = _spatial_runs(args.seed, workdir, settings, summary)
        print(json.dumps(summary))
        return 0 if ok else 1

    one = _fit(args.seed, workdir, "one", n, PER_CARD_BATCH * n)
    small = _fit(args.seed, workdir, "small", n, PER_CARD_BATCH)
    t0 = time.perf_counter()
    ranks = run_ranks(rank_data, n, args=(args.seed, workdir, settings, n), device=cs.DEVICE, timeout=1200)
    wall = time.perf_counter() - t0
    epoch = one["steps"] // 2
    first, rel = (max(v) for v in zip(*(cs._fit_rel(r, {"train_losses": one["train"], "valid_losses": one["valid"]},
                                                    epoch) for r in ranks)))
    bn_equal = all(np.array_equal(ranks[0]["bn"][k], r["bn"][k]) for r in ranks for k in ranks[0]["bn"])
    summary["data"] = {"global_batch": PER_CARD_BATCH * n, "steps": ranks[0]["steps"],
                       "warp_launches": [r["launches"] for r in ranks], "max_rel_first_epoch": first,
                       "max_rel": rel, "bn_equal": bn_equal,
                       "steps_per_s_per_rank": [r["steps_per_s"] for r in ranks],
                       "one_process_steps_per_s_same_batch": one["steps_per_s"],
                       "one_process_steps_per_s_batch_5": small["steps_per_s"], "wall_s": wall}
    print("data: {} ranks at global batch {}: losses first epoch {:.2e} (<= 1e-4), both {:.2e} (<= 1e-3), buffers "
          "equal {}, warp launches {} for {} steps each; steps/s per rank {} against one process {:.3f} at the same "
          "batch and {:.3f} at batch {}".format(
              n, PER_CARD_BATCH * n, first, rel, bn_equal, [r["launches"] for r in ranks], ranks[0]["steps"],
              ["%.3f" % r["steps_per_s"] for r in ranks], one["steps_per_s"], small["steps_per_s"], PER_CARD_BATCH))
    ok = first <= 1e-4 and rel <= 1e-3 and bn_equal and all(r["launches"] == r["steps"] for r in ranks)

    e = max(d for d in (1, 2, 3, 6) if d <= n)
    from deepfluoro_tpu_torch.train.multifold import fit_multifold

    data = cs._smoke_data(args.seed)
    ref = fit_multifold(data, cs.FOLD_PATS, cs._recipe_cfg(data, args.seed, max_num_epochs=1), verbose=False,
                        device=cs.DEVICE, checkpoint_prefix=os.path.join(workdir, "rf_ck"),
                        best_prefix=os.path.join(workdir, "rf_b"))
    sec = ref["step_seconds"][1:]
    folds = run_ranks(rank_folds, e, args=(args.seed, workdir, settings), device=cs.DEVICE, timeout=1200)
    rel = max(max(cs._rel(r["train"], np.array(ref["train_losses"])), cs._rel(r["valid"], np.array(ref["valid_losses"])))
              for r in folds)
    summary["folds"] = {"ranks": e, "max_rel": rel, "steps_per_s_per_rank": [r["steps_per_s"] for r in folds],
                        "one_process_steps_per_s": len(sec) / sum(sec)}
    print("folds: K = {} over {} ranks: every fold within {:.2e} relative (<= 1e-3); lockstep steps/s per rank {} "
          "against one process {:.3f}".format(len(cs.FOLD_PATS), e, rel, ["%.3f" % r["steps_per_s"] for r in folds],
                                             len(sec) / sum(sec)))
    ok = ok and rel <= 1e-3

    if n % 2 == 0:
        paths = _members(args.seed, workdir)
        want = _ensemble(paths, args.seed)
        axes = {"ensemble": 2, "data": n // 2}
        got = run_ranks(rank_ensemble, n, args=(paths, args.seed, settings, axes), device=cs.DEVICE, timeout=1200)[0]
        heat = max(float(np.abs(g[1] - w[1]).max()) for g, w in zip(got["batches"], want["batches"]))
        differ = float(np.mean(np.concatenate([(g[0] != w[0]).ravel() for g, w in zip(got["batches"], want["batches"])])))
        summary["ensemble"] = {"mesh": axes, "heats_max_abs": heat, "label_share_differ": differ,
                               "frames_per_s": got["frames_per_s"], "one_process_frames_per_s": want["frames_per_s"]}
        print("ensemble: K = {} on {}: heats within {:.2e} (<= 1e-5), labels differ on {:.4%} (< 0.1 %); {:.1f} "
              "frames/s against one process {:.1f} at batch {}".format(
                  cs.ENSEMBLE_K, axes, heat, differ, got["frames_per_s"], want["frames_per_s"], BATCH))
        ok = ok and heat <= 1e-5 and differ < 1e-3
    if n >= 4:
        ok = _spatial_runs(args.seed, workdir, settings, summary) and ok
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
