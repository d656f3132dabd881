"""Cells of several cards: one process per card, joined by
``torch.distributed`` (NCCL on the cards, gloo on the CPU), started and
waited for by the port's ``parallel/multihost.py::run_ranks``.

Each rank runs the cell's runner on its own card, as ``fit(mesh=...)``
expects of a multi-process run, with one intra-op thread. Set-up counts
from the start of the process that launched the ranks (``wall_start``,
the host's wall clock, which every process shares). Rank 0 checks and
makes the result line; the launcher merges into it what only all the
ranks know: the peak memory of the fullest card and the busy time
averaged over the cards. A rank that fails, or a run that outlives its
deadline, stops every rank and raises.
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from fluorobench import faults, harness

# the first run of a cell in a checkout builds the kernels and may take
# 1200 s; a run that outlives this has hung
DEADLINE_S = 1140.0


def rank_main(cell, seeds, seconds, trace, wall_start, fault, control):
    """One rank: the cell on this process's card for each seed in turn.
    Returns one report a seed: every rank's peak memory, busy time and
    forbidden modules, and rank 0's ``summary`` (``err``, ``line``), its
    run without the check's inputs (``run``) and, with ``control``, its
    ``control_line`` (``control``), which it also prints."""
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.set_num_threads(1)  # the ranks share the host's cores
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    runner = harness.load_runner(cell)
    reports = []
    for seed in seeds:
        run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, chips=world, rank=rank,
                          t_start=time.perf_counter() - (time.time() - wall_start))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with faults.planted(fault, runner):
            runner.main(run)
        report = {"rank": rank, "peak": run.memory_peak_bytes,
                  "busy_s": None if run.trace_summary is None else run.trace_summary.busy_s,
                  "forbidden": harness.loaded_forbidden()}
        if rank == 0:
            report.update(harness.summary(run))
            if control:
                report["control"] = harness.control_line(run, runner, fault)
                print(json.dumps(report["control"]), flush=True)
            run.check_inputs = {}
            report["run"] = run
        reports.append(report)
        wall_start = time.time()
    return reports


def merge(reports: list, chips: int) -> dict:
    """One seed's reports of every rank as rank 0's, with the result line's
    ``device`` made the run's: ``count`` its cards, ``memory_peak_bytes``
    the fullest card's, ``busy_s`` the mean over the cards; ``forbidden``
    what any rank loaded."""
    head = next(r for r in reports if r["rank"] == 0)
    device = head["line"]["device"]
    device["count"] = chips
    device["memory_peak_bytes"] = max(r["peak"] for r in reports)
    busy = [r["busy_s"] for r in reports if r["busy_s"] is not None]
    if "busy_s" in device and busy:
        device["busy_s"] = sum(busy) / len(busy)
    ranks = "; ".join("rank {}: peak {} bytes, busy {} s".format(r["rank"], r["peak"], r["busy_s"])
                      for r in sorted(reports, key=lambda r: r["rank"]))
    return dict(head, err=[ranks] + head["err"],
                forbidden=sorted({m for r in reports for m in r["forbidden"]}))


def launch(cell, seeds, seconds: float, trace: bool, wall_start: float, fault=None, control: bool = False,
           device: str = "cuda", timeout: float = DEADLINE_S) -> list:
    """Run ``cell`` (``cell.chips`` ranks on ``device``) once for each seed
    and return each seed's merged report. Raises RuntimeError when a rank
    fails and TimeoutError after ``timeout`` seconds, every rank stopped."""
    from deepfluoro_tpu_torch.parallel.multihost import run_ranks

    per_rank = run_ranks(rank_main, cell.chips, args=(cell, list(seeds), seconds, trace, wall_start, fault, control),
                         device=device, timeout=timeout)
    return [merge([reports[i] for reports in per_rank], cell.chips) for i in range(len(seeds))]
