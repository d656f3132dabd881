"""Processes of a multi-card run (JAX counterpart: ``deepfluoro_tpu/
parallel/multihost.py``).

The port runs one process per card and joins them with
``torch.distributed``: NCCL by default on CUDA, gloo on the CPU or when
the caller names it. Host-side duties here:

- ``initialize`` joins the process group from the CLIs' flags
  (``--num-processes/--process-id/--coordinator``) or from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
  a run of one process stays a plain process;
- ``local_shard_indices`` and ``local_batch_slice``, bit-equal to the JAX
  package's: every process derives the same global order from a shared
  seed and takes its part of it;
- ``run_ranks`` (``Ranks``) starts the local workers that ``--dp-devices
  N`` (and the other parallel flags) ask for without process flags, one
  per card, and raises when any of them fails or outlives its time limit;
- process 0 is the single writer of files (``is_writer``);
- ``launch`` is the CLIs' choice between those.
"""

from __future__ import annotations

import math
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Process 0 alone writes checkpoints, logs and output files."""
    return process_index() == 0


def _init_method(coordinator_address: str | None) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``, ``file://``)
    as it is; None -> ``env://`` (``MASTER_ADDR``/``MASTER_PORT``)."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return "tcp://" + coordinator_address


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the process group of a multi-process run; a no-op for one
    process. Returns whether this process is one of several.

    Without ``num_processes`` > 1 the ``torchrun`` environment decides
    (``WORLD_SIZE``, ``RANK``, rendezvous by ``env://``). ``backend``
    defaults to NCCL for a CUDA ``device`` and gloo for the CPU; a CUDA
    process takes card ``LOCAL_RANK`` (else ``process_id`` modulo the
    card count) as its current device before it joins."""
    env = os.environ
    if num_processes is None or num_processes <= 1:
        if int(env.get("WORLD_SIZE", "1")) <= 1:
            return False
        num_processes, process_id, init = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    else:
        if process_id is None or not 0 <= process_id < num_processes:
            raise ValueError("--process-id must lie in [0, {}), got {}".format(num_processes, process_id))
        init = _init_method(coordinator_address)
    _join(init, num_processes, process_id, backend, device)
    return True


def _join(init_method: str, world: int, rank: int, backend: str | None, device) -> None:
    dev_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)


def local_shard_indices(n_examples: int, seed: int, epoch: int, rank: int | None = None,
                        world: int | None = None) -> np.ndarray:
    """Disjoint shuffled index shard of process ``rank`` of ``world``
    (default: this process of the group). Every process derives the same
    permutation from (seed, epoch), truncated to a multiple of ``world``
    (drop-tail, so every shard has the same size), and strides over it by
    rank."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    rng = np.random.default_rng((seed << 20) ^ epoch)
    perm = rng.permutation(n_examples)
    n_even = (n_examples // world) * world
    assert n_even > 0, "dataset of {} examples cannot feed {} processes".format(n_examples, world)
    return perm[:n_even][rank::world]


def local_batch_slice(global_idx: np.ndarray, rank: int | None = None, world: int | None = None) -> np.ndarray:
    """Process ``rank``'s contiguous slice of one global batch's index list:
    rows ``[rank * b/world, (rank + 1) * b/world)``. Contiguous slices keep
    the multi-process run sample for sample equal to one process: the
    global batch is the same, and each process computes its part of it.
    Every process must hold the same ``global_idx``, of a length that
    divides by ``world``."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    b = int(global_idx.shape[0])
    assert b % world == 0, "global batch of {} does not split over {} processes".format(b, world)
    bl = b // world
    return global_idx[rank * bl : (rank + 1) * bl]


def _rank_entry(fn, rank, nprocs, init_method, backend, device, args, results):
    """A worker of ``run_ranks``: join the group (of one, too), run
    ``fn(*args)``, report (rank, ok, result or traceback) on ``results``."""
    try:
        if torch.device(device).type == "cpu":
            # several workers share the host's cores; torch's default thread
            # count in each makes their OpenMP threads spin against each other
            torch.set_num_threads(1)
        _join(init_method, nprocs, rank, backend, device)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``nprocs`` new local processes (``spawn``), started here, each
    running ``fn(*args)`` as rank r of a process group joined through a
    file store in a fresh temporary directory; on CUDA rank r takes card r
    modulo the card count. ``fn``, ``args`` and the results are pickled
    (module-level functions only). ``results`` waits for them; ``close``
    stops and joins whatever still runs (``results`` does so itself)."""

    def __init__(self, fn, nprocs: int, args=(), device: str | torch.device = "cuda", backend: str | None = None):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.nprocs = nprocs
        self._queue = ctx.Queue()
        self._store_dir = tempfile.mkdtemp(prefix="deepfluoro_ranks_")
        init_method = "file://" + os.path.join(self._store_dir, "store")
        self._procs = [ctx.Process(target=_rank_entry,
                                   args=(fn, r, nprocs, init_method, backend, str(device), args, self._queue))
                       for r in range(nprocs)]
        self._done = False
        for p in self._procs:
            p.start()

    def results(self, timeout: float | None = 3600.0) -> list:
        """Each rank's result, in rank order. Raises RuntimeError with the
        worker's traceback when any rank fails or exits without a result,
        and TimeoutError after ``timeout`` seconds (None: no deadline, as
        long as the ranks live); either way every worker is stopped and
        joined first."""
        out: dict[int, object] = {}
        deadline = math.inf if timeout is None else time.monotonic() + timeout
        try:
            while len(out) < self.nprocs:
                try:
                    rank, ok, value = self._queue.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError("{} of {} ranks did not finish within {} s".format(
                            self.nprocs - len(out), self.nprocs, timeout)) from None
                    dead = [r for r, p in enumerate(self._procs) if r not in out and p.exitcode is not None]
                    if dead:
                        # a last message may have landed since the get timed out
                        time.sleep(1.0)
                        if self._queue.empty():
                            raise RuntimeError("rank {} exited with code {} and no result".format(
                                dead[0], self._procs[dead[0]].exitcode)) from None
                    continue
                if not ok:
                    raise RuntimeError("rank {} of {} failed:\n{}".format(rank, self.nprocs, value))
                out[rank] = value
        finally:
            self.close()
        return [out[r] for r in range(self.nprocs)]

    def close(self) -> None:
        """Stop the workers that still run (after ``results`` none do), join
        every one, remove the store. Idempotent."""
        if self._done:
            return
        self._done = True
        for p in self._procs:
            if p.is_alive():
                p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        self._queue.close()
        for name in os.listdir(self._store_dir):
            os.remove(os.path.join(self._store_dir, name))
        os.rmdir(self._store_dir)


def run_ranks(fn, nprocs: int, args=(), device: str | torch.device = "cuda", backend: str | None = None,
              timeout: float | None = 3600.0) -> list:
    """``Ranks(fn, nprocs, args, device, backend).results(timeout)``: run
    ``fn(*args)`` in ``nprocs`` local ranks and return their results."""
    return Ranks(fn, nprocs, args, device, backend).results(timeout)


def local_device_count(device: str | torch.device) -> int:
    """What a parallel flag's 0 ("all devices") means here: the card count
    on CUDA, one process on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def launch(run, args, n_local: int, num_processes: int = 0, process_id: int | None = None,
           coordinator: str | None = None, device: str | torch.device = "cuda"):
    """The CLIs' process layout. Under ``--num-processes`` > 1 or
    ``torchrun``'s environment this process joins the group and runs
    ``run(args)``; otherwise ``n_local`` > 1 runs it in that many local
    workers (``run_ranks``, with no deadline: a recipe trains for hours
    per fold, and a rank that dies or fails still stops the run), and 1
    runs it here alone. Returns process 0's result (here: this
    process's)."""
    if (num_processes or 0) > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize(coordinator, num_processes, process_id, device=device)
        try:
            return run(args)
        finally:
            dist.destroy_process_group()
    if n_local > 1:
        return run_ranks(run, n_local, args=(args,), device=device, timeout=None)[0]
    return run(args)
