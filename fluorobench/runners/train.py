"""Training cells: the recipe through ``deepfluoro_tpu_torch.train.loop.
fit`` on a resident synthetic archive.

Set-up makes the archive (``traffic/specimens.py``) and the weights
(``weights.py``) from the seed and writes the weights as the fold's
starting checkpoint in the run's temporary directory (with the train/valid
split, drawn from the seed). One ``fit`` call then resumes from that file
and runs the whole run: its first ``warmup_epochs`` epochs are set-up, and
the window opens at the first step after them (the harness wraps ``fit``'s
calls of ``train_step``). From there ``fit`` trains whole epochs until the
next would overrun the window (``max_hours``, set when the window opens);
the window's wall time holds the epochs' steps, validation, and the
checkpoint write on exit.

A cell of several cards runs one such process per card (``ranks.py``),
data-parallel over ``{'data': chips}`` with the configuration's batch on
each card: one ``fit(mesh=...)`` call a process, BatchNorm over the global
batch, one warp launch a step on each card; rank 0 reports and checks,
against the reference stepping the global batch.

``correct`` follows two stretches of ``checked_steps`` steps of that one
``fit`` call: ``start``, its first steps from the seeded weights, and
``window``, the first steps of the window's epoch ``checked_epoch``: timed
steps, past every warm-up. The harness records each step's raw batch and
the augmentation generator's state (the program's draws are regenerated
from it), the weights and momentum before the first step, the momentum
after it (the gradient as SGD takes it, weight decay included) and the
weights after the last. The float64 reference follows the same steps from
the same weights and momentum: the seed's at ``start``, the program's own
state at ``window`` (PERF.md section 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from fluorobench import counts, weights
from fluorobench.harness import Trace, card_power_limit, relative_gap
from fluorobench.reference import train as ref_train
from fluorobench.reference.unet import Numerics
from fluorobench.traffic.specimens import make_archive

REFERENCE = Numerics(torch.float64)
CONTROL = Numerics(torch.float32, tf32=True)


def faults(cell) -> list[str]:
    """The planted faults a training cell can have (``faults.py``)."""
    return ["unchanged", "half_batch"] + (["no_exchange"] if cell.chips > 1 else [])


def test_size(cell):
    """The cell cut to what the CPU runs in seconds (depth 2, wf 2, frames
    of 32^2 padded to 36, six frames a specimen for each card), and its
    window's seconds: enough to hold the checked epoch, the second after
    the warm-up, at 40-50 ms a CPU step on one card and 65-120 ms on four
    gloo ranks."""
    cut = dataclasses.replace(
        cell, config=dict(cell.config, depth=2, init_feats_exp=2, frame=32, proj_unet_dim=36),
        traffic=dict(cell.traffic, frames_per_specimen=6 * cell.chips))
    return cut, 2.0 if cell.chips == 1 else 4.0


def train_config(cfg: dict, seed: int, **over):
    from deepfluoro_tpu_torch.train.config import TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw.update(seed=seed, **over)
    return TrainConfig(**kw)


def model_shapes(tcfg):
    """(name -> shape of the program's state dict, parameter names)."""
    from deepfluoro_tpu_torch.train.config import build_model

    with torch.device("meta"):
        model = build_model(tcfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}, [k for k, _ in model.named_parameters()]


@dataclasses.dataclass
class Stretch:
    """Calls ``first`` to ``first + n - 1`` of ``train_step`` in a ``fit``
    call, as recorded."""

    first: int
    n: int
    steps: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    p0: dict | None = None
    buf0: dict = dataclasses.field(default_factory=dict)
    buf1: dict = dataclasses.field(default_factory=dict)
    p_last: dict | None = None

    @property
    def complete(self) -> bool:
        return len(self.steps) == self.n and len(self.losses) == self.n and self.p_last is not None


def momentum(optimizer, params: dict) -> dict:
    return {k: optimizer.state[p]["momentum_buffer"].detach().clone()
            for k, p in params.items() if "momentum_buffer" in optimizer.state.get(p, {})}


class StepRecorder:
    """Wraps ``fit``'s ``train_step``: notes the time of the first call,
    calls ``on_open(cfg)`` (``fit``'s own config) before call ``open_at``,
    and records the stretches."""

    def __init__(self, stretches: dict, open_at: int, on_open):
        self.stretches, self.open_at, self.on_open = stretches, open_at, on_open
        self.calls = 0
        self.t_first = None

    def __enter__(self):
        from deepfluoro_tpu_torch.train import loop

        self._loop, self._orig = loop, loop.train_step
        orig = self._orig

        def step(model, optimizer, cfg, aug_cfg, gen, batch, lr, *args, **kwargs):
            i = self.calls
            self.calls += 1
            if i == 0:
                self.t_first = time.perf_counter()
            if i == self.open_at:
                self.on_open(cfg)
            live = [st for st in self.stretches.values() if st.first <= i < st.first + st.n]
            params = dict(model.named_parameters()) if live else {}
            for st in live:
                if i == st.first:
                    st.p0 = {k: p.detach().clone() for k, p in params.items()}
                    st.buf0 = momentum(optimizer, params)
                st.steps.append({"batch": tuple(None if a is None else a.clone() for a in batch),
                                 "gen_state": gen.get_state(), "lr": float(lr), "aug_cfg": aug_cfg})
            out = orig(model, optimizer, cfg, aug_cfg, gen, batch, lr, *args, **kwargs)
            for st in live:
                if i == st.first:
                    st.buf1 = momentum(optimizer, params)
                if i == st.first + st.n - 1:
                    st.p_last = {k: p.detach().clone() for k, p in params.items()}
            return out

        loop.train_step = step
        return self

    def __exit__(self, *exc):
        self._loop.train_step = self._orig
        return False


def make_data(run):
    """(FluoroData of the training specimens, train indices, valid
    indices) for the run's seed."""
    from deepfluoro_tpu_torch.data.hdf5 import FluoroData

    cfg, tr = run.cfg, run.traffic
    projs, segs, lands, pats = make_archive(run.seed, tr["specimens"], tr["frames_per_specimen"], cfg["frame"],
                                            cfg["num_classes"], cfg["land_names"])
    keep = pats != tr["held_out_specimen"]
    data = FluoroData(projs=projs[keep], segs=segs[keep], lands=lands[keep], orig_img_shape=(cfg["frame"],) * 2,
                      pat_inds=pats[keep])
    n = len(data)
    order = np.random.default_rng(run.seed).permutation(n)
    n_train = int(math.ceil(cfg["train_valid_split"] * n))
    return data, [int(i) for i in order[:n_train]], [int(i) for i in order[n_train:]]


def frames_per_epoch(n_train: int, batch: int, world: int) -> int:
    """The training frames one epoch runs: ``fit`` skips a final global
    batch that does not split evenly over the data axis's ``world`` ranks."""
    tail = n_train % batch
    return n_train - (tail % world and tail)


def main(run) -> None:
    """Set-up, the window and the check of one process: of the cell's only
    card, or (``run.chips`` > 1) of one card of ``run.chips`` joined by
    ``torch.distributed``, training data-parallel over ``{'data': chips}``
    with the configuration's batch on each card. Rank 0 writes the
    starting checkpoint, reports and checks; every rank records its slices
    of the checked steps, which rank 0 gathers into global batches."""
    from deepfluoro_tpu_torch.train.checkpoint import save_checkpoint
    from deepfluoro_tpu_torch.train.config import build_model
    from deepfluoro_tpu_torch.train.loop import fit

    cfg, tr = run.cfg, run.traffic
    world, lead = run.chips, run.rank == 0
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    work = os.path.join(tempfile.gettempdir(), "fluorobench-{}".format(run.cell.name))
    if lead:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
    ck = os.path.join(work, "zz_checkpoint.pt")
    try:
        with run.spans("setup.data"):
            data, train_idx, valid_idx = make_data(run)
        pats = sorted({int(p) for p in data.pat_inds})
        batch, warm = cfg["batch_size"] * world, tr["warmup_epochs"]
        tcfg = train_config(cfg, run.seed, max_num_epochs=warm + tr["max_window_epochs"], batch_size=batch)
        w0 = param_keys = None
        if lead:
            with run.spans("setup.weights"):
                shapes, param_keys = model_shapes(tcfg)
                w0 = weights.make_state(shapes, run.seed, run.device)
                with torch.device("meta"):
                    model = build_model(tcfg)
                model = model.to_empty(device=run.device)
                model.load_state_dict(w0)
                save_checkpoint(ck, tcfg, model, epoch=0, train_idx=train_idx, valid_idx=valid_idx)
                del model
        mesh = None
        if world > 1:
            from deepfluoro_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh({"data": world})
            dist.barrier()  # every rank resumes from rank 0's checkpoint
        per_epoch = frames_per_epoch(len(train_idx), batch, world)
        steps_per_epoch = math.ceil(per_epoch / batch)
        open_at = warm * steps_per_epoch
        n = tr["checked_steps"]
        stretches = {"start": Stretch(0, n), "window": Stretch(open_at + tr["checked_epoch"] * steps_per_epoch, n)}
        clock = {}

        def on_open(fit_cfg):
            # fit counts its session's epochs against max_hours: the warm-up
            # epochs' time plus the window
            t = time.perf_counter()
            run.open_window()
            stack.enter_context(trace)
            clock["t0"] = time.perf_counter()
            clock["open_s"] = clock["t0"] - t
            fit_cfg.max_hours = (clock["t0"] - rec.t_first + run.seconds) / 3600.0

        trace = Trace(run.trace, run.spans)
        rec = StepRecorder(stretches, open_at, on_open)
        files = dict(checkpoint_filename=ck, best_valid_filename=os.path.join(work, "zz_best_valid.pt"),
                     train_loss_txt=os.path.join(work, "train_iter_loss.txt"),
                     valid_loss_txt=os.path.join(work, "valid_loss.txt"), verbose=False, device=run.device)
        with contextlib.ExitStack() as stack, rec:
            res = fit(data, pats, tcfg, mesh=mesh, **files)
            run.sync()
            if "t0" not in clock:
                raise RuntimeError("fit stopped after {} steps, before the window opened at step {}".format(
                    rec.calls, open_at))
            run.window_s = time.perf_counter() - clock["t0"]
        run.trace_summary = trace.summary
        run.values["card"] = card_power_limit()
        for st in stretches.values():
            st.losses = list(res["train_losses"][st.first : st.first + st.n])
        epochs = int(res["epoch"]) - warm
        frames = epochs * per_epoch
        run.attempted = frames
        run.end_to_end["train_frames_per_s"] = frames / run.window_s
        steps = list(res["step_seconds"][open_at:])
        steps[0] -= clock["open_s"]  # the window's first step holds its opening, which falls before it
        run.values.update(step_seconds=steps, epochs=epochs, frames=frames,
                          flops_per_frame=counts.train_step_flops(cfg, cfg["frame"]),
                          warp_bound_s=counts.warp_pair_bound_s(cfg["batch_size"], cfg["frame"],
                                                                counts.pad_size(cfg, cfg["frame"])))
        print("rank {}: {} epochs, {} steps: step median {:.3f} ms, steps {:.3f} s of the window's {:.3f} s".format(
            run.rank, epochs, len(steps), 1e3 * float(np.median(steps)), sum(steps), run.window_s), file=sys.stderr)
        run.read_peak()
        del res
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        if world > 1:
            gather_batches(stretches, world)
        if lead:
            run.check_inputs = dict(w0=w0, param_keys=param_keys, stretches=stretches)
            check(run)
    finally:
        if lead:
            shutil.rmtree(work, ignore_errors=True)


def gather_batches(stretches: dict, world: int) -> None:
    """Replace each recorded step's batch, this rank's slice, by the global
    batch: every rank's slice in rank order (``fit`` hands rank r the
    contiguous rows r * b to (r + 1) * b of each global batch). Every rank
    calls this, with the same stretches."""
    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    for st in stretches.values():
        for step in st.steps:
            step["batch"] = tuple(None if a is None else gather(a) for a in step["batch"])


def replay_steps(stretch: Stretch, device):
    """The recorded steps with the program's draws regenerated from the
    generator states."""
    from deepfluoro_tpu_torch.data.augment import draw_augmentation

    steps = []
    for st in stretch.steps:
        projs = st["batch"][0]
        gen = torch.Generator(device=device)
        gen.set_state(st["gen_state"])
        b, h, w = projs.shape
        steps.append({"batch": st["batch"], "lr": st["lr"], "draws": draw_augmentation(gen, b, h, w, st["aug_cfg"])})
    return steps


def stretch_readings(run, stretch: Stretch, num: Numerics | None) -> tuple[dict, dict]:
    """The compared numbers of one stretch, the program's (with ``num`` the
    control's: the reference at that precision in the program's place)
    against the float64 reference, and their detail."""
    w0, param_keys = run.check_inputs["w0"], run.check_inputs["param_keys"]
    mu = run.cfg["momentum"]
    steps = replay_steps(stretch, run.device)
    state = {**w0, **stretch.p0}
    ref = ref_train.train_steps(state, param_keys, steps, run.cfg, REFERENCE, stretch.buf0)
    if num is not None:
        got = ref_train.train_steps(state, param_keys, steps, run.cfg, num, stretch.buf0)
        losses, buf1, p_last = got["losses"], got["buf1"], got["params"]
    else:
        losses, buf1, p_last = stretch.losses, stretch.buf1, stretch.p_last
    g = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad1"].items()}
    med = float(np.median(list(g.values())))
    moved = [k for k in param_keys if g[k] >= 1e-3 * med]
    # the gradient as SGD takes it: the first step's momentum less the
    # momentum it started from; a leaf the reference's SGD steps and the
    # program's holds no momentum for reads as zeros
    common = [k for k in param_keys if k in ref["buf1"]]

    def taken(bufs, k):
        b = bufs[k].double() if k in bufs else torch.zeros_like(ref["buf1"][k])
        return b - mu * stretch.buf0[k].double() if k in stretch.buf0 else b

    d_got = {k: taken(buf1, k) for k in common}
    d_ref = {k: taken(ref["buf1"], k) for k in common}
    delta = {k: p_last[k].double() - stretch.p0[k].double() for k in moved}
    ref_delta = {k: ref["params"][k] - stretch.p0[k].double() for k in moved}
    loss_gaps = [relative_gap(a, b) for a, b in zip(losses, ref["losses"])]
    grad, change = leaf_gaps(d_got, d_ref, common), leaf_gaps(delta, ref_delta, moved)
    nums = {"loss_gap": max(loss_gaps), "grad_worst_gap": grad["worst"][0][1],
            "delta_worst_gap": change["worst"][0][1]}
    return nums, {"loss_gaps": loss_gaps, "grad": grad, "delta": change}


def readings(run, num: Numerics | None = None) -> dict:
    """Each stretch's compared numbers as ``<stretch>.<number>``, and their
    detail under ``detail``."""
    out, detail = {}, {}
    for name, stretch in run.check_inputs["stretches"].items():
        nums, detail[name] = stretch_readings(run, stretch, num)
        out.update({"{}.{}".format(name, k): v for k, v in nums.items()})
    out["detail"] = detail
    return out


def leaf_gaps(got, want, keys) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf: the median leaf's gap and the five worst leaves, each
    with its reference norm over the median leaf's."""
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keys}
    w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    med = float(np.median(list(w.values())))
    gaps = {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys}
    worst = sorted(gaps, key=lambda k: -gaps[k])[:5]
    return {"median": float(np.median(list(gaps.values()))),
            "worst": [[k, gaps[k], w[k] / med] for k in worst]}


def check(run, num: Numerics | None = None) -> None:
    """Hold the program's numbers (with ``num`` the control's) to the
    cell's limits."""
    short = [name for name, st in run.check_inputs["stretches"].items() if not st.complete]
    if short:
        print("stretches not run to their end: {}".format(", ".join(short)), file=sys.stderr)
        run.check("window.loss_gap", math.inf)
        return
    t0 = time.perf_counter()
    nums = readings(run, num)
    run.values["check_detail"] = nums.pop("detail")
    for name, v in nums.items():
        run.check(name, v)
    run.values["check_s"] = time.perf_counter() - t0
