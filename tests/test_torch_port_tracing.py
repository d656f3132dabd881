"""The port's own spans and counters (deepfluoro_tpu_torch.utils.
profiling: span, count, recorded, reset) in fit, the full-res batches and
the landmark decode, on the CPU: nothing is recorded without a profiler;
under one, every span is recorded with its id and parent, on the
profiler's clock (within 1 ms of its user annotation of the same name;
the fit compared writes its checkpoints on the calling thread, so that
no second thread takes the interpreter lock between the two clock
reads), ``host_syncs`` counts the blocking reads of the device, the
batch driver's spans are those of both its front ends
(``fullres_batches``, ``ensemble_batches``), and a TransUNet member's
spans nest in ``fullres.forward`` and ``attention_calls`` counts its
blocks' attention calls. The recorder has no JAX counterpart. Sizes: a
depth-2, wf-2 net, 32^2 frames padded to 36 for fit and for the
preprocessed archive, raw 148^2 frames (2x: 24^2 padded to 28) for the
full-res path; a TransUNet of two blocks at hidden 32 on the same frames
padded to 48."""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data, make_synthetic_fullres_data
from deepfluoro_tpu_torch.eval.landmarks import detect_landmarks
from deepfluoro_tpu_torch.infer.ensemble import ensemble_batches
from deepfluoro_tpu_torch.infer.fullres import fullres_batches
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit, loop
from deepfluoro_tpu_torch.train.checkpoint import AsyncCheckpointer
from deepfluoro_tpu_torch.utils import profiling

NET = dict(num_classes=7, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True, num_lands=14)
TRANSUNET = dict(arch="transunet", num_classes=7, num_lands=14, proj_unet_dim=48, hidden_size=32, num_heads=4,
                 mlp_dim=64, num_layers=2, resnet_units=(1, 2, 1), resnet_width=8, gn_groups=4,
                 decoder_channels=(16, 8, 8, 4))
TRANSUNET_SPANS = ("transunet.encoder", "transunet.transformer", "transunet.decoder")
FIT_SPANS = {"fit.epoch", "fit.step", "fit.loss_readback", "fit.validation", "fit.checkpoint", "fit.checkpoint_wait"}
BATCH_PARTS = ("fullres.copy_up", "fullres.forward", "fullres.sync", "fullres.readback")
CLOCK_NS = 1_000_000  # the recorded span against the profiler's annotation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several pytest-xdist workers run test files at once; one torch
    thread each keeps their OpenMP threads from spinning against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fit(tmp_path):
    """A tiny two-epoch fit: 6 of 8 frames train at batch 2 (3 steps an
    epoch), a checkpoint every epoch."""
    cfg = TrainConfig(**NET, batch_size=2, proj_unet_dim=36, data_aug=True, train_valid_split=0.75,
                      checkpoint_freq=1, max_num_epochs=2)
    paths = {k: str(tmp_path / v) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}
    return fit(make_synthetic_data(num_specimens=2, num_projs=4, img_dim=32, seed=1), [1, 2], cfg, verbose=False,
               device="cpu", **paths)


def _fullres(consumed=None, net=None):
    """Five raw frames at batch 2 (the last batch padded) through one
    member (the U-Net ``NET``, or ``net``'s config): (the yielded batches,
    ``times``). ``consumed`` gets the clock at which the consumer held
    each batch."""
    torch.manual_seed(0)
    cfg = TrainConfig(**NET, proj_unet_dim=28) if net is None else TrainConfig(**net)
    members = [build_model(cfg).eval()]
    spec = make_synthetic_fullres_data(num_specimens=1, num_projs=5, img_dim=148, seed=7)[0]
    times = []
    return _consume(fullres_batches(lambda i0, i1: (spec["projs"][i0:i1], spec["rots"][i0:i1]), 5, (148, 148),
                                    members, 2, 14, times, 2, cfg.proj_unet_dim), consumed), times


def _ensemble(consumed=None):
    """A preprocessed archive of five 32^2 frames at batch 2 (the last
    batch padded) through the U-Net ``NET`` padded to 36, as ``_fullres``."""
    torch.manual_seed(0)
    members = [build_model(TrainConfig(**NET, proj_unet_dim=36)).eval()]
    data = make_synthetic_data(num_specimens=1, num_projs=5, img_dim=32, seed=7)
    times = []
    return _consume(ensemble_batches(data, members, 14, times, 2, 36), consumed), times


def _consume(batches, consumed):
    out = []
    for i0, labels, heats in batches:
        if consumed is not None:
            consumed[i0] = time.time_ns()
        out.append((i0, labels, heats))
    return out


def _traced(fn, *args):
    """(fn's result, the profiler, the spans, the counters) of ``fn`` run
    under a CPU profiler, the recorder reset before and after."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn(*args)
    spans, counts = profiling.recorded()
    profiling.reset()
    return result, prof, spans, counts


class _InlineCheckpointer(AsyncCheckpointer):
    """Writes on the calling thread. With the writer thread, the
    interpreter lock can pass to it between a span's clock read and its
    range's for as long as the writer runs: scheduling, not the clock."""

    def _submit(self, fn, *args):
        self._raise_pending()
        fn(*args)


@pytest.fixture(scope="module")
def fit_traced(tmp_path_factory):
    return _traced(_fit, tmp_path_factory.mktemp("fit"))


@pytest.fixture(scope="module")
def fit_inline_traced(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "AsyncCheckpointer", _InlineCheckpointer)
        return _traced(_fit, tmp_path_factory.mktemp("fit_inline"))


def _front_traced(front):
    consumed = {}
    (batches, times), prof, spans, counts = _traced(front, consumed)
    return batches, times, consumed, prof, spans, counts


@pytest.fixture(scope="module")
def fullres_traced():
    return _front_traced(_fullres)


@pytest.fixture(scope="module")
def ensemble_traced():
    return _front_traced(_ensemble)


@pytest.fixture(scope="module")
def transunet_traced():
    return _traced(_fullres, None, TRANSUNET)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_nothing_is_recorded_without_a_profiler(tmp_path):
    profiling.reset()
    out = _fit(tmp_path)
    batches, times = _fullres()
    transunet_batches, _ = _fullres(net=TRANSUNET)
    assert len(out["step_seconds"]) == 6 and len(batches) == 3 and len(times) == 5 and len(transunet_batches) == 3
    assert profiling.recorded() == ([], {})
    assert profiling.span("a", 1) is profiling.span("b")


def test_fit_records_every_span_with_consecutive_steps_under_epochs(fit_traced):
    out, _, spans, counts = fit_traced
    assert {s.name for s in spans} == FIT_SPANS
    steps = _named(spans, "fit.step")
    assert [s.id for s in steps] == list(range(6)) == [s.id for s in _named(spans, "fit.loss_readback")]
    assert all(s.parent is not None and s.parent.name == "fit.epoch" for s in steps)
    assert [s.id for s in _named(spans, "fit.epoch")] == [0, 1] == [s.id for s in _named(spans, "fit.validation")]
    assert _named(spans, "fit.checkpoint_wait")[0].parent is None
    # one loss read a step and one read of the validation losses an epoch
    assert counts == {"host_syncs": len(steps) + 2}
    assert len(out["step_seconds"]) == len(out["train_losses"]) == 6


def test_step_seconds_still_hold_each_step_and_its_loss_read(fit_traced):
    out, _, spans, _ = fit_traced
    for t, step, read in zip(out["step_seconds"], _named(spans, "fit.step"), _named(spans, "fit.loss_readback")):
        assert step.end_ns <= read.start_ns
        assert (step.ms + read.ms) / 1e3 <= t


def _annotations(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("which", ["fit", "fullres", "transunet"])
def test_every_span_is_an_annotation_on_the_profilers_clock(which, fit_inline_traced, fullres_traced,
                                                           transunet_traced):
    prof, spans = {"fit": fit_inline_traced[1:3], "fullres": fullres_traced[3:5],
                   "transunet": transunet_traced[1:3]}[which]
    ann = _annotations(prof)
    assert spans
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted((a, b) for n, a, b in ann if n == name)
        assert len(mine) == len(theirs), name
        for (s0, s1), (a0, a1) in zip(mine, theirs):
            assert abs(s0 - a0) <= CLOCK_NS and abs(s1 - a1) <= CLOCK_NS, name


@pytest.mark.parametrize("front", ["fullres", "ensemble"])
def test_fullres_spans_add_up_to_times_and_nest_in_their_batch(front, request):
    """Each batch of either front end of the batch driver holds its four
    parts, whose times add up to ``times``."""
    batches, times, _, _, spans, counts = request.getfixturevalue(front + "_traced")
    outer = {s.id: s for s in _named(spans, "fullres.batch")}
    assert sorted(outer) == [0, 2, 4] == [i0 for i0, _, _ in batches]
    real = {0: 2, 2: 2, 4: 1}
    for i0, batch in outer.items():
        assert batch.parent is None
        parts = [s for s in spans if s.id == i0 and s.name in BATCH_PARTS]
        assert sorted(s.name for s in parts) == sorted(BATCH_PARTS)
        for s in parts:
            assert s.parent is batch and batch.start_ns <= s.start_ns <= s.end_ns <= batch.end_ns
        timed = sum(s.ms for s in parts if s.name != "fullres.readback")
        want = 1e3 * times[i0] * real[i0]
        assert abs(timed - want) <= max(0.1 * want, 1.0), (i0, timed, want)
    # the warm-up's synchronise, then a synchronise and one readback wait a
    # batch (labels and heats together); no pinned readback on the CPU
    assert counts == {"host_syncs": 1 + 2 * len(batches)}
    assert "pinned_readbacks" not in counts


def test_transunet_spans_nest_in_the_batch_forward_and_count_attention_calls(transunet_traced):
    """Each batch forward holds the three TransUNet spans, in order; the
    warm-up forward before the first batch records them with no parent;
    ``attention_calls`` counts one a block a forward, warm-up included."""
    (batches, _), _, spans, counts = transunet_traced
    forwards = _named(spans, "fullres.forward")
    assert len(forwards) == len(batches) == 3
    first_batch = min(s.start_ns for s in _named(spans, "fullres.batch"))
    mine = sorted((s for s in spans if s.name in TRANSUNET_SPANS), key=lambda s: s.start_ns)
    assert [s.name for s in mine] == list(TRANSUNET_SPANS) * (len(forwards) + 1)
    warmup, inside = mine[:3], mine[3:]
    assert all(s.parent is None and s.end_ns <= first_batch for s in warmup)
    for k, forward in enumerate(forwards):
        part = inside[3 * k : 3 * k + 3]
        assert all(s.parent is forward and forward.start_ns <= s.start_ns <= s.end_ns <= forward.end_ns
                   for s in part)
        assert part[0].end_ns <= part[1].start_ns and part[1].end_ns <= part[2].start_ns
    assert counts["attention_calls"] == TRANSUNET["num_layers"] * (len(forwards) + 1)


def test_a_batch_span_ends_before_its_consumer_holds_the_batch(fullres_traced):
    batches, _, consumed, _, spans, _ = fullres_traced
    for s in spans:
        assert s.end_ns <= consumed[s.id], s
    # the consumer's own time between batches lies outside every span
    ends = sorted(s.end_ns for s in _named(spans, "fullres.batch"))
    starts = sorted(s.start_ns for s in _named(spans, "fullres.batch"))
    assert all(consumed[i0] <= nxt for i0, nxt in zip(sorted(consumed), starts[1:]))
    assert all(e <= consumed[i0] for e, i0 in zip(ends, sorted(consumed)))


def test_fullres_outputs_are_as_without_tracing(fullres_traced):
    traced = fullres_traced[0]
    plain, _ = _fullres()
    for (i0, labels, heats), (j0, labels_p, heats_p) in zip(traced, plain):
        assert i0 == j0
        np.testing.assert_array_equal(labels, labels_p)
        np.testing.assert_array_equal(heats, heats_p)


def test_detect_landmarks_records_its_span_and_two_reads():
    heats = torch.rand((2, 14, 32, 32), generator=torch.Generator().manual_seed(3))
    land_names = ["land-{:02d}".format(i) for i in range(14)]
    plain = detect_landmarks(heats, land_names)
    got, _, spans, counts = _traced(detect_landmarks, heats, land_names)
    assert [(s.name, s.id, s.parent) for s in spans] == [("landmarks.detect", None, None)]
    assert counts == {"host_syncs": 2}
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_a_span_takes_its_ranges_own_clock_when_the_session_ends(monkeypatch):
    """A thread switch or a preemption between a span's clock read and its
    range's own (a clock 7 ms ahead stands in for it): while the session
    runs the span holds its reads; when it ends, its range's start and
    end exactly."""
    real = time.time_ns
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=lambda: real() + 7_000_000))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            with profiling.span("skewed", i):
                with profiling.span("skewed.inner"):
                    torch.ones(4).sum()
        during = [(s.start_ns, s.end_ns) for s in profiling.recorded()[0]]
    spans, _ = profiling.recorded()
    profiling.reset()
    ann = sorted((a, b) for n, a, b in _annotations(prof) if n.startswith("skewed"))
    assert sorted((s.start_ns, s.end_ns) for s in spans) == ann and len(ann) == 4
    assert all(abs(a - d) >= 6_000_000 for (a, _), (d, _) in zip(ann, sorted(during)))


class _Event:
    """What ``device_time_inside`` reads of a profiler event."""

    def __init__(self, name, device, start, dur, tid=0, corr=0, linked=0, annotation=False):
        self._v = (name, device, start, dur, tid, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def test_a_device_timed_span_sums_what_its_ops_launched():
    """The device time under a name is that of the kernels, copies and
    sets linked to ops that began inside a range of the name on the op's
    own thread: not those of ops outside it, on a thread without such a
    range, or unknown, nor a runtime call on the host or the range's
    mirror on the device's timeline."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event("r", cpu, 100, 100, tid=1, corr=90, annotation=True),
        _Event("r", cpu, 300, 100, tid=1, corr=91, annotation=True),
        _Event("r", cpu, 100, 400, tid=2, corr=92, annotation=True),
        _Event("aten::bmm", cpu, 150, 10, tid=1, corr=1),
        _Event("aten::add", cpu, 250, 10, tid=1, corr=2),
        _Event("aten::_efficient_attention_forward", cpu, 350, 10, tid=1, corr=3),
        _Event("aten::mm", cpu, 150, 10, tid=3, corr=4),
        _Event("aten::copy_", cpu, 120, 10, tid=2, corr=5),
        _Event("cudaLaunchKernel", cpu, 151, 2, tid=1, corr=6, linked=1),
        _Event("gemm", cuda, 1000, 10, linked=1),
        _Event("elementwise", cuda, 1010, 20, linked=2),
        _Event("fmha", cuda, 1030, 30, linked=3),
        _Event("Memcpy DtoD", cuda, 1060, 5, linked=3),
        _Event("gemm", cuda, 1070, 40, linked=4),
        _Event("copy", cuda, 1110, 50, linked=5),
        _Event("r", cuda, 1000, 1000, linked=1),
        _Event("gemm", cuda, 1160, 7, linked=99),
    ]
    assert profiling.device_time_inside(events, {"r", "absent"}) == {"r": pytest.approx(95e-9), "absent": 0.0}


def test_reset_empties_spans_and_counters():
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                profiling.count("c", 3)
        profiling.count("c")
    spans, counts = profiling.recorded()
    assert [(s.name, s.id) for s in spans] == [("inner", None), ("outer", 7)]
    assert spans[0].parent is spans[1] and spans[1].parent is None and counts == {"c": 4}
    profiling.reset()
    assert profiling.recorded() == ([], {})


def test_a_span_on_another_thread_has_no_parent_from_this_one():
    """Whether the profiler follows the worker thread at all is torch's
    choice; a span recorded there never takes this thread's as parent."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("main"):

            def work():
                with profiling.span("worker"):
                    torch.ones(4).sum()

            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=60)
    assert not worker.is_alive()
    spans, _ = profiling.recorded()
    profiling.reset()
    assert [s.name for s in spans if s.name == "main"] == ["main"]
    assert all(s.parent is None for s in spans)


def test_profile_trace_writes_the_programs_spans(tmp_path):
    heats = torch.rand((1, 14, 32, 32), generator=torch.Generator().manual_seed(4))
    profiling.reset()
    with profiling.profile_trace(str(tmp_path)):
        detect_landmarks(heats, ["land-{:02d}".format(i) for i in range(14)])
    assert [s.name for s in profiling.recorded()[0]] == ["landmarks.detect"]
    profiling.reset()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "landmarks.detect" and e.get("cat") == "user_annotation" for e in events)
