"""The training step's CUDA graph (``train/step.py::StepGraph``) on the CPU.

A capture cannot run here, so the graph is replaced by a stand-in that
keeps the plumbing whole: ``capture(step, gen)`` returns a replay that
reruns the captured closure on the graph's static batch tensors into the
captured loss tensor. N steps through it must equal N eager steps bit for
bit (losses, parameters, momentum, BatchNorm buffers and the generator's
state), each replay seeing its own batch and drawing its own
augmentation. Also: which steps ``offer_graph`` keeps eager, the shared
``graph_pays`` rule at its edge, the decision from the timed steps, a
capture again when the LR changes, the ``step_graph_replays`` counter,
and ``fit`` passing its graph to ``train_step`` (on the CPU: none).
"""

import logging
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepfluoro_tpu_torch.data import augment as taug
from deepfluoro_tpu_torch.data.augment import AugmentConfig
from deepfluoro_tpu_torch.data.fixtures import make_synthetic_data
from deepfluoro_tpu_torch.infer import batches as tbatches
from deepfluoro_tpu_torch.train import TrainConfig, build_model, fit, make_optimizer, train_step
from deepfluoro_tpu_torch.train import loop as tloop
from deepfluoro_tpu_torch.train import step as tstep
from deepfluoro_tpu_torch.utils import graphs, profiling

RECIPE = dict(num_classes=7, batch_size=2, proj_unet_dim=36, optim_type="sgd", init_lr=0.1, nesterov=True,
              momentum=0.9, wgt_decay=1e-4, depth=2, init_feats_exp=2, batch_norm=True, padding=True, no_max_pool=True,
              num_lands=14, heat_coeff=0.5, lr_sched_meth="plateau", data_aug=True)
FRAME = 32
CUDA = torch.device("cuda", 0)  # a device object only: nothing runs on it


class Rerun:
    """A CPU stand-in for ``utils/graphs.py::capture``: nothing runs at the
    capture; each replay reruns the captured closure (which reads the
    graph's static batch tensors) into the loss tensor it returned."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def __call__(self, step, stream, gen):
        assert stream is None  # a CPU step runs on no stream
        self.captures += 1
        loss = torch.empty(())

        def replay():
            self.replays += 1
            loss.copy_(step())

        return types.SimpleNamespace(replay=replay), loss


def pays(fn):
    return fn(), 1.0, 1.0


def never_pays(fn):
    return fn(), 0.4999, 1.0


def _setup(seed=3):
    cfg = TrainConfig(**RECIPE)
    torch.manual_seed(seed)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    return cfg, model, make_optimizer(cfg, model.parameters()), gen


def _batches(n, batch=2, seed=5):
    data = make_synthetic_data(num_specimens=1, num_projs=n * batch, img_dim=FRAME, seed=seed)
    projs, segs, lands = (torch.from_numpy(a) for a in (data.projs, data.segs, data.lands))
    return [(projs[i : i + batch], segs[i : i + batch], lands[i : i + batch]) for i in range(0, n * batch, batch)]


def _aug(cfg):
    return AugmentConfig(num_classes=cfg.num_classes, proj_pad_dim=cfg.proj_unet_dim, prob_of_aug=0.5)


def _state(model, optimizer, gen):
    out = {"gen": gen.get_state()}
    out.update({"sd." + k: v.clone() for k, v in model.state_dict().items()})
    out.update({"momentum." + str(i): optimizer.state[p]["momentum_buffer"].clone()
                for i, p in enumerate(model.parameters()) if "momentum_buffer" in optimizer.state.get(p, {})})
    return out


def _run(steps, lrs, graph=None, record=None):
    """The losses and final state of ``len(lrs)`` steps over ``steps``
    batches from the seeded set-up, each step's batch and draws in
    ``record`` when given."""
    cfg, model, optimizer, gen = _setup()
    prepare, draw = tstep.prepare_batch, taug.draw_augmentation

    def seen_prepare(aug_cfg, g, projs, *args, **kwargs):
        record.append({"projs": projs.clone()})
        return prepare(aug_cfg, g, projs, *args, **kwargs)

    def seen_draw(*args, **kwargs):
        draws = draw(*args, **kwargs)
        record[-1]["draws"] = {k: v.clone() for k, v in draws.items()}
        return draws

    with pytest.MonkeyPatch.context() as patch:
        if record is not None:
            patch.setattr(tstep, "prepare_batch", seen_prepare)
            patch.setattr(taug, "draw_augmentation", seen_draw)
        losses = [float(train_step(model, optimizer, cfg, _aug(cfg), gen, b, lr, graph=graph))
                  for b, lr in zip(steps, lrs)]
    return losses, _state(model, optimizer, gen)


def _assert_same(a, b):
    assert a[0] == b[0]  # losses, bit for bit
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def test_graph_steps_equal_eager_steps_bit_for_bit():
    """Three eager steps decide, the fourth captures and every step from
    there replays through the static batch tensors: losses, parameters,
    BatchNorm buffers, momentum and the generator's state equal eight eager
    steps' bit for bit, and each replay reads its own batch and draws its
    own augmentation, the eager step's."""
    steps, lrs = _batches(8), [0.1] * 8
    seen_eager, seen_graph = [], []
    eager = _run(steps, lrs, record=seen_eager)
    capture = Rerun()
    graph = tstep.StepGraph(capture=capture, timer=pays)
    graphed = _run(steps, lrs, graph, record=seen_graph)
    _assert_same(graphed, eager)
    assert graph.pays is True and capture.captures == graph.captures == 1 and capture.replays == 8 - 3
    assert len(seen_graph) == len(seen_eager) == 8
    for i, (g, e) in enumerate(zip(seen_graph, seen_eager)):
        assert torch.equal(g["projs"], steps[i][0].float()) and torch.equal(g["projs"], e["projs"].float())
        for k in e["draws"]:
            assert torch.equal(g["draws"][k], e["draws"][k]), (i, k)
    for prev, cur in zip(seen_graph[3:], seen_graph[4:]):
        assert not torch.equal(prev["projs"], cur["projs"])
        assert not torch.equal(prev["draws"]["rot"], cur["draws"]["rot"])
        assert not torch.equal(prev["draws"]["noise"], cur["draws"]["noise"])


def test_a_new_lr_captures_the_step_again():
    """The graph holds the LR as a constant: a step at another LR (the
    plateau schedule's cut) runs eagerly and captures again, and the run
    still equals the eager one with the same LRs bit for bit."""
    steps = _batches(8)
    lrs = [0.1] * 5 + [0.01] * 3
    eager = _run(steps, lrs)
    capture = Rerun()
    graph = tstep.StepGraph(capture=capture, timer=pays)
    _assert_same(_run(steps, lrs, graph), eager)
    assert capture.captures == graph.captures == 2 and capture.replays == graph.replays == 4


def test_every_capture_follows_an_eager_step_at_its_lr(monkeypatch):
    """A capture comes right after an eager step at the LR it captures (the
    deciding step, then the first step at each new LR), on the stream the
    capture uses: the libraries set up there what a capture could not."""
    events = []
    prepare = tstep.prepare_batch

    def seen_prepare(*args, **kwargs):
        events.append("step")
        return prepare(*args, **kwargs)

    class Logged(Rerun):
        def __call__(self, step, stream, gen):
            events.append("capture")
            graph, loss = super().__call__(step, stream, gen)
            replay = graph.replay
            graph.replay = lambda: (events.append("replay"), replay())
            return graph, loss

    monkeypatch.setattr(tstep, "prepare_batch", seen_prepare)
    graph = tstep.StepGraph(capture=Logged(), timer=pays)
    _run(_batches(8), [0.1] * 4 + [0.01] * 2 + [0.001] * 2, graph)
    assert events == ["step"] * 3 + ["capture"] + ["replay", "step"] + ["step", "capture"] + ["replay", "step"] + \
        ["step", "capture"] + ["replay", "step"]


def test_a_partial_batch_runs_eagerly_between_replays():
    """A final partial batch is no shape the graph holds: it runs eagerly,
    and the replays around it still equal the eager run."""
    full, part = _batches(6), _batches(1, batch=1, seed=9)
    steps = full[:4] + part + full[4:]
    lrs = [0.1] * len(steps)
    eager = _run(steps, lrs)
    capture = Rerun()
    graph = tstep.StepGraph(capture=capture, timer=pays)
    _assert_same(_run(steps, lrs, graph), eager)
    assert capture.captures == 1 and capture.replays == len(steps) - 3 - 1


def test_a_step_whose_dispatch_does_not_pay_stays_eager(caplog):
    """Where ``graph_pays`` says no, nothing is captured and every step is
    the eager step; the decision is logged at INFO."""
    steps, lrs = _batches(6), [0.1] * 6
    eager = _run(steps, lrs)
    capture = Rerun()
    graph = tstep.StepGraph(capture=capture, timer=never_pays)
    with caplog.at_level(logging.INFO, logger=tstep.__name__):
        _assert_same(_run(steps, lrs, graph), eager)
    assert graph.pays is False and capture.captures == 0
    assert "host dispatch 499.900 ms, card 1000.000 ms: eager" in caplog.text


def test_the_decision_takes_the_least_of_the_timed_steps(caplog):
    """The first step is untimed; the next ``TIMED_RUNS`` are, and each side
    of the decision is the least of them."""
    times = iter([(0.2, 1.0), (0.9, 0.9)])

    def timer(fn):
        return (fn(), *next(times))

    graph = tstep.StepGraph(capture=Rerun(), timer=timer)
    with caplog.at_level(logging.INFO, logger=tstep.__name__):
        _run(_batches(3), [0.1] * 3, graph)
    assert graphs.TIMED_RUNS == 2
    assert graph.pays is False  # 0.2 s against 0.9 s
    assert "host dispatch 200.000 ms, card 900.000 ms: eager" in caplog.text


def test_replays_are_counted_while_a_profiler_runs():
    """``step_graph_replays`` counts one a replayed step, and the timed steps'
    waits count as host syncs."""
    graph = tstep.StepGraph(capture=Rerun(), timer=pays)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _run(_batches(6), [0.1] * 6, graph)
    counts = profiling.recorded()[1]
    profiling.reset()
    assert counts == {"step_graph_replays": 3, "host_syncs": 2} and graph.replays == 3


@pytest.mark.parametrize("dispatch_s,device_s,expect", [(0.5, 1.0, True), (0.4999, 1.0, False), (2.0, 1.0, True)],
                         ids=["on-the-line", "just-below", "host-bound"])
def test_one_graph_pays_rule_for_training_and_inference(dispatch_s, device_s, expect):
    """Training and inference decide by the one rule of ``utils/graphs.py``:
    a CUDA graph where the host's dispatch is at least half the card's time."""
    assert graphs.GRAPH_DISPATCH_SHARE == 0.5
    assert tstep.graph_pays is tbatches.graph_pays is graphs.graph_pays
    assert graphs.graph_pays(dispatch_s, device_s) is expect


MESH = types.SimpleNamespace(axis_names=("data",))
SHARD = types.SimpleNamespace(axis_names=("data", "spatial"))


@pytest.mark.parametrize("case,device,mesh,over,why", [
    ("cpu", torch.device("cpu"), None, {}, "not on a CUDA card"),
    ("mesh", CUDA, MESH, {}, "on a mesh"),
    ("shard", CUDA, SHARD, {}, "on a mesh"),
    ("remat", CUDA, None, {"remat": True}, "bfloat16 compute or remat"),
    ("bf16", CUDA, None, {"compute_dtype": "bfloat16"}, "bfloat16 compute or remat"),
    ("cos", CUDA, None, {"lr_sched_meth": "cos"}, "the cosine schedule moves the LR every step"),
    ("adam", CUDA, None, {"optim_type": "adam", "lr_sched_meth": "none"}, "optimizer adam"),
    ("transunet", CUDA, None, {"arch": "transunet", "proj_unet_dim": 48}, "a transunet records its spans on the host"),
])
def test_offer_rule_keeps_these_steps_eager(case, device, mesh, over, why, caplog):
    """Only a single-device float32 U-Net step with SGD and an LR that holds
    through each epoch is offered a graph; every other step stays eager,
    and says why at INFO."""
    cfg = TrainConfig(**dict(RECIPE, **over))
    with caplog.at_level(logging.INFO, logger=tstep.__name__):
        assert tstep.offer_graph(cfg, device, mesh) is None
    assert "training step: eager ({})".format(why) in caplog.text


@pytest.mark.parametrize("sched", ["plateau", "none"])
def test_offer_rule_offers_a_single_card_float32_sgd_step(sched):
    graph = tstep.offer_graph(TrainConfig(**dict(RECIPE, lr_sched_meth=sched)), CUDA)
    assert isinstance(graph, tstep.StepGraph) and graph.pays is None and graph.captures == 0


def _fit(tmp_path, name, data, cfg):
    paths = {k: str(tmp_path / "{}_{}".format(name, v)) for k, v in dict(
        checkpoint_filename="ck.pt", best_valid_filename="best.pt", train_loss_txt="train.txt",
        valid_loss_txt="valid.txt").items()}
    return fit(data, [1], cfg, verbose=False, device="cpu", **paths)


def test_fit_passes_its_graph_to_train_step(tmp_path, monkeypatch):
    """``fit`` calls ``loop.train_step`` once a step with its graph as a
    keyword: none on the CPU; where one is offered (the stand-in here), two
    epochs with validation between them and a final partial batch each
    equal the eager fit bit for bit, with every full batch after the first
    three replayed."""
    data = make_synthetic_data(num_specimens=1, num_projs=12, img_dim=FRAME, seed=2)
    cfg = TrainConfig(**dict(RECIPE, train_valid_split=0.75, checkpoint_freq=1, max_num_epochs=2))
    seen = []
    step = tloop.train_step

    def recorded(*args, **kwargs):
        seen.append(kwargs.get("graph"))
        return step(*args, **kwargs)

    monkeypatch.setattr(tloop, "train_step", recorded)
    eager = _fit(tmp_path, "eager", data, cfg)
    assert len(seen) == len(eager["train_losses"]) == 2 * 5 and seen == [None] * 10  # 9 frames: 4 full, 1 partial
    capture = Rerun()
    monkeypatch.setattr(tloop, "offer_graph", lambda *args: tstep.StepGraph(capture=capture, timer=pays))
    seen.clear()
    graphed = _fit(tmp_path, "graph", data, cfg)
    assert len(seen) == 10 and all(isinstance(g, tstep.StepGraph) and g is seen[0] for g in seen)
    assert graphed["train_losses"] == eager["train_losses"]
    assert graphed["valid_losses"] == eager["valid_losses"]
    for (k, a), b in zip(graphed["model"].state_dict().items(), eager["model"].state_dict().values()):
        assert torch.equal(a, b), k
    assert capture.captures == 1 and capture.replays == 8 - 3
