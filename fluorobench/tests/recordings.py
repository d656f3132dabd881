"""Hand-made recordings of the program's spans and counters, in the form
``deepfluoro_tpu_torch.utils.profiling.recorded()`` returns, for the
readers' cases under ``cases/``."""

from deepfluoro_tpu_torch.utils import profiling

MS = 1_000_000


def _span(name, id, t0_ms, t1_ms, parent=None):
    return profiling.Span(name, id, parent, int(t0_ms * MS), int(t1_ms * MS))


def handmade():
    """Two epochs of three steps, then two batches of the full-res path and
    two landmark decodes, with round durations."""
    spans = []
    for e in range(2):
        epoch = _span("fit.epoch", e, 100 * e, 100 * e + 90)
        for k in range(3):
            step = 3 * e + k
            spans += [_span("fit.step", step, 100 * e + 10 * k, 100 * e + 10 * k + 4 + step, epoch),
                      _span("fit.loss_readback", step, 100 * e + 10 * k + 5, 100 * e + 10 * k + 6 + e, epoch)]
        spans += [_span("fit.validation", e, 100 * e + 40, 100 * e + 60 + 10 * e, epoch),
                  _span("fit.checkpoint", e + 1, 100 * e + 70, 100 * e + 73, epoch), epoch]
    spans.append(_span("fit.checkpoint_wait", None, 200, 206))
    for b, i0 in enumerate((0, 4)):
        t = 300 + 100 * b
        batch = _span("fullres.batch", i0, t, t + 90)
        spans += [_span("fullres.copy_up", i0, t, t + 1 + b, batch),
                  _span("fullres.forward", i0, t + 2, t + 32 + 2 * b, batch),
                  _span("fullres.sync", i0, t + 40, t + 45 + 4 * b, batch),
                  _span("fullres.readback", i0, t + 50, t + 52 + 2 * b, batch), batch,
                  _span("landmarks.detect", None, t + 91, t + 93 + b)]
    return spans, {"host_syncs": 8}
