"""The case of the reader ``transformer_dispatch_ms.transunet``: a hand-made
recording of three forwards' TransUNet spans inside ``fullres.forward``,
and the value expected from it."""

from fluorobench.tests.recordings import _span


def recording():
    spans = []
    for b, i0 in enumerate((0, 4, 8)):
        t = 100 * b
        forward = _span("fullres.forward", i0, t, t + 60)
        spans += [_span("transunet.encoder", None, t + 1, t + 11, forward),
                  _span("transunet.transformer", None, t + 11, t + 31 + 5 * b, forward),
                  _span("transunet.decoder", None, t + 40, t + 55, forward), forward]
    return spans, {"attention_calls": 36}


WANT = 25.0  # 20, 25 and 30
