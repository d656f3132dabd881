"""The case of the reader ``swin_dispatch_ms.swinunetr``: a hand-made
recording of three forwards' Swin UNETR spans inside ``fullres.forward``,
and the value expected from it."""

from fluorobench.tests.recordings import _span


def recording():
    spans = []
    for b, i0 in enumerate((0, 4, 8)):
        t = 100 * b
        forward = _span("fullres.forward", i0, t, t + 60)
        spans += [_span("swinunetr.swin", None, t + 1, t + 21 + 4 * b, forward),
                  _span("swinunetr.decoder", None, t + 30, t + 55, forward), forward]
    return spans, {"window_attention_calls": 24}


WANT = 24.0  # 20, 24 and 28
