"""The case of the reader ``decoder_dispatch_ms.samed``: a hand-made
recording of three forwards' SAMed spans inside ``fullres.forward``, and
the value expected from it."""

from fluorobench.tests.recordings import _span


def recording():
    spans = []
    for b, i0 in enumerate((0, 4, 8)):
        t = 100 * b
        forward = _span("fullres.forward", i0, t, t + 60)
        spans += [_span("samed.encoder", None, t + 1, t + 31 + 3 * b, forward),
                  _span("samed.decoder", None, t + 35, t + 41 + 2 * b, forward), forward]
    return spans, {"rel_pos_attention_calls": 36}


WANT = 8.0  # 6, 8 and 10
