"""The case of the reader ``step_dispatch_ms.train``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 6.5  # steps of 4..9 ms
