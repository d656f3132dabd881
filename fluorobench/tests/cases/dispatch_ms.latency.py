"""The case of the reader ``dispatch_ms.latency``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 31.0  # 30 and 32
