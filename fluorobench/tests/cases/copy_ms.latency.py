"""The case of the reader ``copy_ms.latency``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 4.5  # 1 + 2 and 2 + 4
