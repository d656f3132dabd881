"""The case of the reader ``device_wait_ms.latency``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 7.0  # 5 and 9
