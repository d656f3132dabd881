"""The case of the reader ``landmark_decode_ms.latency``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 2.5  # 2 and 3
