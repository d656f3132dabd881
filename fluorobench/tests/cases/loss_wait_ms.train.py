"""The case of the reader ``loss_wait_ms.train``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 1.5  # 1, 1, 1, 2, 2, 2
