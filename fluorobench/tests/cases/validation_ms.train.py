"""The case of the reader ``validation_ms.train``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 25.0  # 20 and 30
