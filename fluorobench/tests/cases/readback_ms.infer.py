"""The case of the reader ``readback_ms.infer``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 3.0  # 2 and 4
