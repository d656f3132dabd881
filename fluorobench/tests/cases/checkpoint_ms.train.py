"""The case of the reader ``checkpoint_ms.train``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

VALUES = {'epochs': 2}  # the runner's own readings the reader takes beside the recording
WANT = 6.0  # (3 + 3 + 6) / 2 epochs
