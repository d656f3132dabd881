"""The case of the reader ``syncs_per_step.train``: the hand-made recording and the value
expected from it."""

from fluorobench.tests.recordings import handmade as recording  # noqa: F401

WANT = 8 / 6  # 8 host syncs over 6 steps
# a traced CPU run of the cell: the window's first step began before the trace, so one loss
# read more than recorded steps, and one validation read an epoch
TRACED = (1.0, 1.5)
