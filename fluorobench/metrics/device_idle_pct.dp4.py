"""The share of rank 0's traced window with no kernel, copy or set on its
card, in % (``harness.idle_pct``)."""

from fluorobench.harness import idle_pct as read  # noqa: F401
