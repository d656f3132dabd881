"""The share of the traced window with no kernel, copy or set on the card,
in % (``harness.idle_pct``)."""

from fluorobench.harness import idle_pct as read  # noqa: F401
