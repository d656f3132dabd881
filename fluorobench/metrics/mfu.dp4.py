"""The window's share of its cards' float32 peak (67 TFLOP/s a card outside
the tensor cores, H100 SXM at 700 W, times the cards), from ``counts.py``'s
operations per frame and the global frames, in % (``harness.mfu_pct``)."""

from fluorobench.harness import mfu_pct as read  # noqa: F401
