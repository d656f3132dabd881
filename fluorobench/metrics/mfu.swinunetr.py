"""The window's share of the card's float32 peak (67 TFLOP/s outside the
tensor cores, H100 SXM at 700 W), from ``counts_swinunetr.py``'s
operations per Swin UNETR frame, in % (``harness.mfu_pct``)."""

from fluorobench.harness import mfu_pct as read  # noqa: F401
