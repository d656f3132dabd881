"""Device selection (JAX counterpart: ``deepfluoro_tpu/utils/platform.py::
select_platform``).

The port runs on CUDA unless the caller asks for the CPU. Asking for CUDA
on a host without a card raises: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def get_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises RuntimeError when a CUDA device is
    asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; pass "
            "device='cpu' (CLI: --no-gpu) to run on the CPU"
        )
    return dev
