"""The affine warp's CUDA kernel and its wrapper (JAX counterpart:
``deepfluoro_tpu/ops/pallas/warp.py::affine_warp_pallas``, the Pallas TPU
kernel ``_warp_kernel``).

``affine_warp`` takes a batch: ``img (B, H, W)`` float32 and per-sample
inverse matrices ``(B, 2, 3)``. A tensor on the CPU goes through the plain
version, ``ops/image.py::affine_warp``; a CUDA tensor goes through the
kernel in ``csrc/affine_warp.cu``, built by ``nvcc`` at its first launch,
or the call raises. Semantics are those of the plain version for any
matrix, so the kernel needs none of the TPU kernel's apron, band or
envelope guard.
"""

from __future__ import annotations

import ctypes

import torch

from deepfluoro_tpu_torch.ops import image
from deepfluoro_tpu_torch.ops._build import load_library

# kernel launches made by affine_warp in this process (CPU calls excluded)
warp_launches = 0

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = load_library("affine_warp").affine_warp_launch
        # c_void_p for every pointer and the stream: a default ctypes int
        # would cut them to 32 bits
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def affine_warp(
    img: torch.Tensor,
    inv_matrix: torch.Tensor,
    order: int = 1,
    out_shape: tuple[int, int] | None = None,
    out_offset_xy: tuple[float, float] = (0.0, 0.0),
) -> torch.Tensor:
    """Mirror-boundary warp of ``img (B, H, W)`` under ``inv_matrix
    (B, 2, 3)``; see ``ops/image.py::affine_warp`` for the semantics.
    Returns ``(B, OH, OW)`` float32 on the input's device."""
    global warp_launches
    if img.ndim != 3 or img.dtype != torch.float32:
        raise ValueError("img must be (B, H, W) float32, got {} {}".format(tuple(img.shape), img.dtype))
    b, h, w = img.shape
    if tuple(inv_matrix.shape) != (b, 2, 3) or inv_matrix.dtype != torch.float32:
        raise ValueError("inv_matrix must be ({}, 2, 3) float32, got {} {}".format(b, tuple(inv_matrix.shape), inv_matrix.dtype))
    if inv_matrix.device != img.device:
        raise ValueError("img and inv_matrix lie on {} and {}".format(img.device, inv_matrix.device))
    if order not in (0, 1):
        raise ValueError("order must be 0 or 1, got {}".format(order))
    if img.device.type == "cpu":
        return image.affine_warp(img, inv_matrix, order=order, out_shape=out_shape, out_offset_xy=out_offset_xy)
    if img.device.type != "cuda":
        raise ValueError("affine_warp runs on cpu or cuda tensors, got {}".format(img.device))
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")

    oh, ow = (h, w) if out_shape is None else (int(out_shape[0]), int(out_shape[1]))
    mat = inv_matrix.reshape(b, 6).contiguous()
    out = torch.empty((b, oh, ow), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _kernel()(
        img.data_ptr(), mat.data_ptr(), out.data_ptr(),
        b, h, w, oh, ow,
        float(out_offset_xy[0]), float(out_offset_xy[1]), int(order), stream,
    )
    if err != 0:
        raise RuntimeError("affine_warp kernel launch failed with CUDA error {}".format(err))
    warp_launches += 1
    return out
