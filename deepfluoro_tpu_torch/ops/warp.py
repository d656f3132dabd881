"""The affine warp's CUDA kernel and its wrappers (JAX counterpart:
``deepfluoro_tpu/ops/pallas/warp.py::affine_warp_pallas``, the Pallas TPU
kernel ``_warp_kernel``).

``affine_warp_pair`` is what the augmentation calls: one launch warps a
batch's projection (bilinear, into the padded frame) and its label map
(nearest, into its own frame) under the same per-sample inverse matrices.
``affine_warp`` warps one batch with either order. A tensor on the CPU goes
through the plain version, ``ops/image.py::affine_warp``; a CUDA tensor goes
through the kernel in ``csrc/affine_warp.cu``, built by ``nvcc`` at its
first launch, or the call raises. Semantics are those of the plain version
for any matrix, so the kernel needs none of the TPU kernel's apron, band or
envelope guard.

``tile_windows`` is the kernel's per-tile window rule in Python;
``grid_sample_warp`` computes the same warp with PyTorch's own sampler and
is a yardstick only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deepfluoro_tpu_torch.ops import image
from deepfluoro_tpu_torch.ops._build import load_library

# kernel launches made by affine_warp and affine_warp_pair in this process
# (CPU calls excluded)
warp_launches = 0

# the kernel's tile, shared-memory window budget (floats) and bound on a
# coordinate term for a window (csrc/affine_warp.cu)
TILE_H, TILE_W = 32, 64
WIN_FLOATS = 6144
WINDOW_MAX_TERM = 2.0**20

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = load_library("affine_warp").affine_warp_launch
        # c_void_p for every pointer and the stream: a default ctypes int
        # would cut them to 32 bits
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, f32, f32, i32, ptr, ptr, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check(img: torch.Tensor, inv_matrix: torch.Tensor, name: str):
    if img.ndim != 3 or img.dtype != torch.float32:
        raise ValueError("{} must be (B, H, W) float32, got {} {}".format(name, tuple(img.shape), img.dtype))
    b = img.shape[0]
    if tuple(inv_matrix.shape) != (b, 2, 3) or inv_matrix.dtype != torch.float32:
        raise ValueError("inv_matrix must be ({}, 2, 3) float32, got {} {}".format(b, tuple(inv_matrix.shape), inv_matrix.dtype))
    if inv_matrix.device != img.device:
        raise ValueError("{} and inv_matrix lie on {} and {}".format(name, img.device, inv_matrix.device))
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError("the warp runs on cpu or cuda tensors, got {}".format(img.device))
    if img.device.type == "cuda" and not img.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def _launch(inv_matrix, src0, out_hw, off, order, src1):
    """One kernel launch: task 0 warps ``src0`` into ``out_hw`` at ``off``
    with ``order``; task 1, if ``src1`` is given, warps it nearest into its
    own frame. Returns the outputs (the second None without task 1)."""
    global warp_launches
    b, h, w = src0.shape
    oh, ow = out_hw
    if max(h * w, oh * ow, 0 if src1 is None else src1[0].numel()) >= 2**31:
        raise ValueError("a plane of {}x{} -> {}x{} exceeds the kernel's 32-bit indexing".format(h, w, oh, ow))
    mat = inv_matrix if inv_matrix.is_contiguous() else inv_matrix.contiguous()
    out0 = torch.empty((b, oh, ow), dtype=torch.float32, device=src0.device)
    out1 = None if src1 is None else torch.empty_like(src1)
    # the raw current stream, as Triton's launcher reads it: the public
    # torch.cuda.current_stream() builds a Stream object on every call
    stream = torch._C._cuda_getCurrentRawStream(src0.device.index)
    err = _kernel()(
        mat.data_ptr(), b,
        src0.data_ptr(), out0.data_ptr(), h, w, oh, ow, float(off[0]), float(off[1]), order,
        None if src1 is None else src1.data_ptr(), None if src1 is None else out1.data_ptr(),
        0 if src1 is None else src1.shape[1], 0 if src1 is None else src1.shape[2],
        stream,
    )
    if err != 0:
        raise RuntimeError("affine_warp kernel launch failed with CUDA error {}".format(err))
    warp_launches += 1
    return out0, out1


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
    _check(img, inv_matrix, "img")
    if order not in (0, 1):
        raise ValueError("order must be 0 or 1, got {}".format(order))
    if img.device.type == "cpu":
        return image.affine_warp(img, inv_matrix, order=order, out_shape=out_shape, out_offset_xy=out_offset_xy)
    out_hw = tuple(img.shape[1:]) if out_shape is None else (int(out_shape[0]), int(out_shape[1]))
    return _launch(inv_matrix, img, out_hw, out_offset_xy, int(order), None)[0]


def affine_warp_pair(
    proj: torch.Tensor,
    labels: torch.Tensor | None,
    inv_matrix: torch.Tensor,
    out_shape: tuple[int, int],
    out_offset_xy: tuple[float, float],
):
    """The augmentation's two warps under one set of matrices, in one launch:
    ``proj (B, H, W)`` bilinear into ``out_shape`` at ``out_offset_xy``, and
    ``labels (B, H', W')`` float32 (or None) nearest into its own frame.
    Returns ``(proj_out, labels_out or None)``. Its plain version is the two
    plain calls."""
    _check(proj, inv_matrix, "proj")
    if labels is not None:
        _check(labels, inv_matrix, "labels")
    if proj.device.type == "cpu":
        p = image.affine_warp(proj, inv_matrix, order=1, out_shape=out_shape, out_offset_xy=out_offset_xy)
        return p, None if labels is None else image.affine_warp(labels, inv_matrix, order=0)
    return _launch(inv_matrix, proj, (int(out_shape[0]), int(out_shape[1])), out_offset_xy, 1, labels)


def _center(i: torch.Tensor, off: float) -> torch.Tensor:
    return (i.to(torch.float32) + 0.5) + torch.tensor(off, dtype=torch.float32)


def tile_windows(inv_matrix: torch.Tensor, out_hw, out_offset_xy=(0.0, 0.0)) -> dict:
    """The kernel's window rule (``window()`` in csrc/affine_warp.cu) for
    every sample and output tile, in the same float32 operations.

    ``inv_matrix (B, 2, 3)`` on the CPU. Returns int64 tensors of shape
    ``(B, tiles_y, tiles_x)``: 'x0', 'y0', 'w', 'h' (the window's first
    column and row before mirroring, its width and height) and bool
    'shared' (staged in shared memory; False: sampled from global memory),
    plus 'rows' and 'cols' ``(tiles, 2)`` with each tile's first and last
    output row and column."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ty = torch.arange(0, oh, TILE_H)
    tx = torch.arange(0, ow, TILE_W)
    r0, r1 = ty, torch.clamp(ty + TILE_H, max=oh) - 1
    c0, c1 = tx, torch.clamp(tx + TILE_W, max=ow) - 1
    m = inv_matrix.to(torch.float32).reshape(-1, 6)[:, :, None, None]  # (B, 6, 1, 1)
    xa, xb = _center(c0, out_offset_xy[0])[None, :], _center(c1, out_offset_xy[0])[None, :]
    ya, yb = _center(r0, out_offset_xy[1])[:, None], _center(r1, out_offset_xy[1])[:, None]
    big_x, big_y = torch.maximum(xa.abs(), xb.abs()), torch.maximum(ya.abs(), yb.abs())

    def term(k):  # ((|a| X + |b| Y) + |c|) + 1, the kernel's bound E
        return ((m[:, k].abs() * big_x + m[:, k + 1].abs() * big_y) + m[:, k + 2].abs()) + 1.0

    def coords(k):  # the four corners of every tile, ((a x + b y) + c) - 0.5
        return torch.stack([((m[:, k] * x + m[:, k + 1] * y) + m[:, k + 2]) - 0.5 for x, y in ((xa, ya), (xb, ya), (xa, yb), (xb, yb))])

    ok = (term(0) < WINDOW_MAX_TERM) & (term(3) < WINDOW_MAX_TERM)
    ix, iy = coords(0), coords(3)
    # where ok is False the window is not used; keep the casts finite
    ix, iy = torch.where(ok, ix, 0.0), torch.where(ok, iy, 0.0)
    x0 = torch.floor(ix.amin(0)).long() - 1
    y0 = torch.floor(iy.amin(0)).long() - 1
    w = torch.floor(ix.amax(0)).long() + 2 - x0 + 1
    h = torch.floor(iy.amax(0)).long() + 2 - y0 + 1
    shared = ok & (w * h <= WIN_FLOATS)
    return {
        "x0": x0, "y0": y0, "w": w, "h": h, "shared": shared,
        "rows": torch.stack([r0, r1], 1), "cols": torch.stack([c0, c1], 1),
    }


def grid_sample_warp(
    img: torch.Tensor,
    inv_matrix: torch.Tensor,
    order: int = 1,
    out_shape: tuple[int, int] | None = None,
    out_offset_xy: tuple[float, float] = (0.0, 0.0),
) -> torch.Tensor:
    """A yardstick only: the warp of ``affine_warp`` computed by PyTorch's
    ``F.affine_grid`` and ``F.grid_sample(padding_mode='reflection',
    align_corners=True)``, whose reflection about the centres of pixels 0
    and n - 1 is the mirror boundary. ``chip_smoke.py`` times it beside the
    kernel; nothing on the port's path calls it. Bilinear agrees with the
    plain version to float rounding; nearest can differ at exact ties
    (grid_sample rounds half to even, the port takes floor(x + 0.5)).
    Needs H, W, OH, OW >= 2."""
    b, h, w = img.shape
    oh, ow = (h, w) if out_shape is None else (int(out_shape[0]), int(out_shape[1]))
    ox, oy = float(out_offset_xy[0]), float(out_offset_xy[1])
    m = inv_matrix.to(dtype=torch.float32)
    # output pixel j = (x_n + 1) (OW - 1) / 2 samples input index
    # in_x = a (j + 0.5 + ox) + b (k + 0.5 + oy) + c - 0.5, and input index i
    # lies at u_n = 2 i / (W - 1) - 1 (align_corners=True); likewise for y
    sx, sy = (ow - 1) / 2.0, (oh - 1) / 2.0
    cx, cy = sx + 0.5 + ox, sy + 0.5 + oy
    rows = []
    for r, n in ((0, w), (1, h)):
        a, bb, c = m[:, r, 0], m[:, r, 1], m[:, r, 2]
        k = 2.0 / (n - 1)
        rows.append(torch.stack([a * (sx * k), bb * (sy * k), (a * cx + bb * cy + c - 0.5) * k - 1.0], -1))
    theta = torch.stack(rows, 1)
    grid = F.affine_grid(theta, [b, 1, oh, ow], align_corners=True)
    mode = "bilinear" if order == 1 else "nearest"
    return F.grid_sample(img[:, None], grid, mode=mode, padding_mode="reflection", align_corners=True)[:, 0]
