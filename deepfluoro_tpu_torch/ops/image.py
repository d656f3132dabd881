"""Image primitives: center crop, padding math, normalization, affine
matrices and the plain affine warp (JAX counterpart:
``deepfluoro_tpu/ops/image.py``).

Spatial axes are always the trailing two: ``(H, W)``, ``(B, H, W)`` or NCHW.

Reference semantics: util.py:92-114 (center_crop), dataset.py:26-40
(calc_pad_amount), dataset.py:287-293 (reflect pad + z-norm).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def calc_pad_amount(padded_img_dim: int, cur_img_dim: int) -> int:
    """Per-border padding to grow ``cur_img_dim`` to ``padded_img_dim``:
    ceil((padded - cur)/2); the target must be strictly larger
    (reference dataset.py:26-40)."""
    assert padded_img_dim > cur_img_dim
    return int(math.ceil((padded_img_dim - cur_img_dim) / 2.0))


def center_crop(img: torch.Tensor, dst_hw) -> torch.Tensor:
    """Center-crop the trailing two dims to ``dst_hw = (H, W)``; the start
    offset is floor((src-dst)/2) (reference util.py:92-114)."""
    dst_h, dst_w = int(dst_hw[0]), int(dst_hw[1])
    src_h, src_w = img.shape[-2], img.shape[-1]
    if (src_h, src_w) == (dst_h, dst_w):
        return img
    r0 = (src_h - dst_h) // 2
    c0 = (src_w - dst_w) // 2
    return img[..., r0 : r0 + dst_h, c0 : c0 + dst_w]


def reflect_pad_to(img: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """Reflect-pad square trailing dims up to ``padded_dim`` by
    calc_pad_amount per side (reference dataset.py:287-290). Odd deltas give
    ``cur + 2*pad`` = padded_dim + 1, as in the reference."""
    cur = img.shape[-1]
    assert img.shape[-2] == cur, "only square images supported (reference dataset.py:85)"
    if padded_dim <= cur:
        return img
    pad = calc_pad_amount(padded_dim, cur)
    lead = img.shape[:-2]
    flat = img.reshape((-1,) + tuple(img.shape[-2:]))
    out = F.pad(flat, (pad, pad, pad, pad), mode="reflect")
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def znorm(img: torch.Tensor, dim=None) -> torch.Tensor:
    """Zero-mean / unit-std normalization over ``dim`` (default: the whole
    tensor), with Bessel's N-1 correction like torch.std in the reference
    (dataset.py:292-293)."""
    if dim is None:
        return (img - img.mean()) / img.std(correction=1)
    return (img - img.mean(dim=dim, keepdim=True)) / img.std(dim=dim, correction=1, keepdim=True)


def inverse_affine_matrix(center_xy, angle_deg, translate_xy, scale, shear_xy_deg) -> torch.Tensor:
    """Inverse affine matrix mapping output (x, y) to input (x, y), in
    torchvision's ``_get_inverse_affine_matrix`` convention (reference
    dataset.py:233-238).

    Every argument may be a python float or a float32 tensor of batch
    shape ``(B,)``; pairs are given as ``(x, y)`` tuples of such values.
    Returns ``(..., 2, 3)`` float32 rows [[a, b, c], [d, e, f]] with
    in_x = a*x + b*y + c and in_y = d*x + e*y + f.
    """
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    cx, cy = f32(center_xy[0]), f32(center_xy[1])
    tx, ty = f32(translate_xy[0]), f32(translate_xy[1])
    rot = torch.deg2rad(f32(angle_deg))
    sx = torch.deg2rad(f32(shear_xy_deg[0]))
    sy = torch.deg2rad(f32(shear_xy_deg[1]))
    scale = f32(scale)

    # inverted rotation-shear-scale matrix (determinant 1 before scale)
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)

    m00 = d / scale
    m01 = -b / scale
    m10 = -c / scale
    m11 = a / scale
    m02 = m00 * (-cx - tx) + m01 * (-cy - ty) + cx
    m12 = m10 * (-cx - tx) + m11 * (-cy - ty) + cy
    m00, m01, m02, m10, m11, m12 = torch.broadcast_tensors(m00, m01, m02, m10, m11, m12)
    return torch.stack(
        [torch.stack([m00, m01, m02], -1), torch.stack([m10, m11, m12], -1)], -2
    )


def forward_affine_matrix(inv_matrix: torch.Tensor) -> torch.Tensor:
    """Invert ``(..., 2, 3)`` inverse-affine matrices to forward ones through
    a float32 3x3 inverse, as the JAX package does (reference
    dataset.py:238 computes A = inv(A_inv) for landmarks)."""
    last = torch.zeros(inv_matrix.shape[:-2] + (1, 3), dtype=inv_matrix.dtype, device=inv_matrix.device)
    last[..., 0, 2] = 1.0
    m = torch.cat([inv_matrix, last], dim=-2)
    # inv_ex: no host sync for the singularity check (these matrices are
    # rotation-shear-scale with scale >= 0.9, never singular)
    inv, _ = torch.linalg.inv_ex(m)
    return inv[..., :2, :]


def _mirror_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Whole-sample mirror reflection of integer indices into [0, n), for
    any distance: ``map_coordinates(mode='mirror')``'s index rule."""
    if n == 1:
        return torch.zeros_like(i)
    s = n - 1
    return torch.abs(torch.remainder(i + s, 2 * s) - s)


def affine_warp(
    img: torch.Tensor,
    inv_matrix: torch.Tensor,
    order: int = 1,
    out_shape: tuple[int, int] | None = None,
    out_offset_xy: tuple[float, float] = (0.0, 0.0),
) -> torch.Tensor:
    """Mirror-boundary bilinear (order 1) or nearest (order 0) affine warp:
    the plain version of the CUDA kernel in ``csrc/affine_warp.cu``.

    ``img`` is ``(H, W)`` or ``(B, H, W)``, ``inv_matrix`` is ``(2, 3)`` or
    ``(B, 2, 3)``. Each output pixel (x, y) samples the input at
    ``inv_matrix @ [x + ox + 0.5, y + oy + 0.5, 1] - 0.5`` (PIL's
    half-pixel convention, reference dataset.py:193-198). The output grid
    may extend past the input (``out_shape``, ``out_offset_xy``). Boundaries
    mirror without repeating the edge pixel (``mode='mirror'`` of JAX's
    ``map_coordinates``, which equals an np.pad 'reflect' pre-pad, and
    ``grid_sample(padding_mode='reflection', align_corners=True)``, which
    reflects about the centres of pixels 0 and n - 1; with
    ``align_corners=False`` it reflects about the outer edges and repeats
    the edge pixel; ``ops/warp.py::grid_sample_warp``).
    Order 0 takes ``floor(in + 0.5)`` like PIL and the Pallas kernel.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img, inv_matrix = img[None], inv_matrix[None]
    b, h, w = img.shape
    oh, ow = (h, w) if out_shape is None else (int(out_shape[0]), int(out_shape[1]))
    ox, oy = float(out_offset_xy[0]), float(out_offset_xy[1])
    dev = img.device
    img = img.to(torch.float32)
    m = inv_matrix.to(device=dev, dtype=torch.float32)

    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5 + ox)[None, None, :]
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5 + oy)[None, :, None]
    col = lambda k: m[:, k // 3, k % 3][:, None, None]  # noqa: E731
    in_x = col(0) * xs + col(1) * ys + col(2) - 0.5
    in_y = col(3) * xs + col(4) * ys + col(5) - 0.5

    flat = img.reshape(b, h * w)

    def tap(iy, ix):
        idx = _mirror_index(iy, h) * w + _mirror_index(ix, w)
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, oh, ow)

    if order == 0:
        out = tap(torch.floor(in_y + 0.5).long(), torch.floor(in_x + 0.5).long())
    elif order == 1:
        fy, fx = torch.floor(in_y), torch.floor(in_x)
        wy1, wx1 = in_y - fy, in_x - fx
        wy0, wx0 = 1 - wy1, 1 - wx1
        y0, x0 = fy.long(), fx.long()
        # the product and sum order of map_coordinates: (y0,x0), (y0,x1),
        # (y1,x0), (y1,x1), each weight_y * weight_x first
        out = (wy0 * wx0) * tap(y0, x0)
        out = out + (wy0 * wx1) * tap(y0, x0 + 1)
        out = out + (wy1 * wx0) * tap(y0 + 1, x0)
        out = out + (wy1 * wx1) * tap(y0 + 1, x0 + 1)
    else:
        raise ValueError("order must be 0 or 1, got {}".format(order))
    return out[0] if squeeze else out


def transform_landmarks(lands_xy: torch.Tensor, inv_matrix: torch.Tensor, bounds_hw) -> torch.Tensor:
    """Apply the forward affine to ``(..., 2, L)`` landmarks (row 0 = x,
    row 1 = y); out-of-bounds or non-finite landmarks become inf.

    Uses the corrected bounds check (the reference's dataset.py:245-247 has
    an axis-mixing ``<`` typo that marks nearly every augmented landmark
    out of bounds; the JAX package documents the same divergence)."""
    fwd = forward_affine_matrix(inv_matrix)
    x = lands_xy[..., 0, :]
    y = lands_xy[..., 1, :]
    finite = torch.isfinite(x) & torch.isfinite(y)
    xs = torch.where(finite, x, torch.zeros_like(x))
    ys = torch.where(finite, y, torch.zeros_like(y))
    f = lambda r, c: fwd[..., r, c, None]  # noqa: E731
    new_x = f(0, 0) * xs + f(0, 1) * ys + f(0, 2)
    new_y = f(1, 0) * xs + f(1, 1) * ys + f(1, 2)
    h, w = bounds_hw
    in_bounds = (new_x >= 0) & (new_x <= (w - 1)) & (new_y >= 0) & (new_y <= (h - 1))
    keep = finite & in_bounds
    inf = torch.full_like(new_x, math.inf)
    return torch.stack([torch.where(keep, new_x, inf), torch.where(keep, new_y, inf)], dim=-2)
