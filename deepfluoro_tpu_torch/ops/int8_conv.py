"""Exact s8 x s8 -> s32 convolutions for the int8 inference path (JAX
counterpart: the ``jax.lax.conv_general_dilated`` and ``conv_transpose``
calls with ``preferred_element_type=jnp.int32`` on int8 operands in
``deepfluoro_tpu/infer/quantized.py::_Engine``, which XLA lowers to the
TPU's integer matrix unit; no Pallas kernel).

PyTorch has no int8 convolution on CUDA, and a float32 cuDNN convolution
of integer-valued tensors is not exact: the widest 3x3 convolution of the
8x net sums 9 * 1024 products of up to 127^2, about 1.5e8, beyond
float32's 2^24. So a CUDA tensor takes an int8 im2col in NHWC and one
``torch._int_mm`` (cuBLASLt on the int8 tensor cores, int32 accumulation,
exact): the im2col is a strided view of the padded input copied into rows
of K = kh * kw * C, the weight a (N, K) matrix with K in the same (kh,
kw, C) order (``gemm_weight``). Zero padding is exact since zero
quantizes to zero; circular padding wraps, as the JAX engine pads before
its VALID convolution.

``torch._int_mm`` on CUDA takes M > 16 rows and K and N that are
multiples of 8, the weight column-major (``wmat.t()`` of a row-major (N,
K) matrix). Those that do not fit are zero-padded and the result sliced:
the first convolution has K = 9 (one input channel), the seg head N = 7,
``lands_1x1_0`` K = 32 + 7 and N = num_lands + n_classes = 21, a batch
of one small frame at the deepest level may have M <= 16. Zero rows and
columns add nothing to a sum, so padding keeps the product exact.

The plain version is a float64 ``F.conv2d`` / ``F.conv_transpose2d`` of
the integer values, cast to int32: exact, since no sum comes near 2^53.
cuDNN is switched off around it on a card (its FFT algorithms would not
be exact). CPU tensors go through it, as the tests do; a CUDA tensor
goes through ``_int_mm`` or the call raises, and nothing on the card's
main path calls the plain version.

The route is bound by bytes at the 8x net's early levels: the im2col
writes and the GEMM reads 9 bytes per input byte of a 3x3 layer, and the
int32 result is 4 bytes per output element against 2 of a bf16
convolution. ``int8_gemm_launches`` counts the ``_int_mm`` calls on CUDA
tensors, so a run can show that its convolutions took this route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm calls made on CUDA tensors by this module in this process
int8_gemm_launches = 0

_MIN_ROWS = 17  # torch._int_mm on CUDA: M > 16
_ALIGN = 8  # torch._int_mm on CUDA: K and N multiples of 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def gemm_weight(wq: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """The (N, K) int8 matrix of a convolution weight, zero-padded to
    multiples of 8, row-major: N = O and K in (kh, kw, I) order for an
    OIHW ``Conv2d`` weight; with ``transpose``, N = (kh, kw, O) and K = I
    for a ``ConvTranspose2d`` weight (I, O, kh, kw)."""
    if wq.dtype != torch.int8 or wq.ndim != 4:
        raise ValueError("weight must be a 4-D int8 tensor, got {} {}".format(tuple(wq.shape), wq.dtype))
    if transpose:
        i, o, kh, kw = wq.shape
        mat = wq.permute(2, 3, 1, 0).reshape(kh * kw * o, i)
    else:
        o, i, kh, kw = wq.shape
        mat = wq.permute(0, 2, 3, 1).reshape(o, kh * kw * i)
    n, k = mat.shape
    return F.pad(mat, (0, _round_up(k, _ALIGN) - k, 0, _round_up(n, _ALIGN) - n)).contiguous()


def _check(xq: torch.Tensor, wq: torch.Tensor):
    if xq.dtype != torch.int8 or xq.ndim != 4:
        raise ValueError("input must be a 4-D int8 NCHW tensor, got {} {}".format(tuple(xq.shape), xq.dtype))
    if wq.dtype != torch.int8 or wq.ndim != 4:
        raise ValueError("weight must be a 4-D int8 tensor, got {} {}".format(tuple(wq.shape), wq.dtype))
    if xq.device != wq.device:
        raise ValueError("input and weight lie on {} and {}".format(xq.device, wq.device))
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError("the int8 convolution runs on cpu or cuda tensors, got {}".format(xq.device))


def _gemm(a: torch.Tensor, wmat: torch.Tensor, n: int) -> torch.Tensor:
    """``a (M, K) int8 @ wmat[:n]^T`` as (M, n) int32 through
    ``torch._int_mm``, ``a`` zero-padded to wmat's K and to 17 rows."""
    global int8_gemm_launches
    m, k = a.shape
    kp = wmat.shape[1]
    if k > kp:
        raise ValueError("im2col has K = {} but the weight matrix {}".format(k, kp))
    if k < kp or m < _MIN_ROWS:
        a = F.pad(a, (0, kp - k, 0, max(0, _MIN_ROWS - m)))
    y = torch._int_mm(a, wmat.t())
    if a.device.type == "cuda":
        int8_gemm_launches += 1
    return y[:m, :n]


def _nhwc_padded(xq: torch.Tensor, padding, pad_mode: str) -> torch.Tensor:
    """``xq`` (B, C, H, W) as a contiguous NHWC tensor with the
    convolution's padding applied."""
    x = xq.permute(0, 2, 3, 1)
    ph, pw = _pair(padding)
    if ph == 0 and pw == 0:
        return x.contiguous()
    if pad_mode == "circular":
        x = torch.cat([x[:, x.shape[1] - ph :], x, x[:, :ph]], dim=1)
        return torch.cat([x[:, :, x.shape[2] - pw :], x, x[:, :, :pw]], dim=2).contiguous()
    if pad_mode != "zeros":
        raise ValueError("pad_mode must be 'zeros' or 'circular', got {!r}".format(pad_mode))
    return F.pad(x, (0, 0, pw, pw, ph, ph))


def im2col(xq: torch.Tensor, kernel, stride=1, padding=0, pad_mode: str = "zeros"):
    """The patches of int8 NCHW ``xq`` as rows: ``(a (B * Ho * Wo, kh * kw
    * C) int8, (Ho, Wo))``, each row in (kh, kw, C) order, padding
    applied. A 1x1 stride-1 convolution's rows are a view of the NHWC
    input; any other kernel's a strided view copied once."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    x = _nhwc_padded(xq, padding, pad_mode)
    b, hp, wp, c = x.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    if kh == kw == 1 and sh == sw == 1:
        return x.reshape(b * ho * wo, c), (ho, wo)
    s_b, s_h, s_w, s_c = x.stride()
    patches = x.as_strided((b, ho, wo, kh, kw, c), (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))
    return patches.reshape(b * ho * wo, kh * kw * c), (ho, wo)


def im2col_conv2d(xq, wq, stride=1, padding=0, pad_mode="zeros", wmat=None) -> torch.Tensor:
    """The card route of ``int8_conv2d`` on a tensor of either device (the
    CPU tests run it with the CPU's ``torch._int_mm``). ``wmat`` is
    ``gemm_weight(wq)``, made here when not given. Returns int32 (B, O,
    Ho, Wo), a view of an NHWC result."""
    o, i, kh, kw = wq.shape
    if xq.shape[1] != i:
        raise ValueError("input has {} channels, the weight {}".format(xq.shape[1], i))
    a, (ho, wo) = im2col(xq, (kh, kw), stride, padding, pad_mode)
    y = _gemm(a, gemm_weight(wq) if wmat is None else wmat, o)
    return y.reshape(xq.shape[0], ho, wo, o).permute(0, 3, 1, 2)


def im2col_conv_transpose2x2(xq, wq, wmat=None) -> torch.Tensor:
    """The card route of ``int8_conv_transpose2x2`` on a tensor of either
    device: one GEMM from I to (2, 2, O) per input pixel, then the pixel
    shuffle into (B, 2H, 2W, O). ``wmat`` is ``gemm_weight(wq,
    transpose=True)``. Returns int32 (B, O, 2H, 2W), a view of an NHWC
    result."""
    i, o, kh, kw = wq.shape
    if (kh, kw) != (2, 2) or xq.shape[1] != i:
        raise ValueError("weight {} does not fit a 2x2 stride-2 transposed convolution of {} channels".format(
            tuple(wq.shape), xq.shape[1]))
    b, _, h, w = xq.shape
    a = im2col(xq, 1)[0]
    y = _gemm(a, gemm_weight(wq, transpose=True) if wmat is None else wmat, 4 * o)
    y = y.reshape(b, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, o)
    return y.permute(0, 3, 1, 2)


def plain_conv2d(xq, wq, stride=1, padding=0, pad_mode="zeros") -> torch.Tensor:
    """The plain version: a float64 convolution of the integer values,
    exact, cast to int32 (B, O, Ho, Wo) contiguous."""
    x = xq.to(torch.float64)
    ph, pw = _pair(padding)
    if pad_mode == "circular" and (ph or pw):
        x = F.pad(x, (pw, pw, ph, ph), mode="circular")
        padding = 0
    elif pad_mode not in ("zeros", "circular"):
        raise ValueError("pad_mode must be 'zeros' or 'circular', got {!r}".format(pad_mode))
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x, wq.to(torch.float64), None, _pair(stride), _pair(padding))
    return y.to(torch.int32)


def plain_conv_transpose2x2(xq, wq) -> torch.Tensor:
    """The plain version of ``int8_conv_transpose2x2``: a float64
    transposed convolution, exact, cast to int32."""
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv_transpose2d(xq.to(torch.float64), wq.to(torch.float64), None, 2)
    return y.to(torch.int32)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0, pad_mode: str = "zeros",
                wmat: torch.Tensor | None = None) -> torch.Tensor:
    """s8 x s8 -> s32 convolution of int8 NCHW ``xq`` with int8 OIHW ``wq``
    (3x3 with zero or circular padding, 1x1, 2x2 stride 2; any stride,
    padding and kernel size the shapes allow). Returns int32 (B, O, Ho,
    Wo). A CPU tensor takes the plain version; a CUDA tensor the im2col
    and ``torch._int_mm``, with ``wmat`` the cached ``gemm_weight(wq)``."""
    _check(xq, wq)
    if xq.device.type == "cpu":
        return plain_conv2d(xq, wq, stride, padding, pad_mode)
    return im2col_conv2d(xq, wq, stride, padding, pad_mode, wmat)


def int8_conv_transpose2x2(xq: torch.Tensor, wq: torch.Tensor, wmat: torch.Tensor | None = None) -> torch.Tensor:
    """s8 x s8 -> s32 2x2 stride-2 transposed convolution of int8 NCHW
    ``xq`` with an int8 ``ConvTranspose2d`` weight (I, O, 2, 2). Returns
    int32 (B, O, 2H, 2W); devices as ``int8_conv2d``, with ``wmat`` the
    cached ``gemm_weight(wq, transpose=True)``."""
    _check(xq, wq)
    if xq.device.type == "cpu":
        return plain_conv_transpose2x2(xq, wq)
    return im2col_conv_transpose2x2(xq, wq, wmat)
