"""Operations and bytes of Swin UNETR in 2D worked out from a
configuration's shapes alone (``reference/swinunetr.py``'s layer
equations), with ``counts.py``'s convention: 2 operations per
multiply-add of every convolution, transposed convolution, linear layer
and attention product, as ``torch.utils.flop_counter`` counts them;
normalization, activations, softmax, the bias and mask adds, pads, rolls
and window permutations are not counted.

``window_attention_bound_s`` is one forward's least time in the window
attention on an H100: the sum over the blocks of the longer of each
block's operations (4 B windows n^2 C) at the dense TF32 tensor-core peak
(494.7 TFLOP/s; the float32-accurate memory-efficient kernel is bound by
no faster path) and its least bytes at 3.35 TB/s: Q, K and V read and the
output written once, float32, plus the block's (heads, n, n) bias and a
shifted block's (windows, n, n) mask read once.
"""

from __future__ import annotations

from fluorobench.counts import HBM_BYTES_PER_S, conv_flops
from fluorobench.counts_transunet import TF32_FLOPS_PER_S

PATCH_SIZE = 2
MLP_RATIO = 4
BYTES = 4  # float32


def window_of(side: int, window: int) -> tuple[int, bool]:
    """(the window, whether the odd blocks shift) on a ``side`` grid: a
    side at or under the window makes the window that side, unshifted."""
    return (side, False) if side <= window else (window, True)


def stages(cfg: dict, size: int) -> list[dict]:
    """Each stage's ``side``, ``dim``, ``heads``, ``depth``, ``window``,
    ``windows`` (per frame, of the padded grid) and ``shifted``."""
    out, side = [], size // PATCH_SIZE
    for i, (depth, heads) in enumerate(zip(cfg["swin_depths"], cfg["swin_heads"])):
        window, shifted = window_of(side, cfg["window_size"])
        per_side = -(-side // window)
        out.append(dict(side=side, dim=cfg["feature_size"] * 2**i, heads=heads, depth=depth, window=window,
                        windows=per_side * per_side, shifted=shifted))
        side //= 2
    return out


def swin_flops(cfg: dict, size: int) -> tuple[int, int]:
    """(operations of the patch embedding, the blocks' linear layers and
    the merges; of the window attention's two products) of one frame."""
    f = cfg["feature_size"]
    linear = conv_flops(1, f, PATCH_SIZE, size // PATCH_SIZE, size // PATCH_SIZE)
    attention = 0
    for s in stages(cfg, size):
        c, tokens, n = s["dim"], s["windows"] * s["window"] ** 2, s["window"] ** 2
        # qkv and proj on every padded token, the MLP on the grid's
        linear += s["depth"] * (2 * tokens * c * 4 * c + 2 * s["side"] ** 2 * c * 2 * MLP_RATIO * c)
        attention += s["depth"] * 4 * s["windows"] * n * n * c
        half = s["side"] // 2
        linear += 2 * half * half * 4 * c * 2 * c
    return linear, attention


def res_block_flops(cin: int, cout: int, side: int) -> int:
    total = conv_flops(cin, cout, 3, side, side) + conv_flops(cout, cout, 3, side, side)
    return total + (conv_flops(cin, cout, 1, side, side) if cin != cout else 0)


def conv_side_flops(cfg: dict, size: int) -> int:
    """The conv encoders', the up blocks', the out block's and the
    landmark head's operations on one frame."""
    f, c, lands = cfg["feature_size"], cfg["num_classes"], cfg["num_lands"]
    sides = [size // 2**i for i in range(6)]  # 736, 368, 184, 92, 46, 23
    total = res_block_flops(1, f, sides[0]) + res_block_flops(f, f, sides[1])
    total += res_block_flops(2 * f, 2 * f, sides[2]) + res_block_flops(4 * f, 4 * f, sides[3])
    total += res_block_flops(16 * f, 16 * f, sides[5])
    ups = [(16 * f, 8 * f), (8 * f, 4 * f), (4 * f, 2 * f), (2 * f, f), (f, f)]
    for level, (cin, cout) in zip(range(4, -1, -1), ups):
        # each input pixel meets the 2x2 kernel once: Cin x Cout x 4 per pixel
        total += conv_flops(cin, cout, 2, sides[level + 1], sides[level + 1])
        total += res_block_flops(2 * cout, cout, sides[level])
    total += conv_flops(f, c, 1, size, size)
    if lands > 0:
        total += conv_flops(f + c, lands + c, 1, size, size) + conv_flops(lands + c, lands, 1, size, size)
    return total


def swinunetr_forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one ``size`` x ``size`` frame."""
    if size % (PATCH_SIZE * 16):
        raise ValueError("a {}^2 input does not divide by {}".format(size, PATCH_SIZE * 16))
    linear, attention = swin_flops(cfg, size)
    return linear + attention + conv_side_flops(cfg, size)


def window_attention_bytes(cfg: dict, batch: int, size: int) -> int:
    """The least bytes of one forward's window attention over the
    blocks."""
    total = 0
    for s in stages(cfg, size):
        n = s["window"] ** 2
        qkvo = 4 * batch * s["windows"] * n * s["dim"]
        for block in range(s["depth"]):
            total += qkvo + s["heads"] * n * n + (s["windows"] * n * n if s["shifted"] and block % 2 else 0)
    return BYTES * total


def window_attention_bound_s(cfg: dict, batch: int, size: int) -> float:
    """One forward's least time in the window attention: the sum over the
    blocks of compute or bytes, whichever is longer."""
    total = 0.0
    for s in stages(cfg, size):
        n = s["window"] ** 2
        flops = 4 * batch * s["windows"] * n * n * s["dim"]
        qkvo = 4 * batch * s["windows"] * n * s["dim"]
        for block in range(s["depth"]):
            nbytes = BYTES * (qkvo + s["heads"] * n * n + (s["windows"] * n * n if s["shifted"] and block % 2 else 0))
            total += max(flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return total
