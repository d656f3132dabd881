"""Operations and bytes of TransUNet R50-ViT worked out from a
configuration's shapes alone (``reference/transunet.py``'s layer
equations), with ``counts.py``'s convention: 2 operations per
multiply-add of every convolution, linear layer and attention product,
as ``torch.utils.flop_counter`` counts them; normalization, softmax,
GELU, pooling, upsampling and weight standardisation are not counted.

``attention_bound_s`` is one attention call's least time on an H100: the
longer of its operations (4 B H N^2 d_head) at the dense TF32 tensor-core
peak (494.7 TFLOP/s; a float32-accurate kernel may be built of TF32
passes, as the memory-efficient kernel's "fast f32" is) and its least
bytes (Q, K and V read and the output written once, float32) at 3.35
TB/s.
"""

from __future__ import annotations

from fluorobench.counts import HBM_BYTES_PER_S, conv_flops

TF32_FLOPS_PER_S = 494.7e12  # dense TF32 tensor cores, H100 SXM at 700 W
HEAD_CHANNELS = 512  # the decoder's first convolution
GRID_STRIDE = 16


def _down(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def resnet_flops(cfg: dict, size: int) -> tuple[int, int]:
    """(operations of the root and the three stages, the last stage's
    side) for a ``size`` x ``size`` input."""
    w = cfg["resnet_width"]
    h = _down(size, 7, 2, 3)
    total = conv_flops(3, w, 7, h, h)
    h = _down(h, 3, 2, 0)  # the max pool
    cin = w
    for s, units in enumerate(cfg["resnet_units"]):
        cmid, stride = w * 2**s, 1 if s == 0 else 2
        cout = 4 * cmid
        for u in range(units):
            h_in, st = h, stride if u == 0 else 1
            h = _down(h_in, 3, st, 1)
            total += conv_flops(cin, cmid, 1, h_in, h_in) + conv_flops(cmid, cmid, 3, h, h)
            total += conv_flops(cmid, cout, 1, h, h)
            if st != 1 or cin != cout:
                total += conv_flops(cin, cout, 1, h, h)
            cin = cout
    return total, h


def block_flops(cfg: dict, tokens: int) -> tuple[int, int]:
    """(operations of one transformer block's linear layers, of its two
    attention products) over ``tokens`` tokens of one frame."""
    d, m = cfg["hidden_size"], cfg["mlp_dim"]
    return 2 * tokens * d * (4 * d + 2 * m), 4 * tokens * tokens * d


def decoder_flops(cfg: dict, grid: int) -> int:
    """The cascaded decoder's, the class head's and the landmark head's
    operations from a ``grid`` x ``grid`` token map."""
    w, chans, c, lands = cfg["resnet_width"], cfg["decoder_channels"], cfg["num_classes"], cfg["num_lands"]
    skips = [s if i < cfg["n_skip"] else 0 for i, s in enumerate((8 * w, 4 * w, w, 0))]
    total = conv_flops(cfg["hidden_size"], HEAD_CHANNELS, 3, grid, grid)
    h, cin = grid, HEAD_CHANNELS
    for cout, skip in zip(chans, skips):
        h *= 2
        total += conv_flops(cin + skip, cout, 3, h, h) + conv_flops(cout, cout, 3, h, h)
        cin = cout
    total += conv_flops(cin, c, 3, h, h)
    if lands > 0:
        total += conv_flops(cin + c, lands + c, 1, h, h) + conv_flops(lands + c, lands, 1, h, h)
    return total


def transunet_forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one ``size`` x ``size`` frame."""
    resnet, g = resnet_flops(cfg, size)
    if g * GRID_STRIDE != size:
        raise ValueError("a {}^2 input gives a {}^2 grid, not size / {}".format(size, g, GRID_STRIDE))
    linear, attention = block_flops(cfg, g * g)
    embed = conv_flops(16 * cfg["resnet_width"], cfg["hidden_size"], 1, g, g)
    return resnet + embed + cfg["num_layers"] * (linear + attention) + decoder_flops(cfg, g)


def attention_bytes(cfg: dict, batch: int, tokens: int) -> int:
    return 4 * 4 * batch * tokens * cfg["hidden_size"]


def attention_bound_s(cfg: dict, batch: int, tokens: int) -> float:
    """One attention call's least time on the batch: compute or bytes,
    whichever is longer."""
    flops = 4 * batch * tokens * tokens * cfg["hidden_size"]
    return max(flops / TF32_FLOPS_PER_S, attention_bytes(cfg, batch, tokens) / HBM_BYTES_PER_S)
