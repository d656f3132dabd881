"""Operations and bytes of SAMed over SAM ViT-B worked out from a
configuration's shapes alone (``reference/samed.py``'s layer equations),
with ``counts.py``'s convention: 2 operations per multiply-add of every
convolution, transposed convolution, linear layer (LoRA's included),
attention product, decomposed relative-position product, the positional
encoding's product and the masks' product, as ``torch.utils.flop_counter``
counts them; normalization, activations, softmax, the mask and bias adds,
pads, window permutations and the bilinear resizes are not counted. As
the published forward runs it: ``qkv``, LoRA, ``proj`` and the attention
of a windowed block run over the padded windows' tokens; the MLP over the
grid's; the IoU head is not run.

``rel_pos_attention_bound_s`` is one forward's least time in the encoder
blocks' attention on an H100: the sum over the blocks of the longer of
each block's operations (the two attention products, 4 n^2 C a window,
and the two decomposed terms, 2 n s d a head and window each) at the
dense TF32 tensor-core peak (494.7 TFLOP/s, as ``counts_transunet.py``'s
bound; the float32-accurate memory-efficient kernel is bound by no faster
path) and its least bytes at 3.35 TB/s: Q, K and V read and the output
written once, and the two decomposed terms (n s a head and window each)
read once, float32. The n^2 mask the program builds from the two terms is
not counted: a kernel that adds them in place needs no such mask, and
reads on the same yardstick.
"""

from __future__ import annotations

from fluorobench.counts import HBM_BYTES_PER_S, conv_flops
from fluorobench.counts_transunet import TF32_FLOPS_PER_S

PATCH_SIZE = 16
IN_CHANS = 3
HYPER_LAYERS = 3
BYTES = 4  # float32


def blocks(cfg: dict, size: int) -> list[dict]:
    """Each encoder block's ``side`` (of its attention's grid),
    ``windows`` (per frame) and ``n`` (tokens a window)."""
    if size % PATCH_SIZE:
        raise ValueError("a {}^2 input does not divide by {}".format(size, PATCH_SIZE))
    g, w = size // PATCH_SIZE, cfg["sam_window_size"]
    out = []
    for i in range(cfg["num_layers"]):
        if i in cfg["sam_global_attn_indexes"]:
            out.append(dict(side=g, windows=1, n=g * g))
        else:
            per_side = -(-g // w)
            out.append(dict(side=w, windows=per_side * per_side, n=w * w))
    return out


def _attention_flops(cfg: dict, b: dict) -> int:
    """One frame's attention products and decomposed terms in a block."""
    c, heads = cfg["hidden_size"], cfg["num_heads"]
    d = c // heads
    return b["windows"] * (4 * b["n"] ** 2 * c + 2 * 2 * heads * b["n"] * b["side"] * d)


def encoder_flops(cfg: dict, size: int) -> tuple[int, int]:
    """(operations of the patch embedding, the blocks' linear layers and
    the neck; of the blocks' attention and decomposed terms) of one
    frame."""
    g, c, r, out = size // PATCH_SIZE, cfg["hidden_size"], cfg["lora_rank"], cfg["sam_prompt_dim"]
    linear = conv_flops(IN_CHANS, c, PATCH_SIZE, g, g)
    attention = 0
    for b in blocks(cfg, size):
        tokens = b["windows"] * b["n"]
        # qkv, proj and LoRA's four rank-r products on every padded token
        linear += 2 * tokens * c * 4 * c + 4 * 2 * tokens * c * r
        linear += 2 * g * g * c * 2 * cfg["mlp_dim"]
        attention += _attention_flops(cfg, b)
    linear += conv_flops(c, out, 1, g, g) + conv_flops(out, out, 3, g, g)
    return linear, attention


def _two_way_attention_flops(nq: int, nk: int, dim: int, internal: int) -> int:
    return 2 * nq * dim * internal + 2 * 2 * nk * dim * internal + 4 * nq * nk * internal + 2 * nq * internal * dim


def decoder_flops(cfg: dict, size: int) -> int:
    """The positional encoding's, the two-way transformer's, the
    upscaling's, the hypernetworks', the masks' and the landmark head's
    operations on one frame."""
    g, dim = size // PATCH_SIZE, cfg["sam_prompt_dim"]
    classes, lands, mlp = cfg["num_classes"], cfg["num_lands"], cfg["sam_decoder_mlp_dim"]
    tokens, n, half = classes + 1, g * g, dim // 2
    total = 2 * n * 2 * (dim // 2)
    for _ in range(cfg["sam_decoder_depth"]):
        total += _two_way_attention_flops(tokens, tokens, dim, dim)
        total += _two_way_attention_flops(tokens, n, dim, half)
        total += 2 * tokens * dim * mlp * 2
        total += _two_way_attention_flops(n, tokens, dim, half)
    total += _two_way_attention_flops(tokens, n, dim, half)
    # each input pixel meets the 2x2 kernel once: Cin x Cout x 4 per pixel
    total += conv_flops(dim, dim // 4, 2, g, g) + conv_flops(dim // 4, dim // 8, 2, 2 * g, 2 * g)
    total += classes * 2 * (dim * dim * (HYPER_LAYERS - 1) + dim * dim // 8)
    side = 4 * g
    total += 2 * classes * dim // 8 * side * side
    if lands > 0:
        total += conv_flops(dim // 8 + classes, lands + classes, 1, side, side)
        total += conv_flops(lands + classes, lands, 1, side, side)
    return total


def samed_forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one ``size`` x ``size`` frame."""
    linear, attention = encoder_flops(cfg, size)
    return linear + attention + decoder_flops(cfg, size)


def _block_bytes(cfg: dict, batch: int, b: dict) -> int:
    c, heads = cfg["hidden_size"], cfg["num_heads"]
    per_window = 4 * b["n"] * c + 2 * heads * b["n"] * b["side"]
    return BYTES * batch * b["windows"] * per_window


def rel_pos_attention_bytes(cfg: dict, batch: int, size: int) -> int:
    """The least bytes of one forward's encoder attention over the
    blocks."""
    return sum(_block_bytes(cfg, batch, b) for b in blocks(cfg, size))


def rel_pos_attention_bound_s(cfg: dict, batch: int, size: int) -> float:
    """One forward's least time in the encoder attention: the sum over the
    blocks of compute or bytes, whichever is longer."""
    return sum(max(batch * _attention_flops(cfg, b) / TF32_FLOPS_PER_S, _block_bytes(cfg, batch, b) / HBM_BYTES_PER_S)
               for b in blocks(cfg, size))
