"""SAMed (Zhang & Liu 2023, arXiv:2304.13785; github.com/hitachinsk/SAMed)
over SAM ViT-B (Kirillov et al. 2023, arXiv:2304.02643;
``segment_anything/build_sam.py::build_sam_vit_b``,
``modeling/image_encoder.py``, ``prompt_encoder.py``,
``mask_decoder.py``, ``transformer.py``, ``common.py``) as plain
functions of a state dict, for the benchmark's comparison that decides
``correct`` and for the CPU tests. It imports neither JAX nor the
program.

Keys are SAM's module names with SAMed's ``_LoRA_qkv`` (``image_encoder.
{patch_embed.proj,pos_embed,blocks.{i}.{norm1,norm2,attn.{qkv.{qkv,
linear_a_q,linear_b_q,linear_a_v,linear_b_v},proj,rel_pos_h,rel_pos_w},
mlp.{lin1,lin2}},neck.{0,1,2,3}}``, ``prompt_encoder.{pe_layer.
positional_encoding_gaussian_matrix,no_mask_embed}``, ``mask_decoder.
{transformer,iou_token,mask_tokens,output_upscaling,
output_hypernetworks_mlps}``) and the landmark head's ``lands_1x1.{j}``.
Widths, depths and the tokens are read from the state dict's shapes;
``cfg`` gives ``num_heads``, ``sam_window_size``,
``sam_global_attn_indexes`` and ``sam_decoder_heads``.

As published: the 1-channel input repeated to 3 channels (SAMed's pixel
mean 0 and std 1); the 16x16 stride-16 patch embedding with bias and the
absolute ``pos_embed``; each block ``x + attn(LN(x))``, ``x + MLP(LN(x))``
(LN eps 1e-6, exact GELU); in a windowed block the LayerNorm's output
zero-padded at the bottom and right to whole windows, cut into windows,
and the padding cut off after; the attention written out as
``softmax((q / sqrt(d)) @ k^T + rel_h[..., None] + rel_w[..., None, :])
@ v`` over the 4D (q_h, q_w, k_h, k_w) logits, ``rel_h`` and ``rel_w``
the products of the unscaled q with the tables gathered at ``i - j + s -
1``, padded keys unmasked; q and v with LoRA ``b(a(x))`` added; the neck
(1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d, eps 1e-6); the random
Fourier positional encoding of the cell centres; the no-mask dense
embedding; the two-way transformer (the first block's self-attention
without PE and residual; cross attentions at half width; LN eps 1e-5;
ReLU MLP), the final token-to-image attention and its LayerNorm, each
attention written out as ``softmax(q k^T / sqrt(d)) v``; the upscaling
(transposed 2x2 convolutions, LayerNorm2d, GELU); the hypernetwork MLPs
and ``hyper_in @ upscaled``; the bilinear resize (``align_corners=False``)
to the input's side. Departures, as the program makes them: every mask
token's mask (background first) and their softmax; the landmark head (two
bias-free 1x1 convolutions over [upscaled, low-res masks], resized with
the masks); the IoU head is not run.

``Numerics`` is ``unet.Numerics``: with ``tf32`` every convolution and
matrix product runs at TF32 precision (on the card cuDNN's and cuBLAS's
switch; on the CPU the operands rounded first).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fluorobench.reference import infer as ref_infer
from fluorobench.reference import unet
from fluorobench.reference.unet import Numerics

ENC = "image_encoder."
DEC = "mask_decoder."
PATCH = 16
IN_CHANS = 3


def _mm(num: Numerics, a, b):
    if num.tf32 and a.device.type == "cpu":
        a, b = unet.round_tf32(a), unet.round_tf32(b)
    return a @ b


def _linear(num, p, key, x):
    y = _mm(num, x, p[key + ".weight"].T)
    return y + p[key + ".bias"] if key + ".bias" in p else y


def _layer_norm(x, weight, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def _ln(p, key, x, eps):
    return _layer_norm(x, p[key + ".weight"], p[key + ".bias"], eps)


def _ln2d(p, key, x):
    """LayerNorm2d over the channels of (b, c, h, w), eps 1e-6."""
    u = x.mean(dim=1, keepdim=True)
    s = ((x - u) ** 2).mean(dim=1, keepdim=True)
    return p[key + ".weight"][:, None, None] * ((x - u) / torch.sqrt(s + 1e-6)) + p[key + ".bias"][:, None, None]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def rel_index(size: int) -> torch.Tensor:
    """``get_rel_pos``'s (size, size) indices for equal query and key
    sizes: ``i - j + size - 1``."""
    q = torch.arange(size)[:, None]
    k = torch.arange(size)[None, :]
    return (q - k) + (size - 1)


def encoder_attention(num, p, key, x, heads):
    """SAM's ``Attention`` with decomposed relative positions on x (b, h,
    w, c), written out."""
    b, h, w, c = x.shape
    d = c // heads
    qkv = _linear(num, p, key + ".qkv.qkv", x)
    qkv[..., :c] = qkv[..., :c] + _linear(num, p, key + ".qkv.linear_b_q", _linear(num, p, key + ".qkv.linear_a_q", x))
    qkv[..., -c:] = qkv[..., -c:] + _linear(num, p, key + ".qkv.linear_b_v",
                                            _linear(num, p, key + ".qkv.linear_a_v", x))
    qkv = qkv.reshape(b, h * w, 3, heads, d).permute(2, 0, 3, 1, 4).reshape(3, b * heads, h * w, d)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = _mm(num, q * d**-0.5, k.transpose(-2, -1))
    rh = p[key + ".rel_pos_h"][rel_index(h).to(x.device)]
    rw = p[key + ".rel_pos_w"][rel_index(w).to(x.device)]
    r_q = q.reshape(b * heads, h, w, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(
        b * heads, h * w, h * w)
    attn = torch.softmax(attn, dim=-1)
    out = _mm(num, attn, v).view(b, heads, h, w, d).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
    return _linear(num, p, key + ".proj", out)


def window_partition(x, ws):
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws, pad_hw, hw):
    (hp, wp), (h, w) = pad_hw, hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


def encoder_block(num, p, key, x, heads, window):
    shortcut = x
    x = _ln(p, key + ".norm1", x, 1e-6)
    if window > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window)
    x = encoder_attention(num, p, key + ".attn", x, heads)
    if window > 0:
        x = window_unpartition(x, window, pad_hw, (h, w))
    x = shortcut + x
    y = _gelu(_linear(num, p, key + ".mlp.lin1", _ln(p, key + ".norm2", x, 1e-6)))
    return x + _linear(num, p, key + ".mlp.lin2", y)


def image_encoder(num, p, x, cfg):
    """(b, 3, S, S) -> the neck's (b, 256, g, g)."""
    x = unet._conv(num, x, p[ENC + "patch_embed.proj.weight"], p[ENC + "patch_embed.proj.bias"], PATCH)
    x = x.permute(0, 2, 3, 1) + p[ENC + "pos_embed"]
    i = 0
    while "{}blocks.{}.norm1.weight".format(ENC, i) in p:
        window = 0 if i in cfg["sam_global_attn_indexes"] else cfg["sam_window_size"]
        x = encoder_block(num, p, "{}blocks.{}".format(ENC, i), x, cfg["num_heads"], window)
        i += 1
    x = x.permute(0, 3, 1, 2)
    x = _ln2d(p, ENC + "neck.1", unet._conv(num, x, p[ENC + "neck.0.weight"]))
    return _ln2d(p, ENC + "neck.3", unet._conv(num, x, p[ENC + "neck.2.weight"], None, 1, 1))


def dense_pe(num, p, g: int):
    """``PositionEmbeddingRandom`` of a g x g grid: (C, g, g)."""
    gauss = p["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    grid = torch.ones((g, g), device=gauss.device, dtype=gauss.dtype)
    y = (grid.cumsum(dim=0) - 0.5) / g
    x = (grid.cumsum(dim=1) - 0.5) / g
    coords = 2 * torch.stack([x, y], dim=-1) - 1
    coords = 2 * math.pi * _mm(num, coords, gauss)
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1).permute(2, 0, 1)


def two_way_attention(num, p, key, q, k, v, heads):
    """``transformer.py::Attention``, written out."""
    q, k, v = (_linear(num, p, key + suffix, t) for suffix, t in (("q_proj", q), ("k_proj", k), ("v_proj", v)))

    def separate(t):
        b, n, c = t.shape
        return t.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = separate(q), separate(k), separate(v)
    attn = torch.softmax(_mm(num, q, k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1]), dim=-1)
    out = _mm(num, attn, v).transpose(1, 2)
    return _linear(num, p, key + "out_proj", out.reshape(out.shape[0], out.shape[1], -1))


def two_way_transformer(num, p, image_embedding, image_pe, point_embedding, heads):
    key = DEC + "transformer."
    keys = image_embedding.flatten(2).permute(0, 2, 1)
    image_pe = image_pe.flatten(2).permute(0, 2, 1)
    queries = point_embedding
    j = 0
    while "{}layers.{}.norm1.weight".format(key, j) in p:
        lk = "{}layers.{}.".format(key, j)
        if j == 0:
            queries = two_way_attention(num, p, lk + "self_attn.", queries, queries, queries, heads)
        else:
            q = queries + point_embedding
            queries = queries + two_way_attention(num, p, lk + "self_attn.", q, q, queries, heads)
        queries = _ln(p, lk + "norm1", queries, 1e-5)
        q, k = queries + point_embedding, keys + image_pe
        queries = _ln(p, lk + "norm2", queries + two_way_attention(num, p, lk + "cross_attn_token_to_image.", q, k,
                                                                    keys, heads), 1e-5)
        mlp = _linear(num, p, lk + "mlp.lin2", torch.relu(_linear(num, p, lk + "mlp.lin1", queries)))
        queries = _ln(p, lk + "norm3", queries + mlp, 1e-5)
        q, k = queries + point_embedding, keys + image_pe
        keys = _ln(p, lk + "norm4", keys + two_way_attention(num, p, lk + "cross_attn_image_to_token.", k, q,
                                                              queries, heads), 1e-5)
        j += 1
    attn = two_way_attention(num, p, key + "final_attn_token_to_image.", queries + point_embedding, keys + image_pe,
                             keys, heads)
    return _ln(p, key + "norm_final_attn", queries + attn, 1e-5), keys


def hyper_mlp(num, p, key, x):
    j = 0
    while "{}.layers.{}.weight".format(key, j + 1) in p:
        x = torch.relu(_linear(num, p, "{}.layers.{}".format(key, j), x))
        j += 1
    return _linear(num, p, "{}.layers.{}".format(key, j), x)


def forward(p: dict, x: torch.Tensor, cfg: dict, num: Numerics):
    """(class probabilities (B, C, S, S), heatmaps (B, L, S, S)) of ``x``
    (B, 1, S, S) under the state dict ``p`` (tensors in ``num.dtype``)."""
    side = x.shape[-2:]
    emb = image_encoder(num, p, x.repeat(1, IN_CHANS, 1, 1), cfg)
    b, c, g, _ = emb.shape
    src = emb + p["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1)
    tokens = torch.cat([p[DEC + "iou_token.weight"], p[DEC + "mask_tokens.weight"]], dim=0)
    tokens = tokens.unsqueeze(0).expand(b, -1, -1)
    hs, src = two_way_transformer(num, p, src, dense_pe(num, p, g).unsqueeze(0), tokens, cfg["sam_decoder_heads"])
    src = src.transpose(1, 2).reshape(b, c, g, g)
    up = DEC + "output_upscaling."
    y = unet._conv(num, src, p[up + "0.weight"], p[up + "0.bias"], 2, transposed=True)
    y = _gelu(_ln2d(p, up + "1", y))
    upscaled = _gelu(unet._conv(num, y, p[up + "3.weight"], p[up + "3.bias"], 2, transposed=True))
    n_tokens = p[DEC + "mask_tokens.weight"].shape[0]
    hyper_in = torch.stack([hyper_mlp(num, p, "{}output_hypernetworks_mlps.{}".format(DEC, i), hs[:, 1 + i])
                            for i in range(n_tokens)], dim=1)
    bb, cc, hh, ww = upscaled.shape
    masks = _mm(num, hyper_in, upscaled.view(bb, cc, hh * ww)).view(bb, -1, hh, ww)
    h = torch.cat([upscaled, masks], dim=1)
    j = 0
    while "lands_1x1.{}.weight".format(j) in p:
        h = unet._conv(num, h, p["lands_1x1.{}.weight".format(j)])
        j += 1
    seg = torch.softmax(F.interpolate(masks, side, mode="bilinear", align_corners=False), dim=1)
    return seg, F.interpolate(h, side, mode="bilinear", align_corners=False)


@torch.no_grad()
def ensemble(members, frames, rots, cfg: dict, num: Numerics):
    """``reference/infer.py::ensemble`` of SAMed members: (mean
    probabilities (B, C, h, w), mean heats (B, L, h, w), labels (B, h,
    w))."""
    with num.scope():
        x = ref_infer.prep(frames, rots, cfg["ds_factor"], cfg["proj_unet_dim"], num)
        n = ref_infer.crop_size(frames.shape[-1], cfg["ds_factor"])
        prob = heat = None
        for p in members:
            seg, h = forward(p, x, cfg, num)
            seg, h = unet.center_crop(seg, (n, n)), unet.center_crop(h, (n, n))
            lo, hi = h.amin(dim=(1, 2, 3), keepdim=True), h.amax(dim=(1, 2, 3), keepdim=True)
            h = (h - lo) / (hi - lo)
            prob = seg if prob is None else prob + seg
            heat = h if heat is None else heat + h
    prob, heat = prob / len(members), heat / len(members)
    return prob, heat, prob.argmax(dim=1)
