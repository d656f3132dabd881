"""TransUNet R50-ViT as plain functions of a state dict (Chen et al. 2021,
arXiv:2102.04306; github.com/Beckschen/TransUNet ``networks/
vit_seg_modeling.py`` and ``networks/vit_seg_modeling_resnet_skip.py``),
for the benchmark's comparison that decides ``correct``.

Keys are the published module names (``transformer.embeddings.
hybrid_model.{root,body}``, ``transformer.embeddings.{patch_embeddings,
position_embeddings}``, ``transformer.encoder.layer.{i}.{attention_norm,
attn.{query,key,value,out},ffn_norm,ffn.{fc1,fc2}}``,
``transformer.encoder.encoder_norm``, ``decoder.conv_more``,
``decoder.blocks.{k}.{conv1,conv2}``, ``segmentation_head.0``) and the
landmark head's ``lands_1x1.{j}``. Depth, widths and skips are read from
the state dict's shapes; ``cfg`` gives ``num_heads``, ``gn_groups`` and
``n_skip``.

As published: the 1-channel input repeated to 3; weight-standardised
convolutions (each output channel's weight less its mean over input
channels and kernel, over sqrt(biased variance + 1e-5)); GroupNorm(32,
eps 1e-6), and on a projected shortcut GroupNorm(cout, cout) at eps 1e-5;
the root's 3x3 stride-2 max pool with no padding; a stage's skip
zero-padded at the bottom and right to size / 4 / (i + 1); pre-LayerNorm
blocks (eps 1e-6) with the attention written out as softmax(Q K^T /
sqrt(d_head)) V and exact GELU; the decoder's bilinear x2 upsampling with
aligned corners, written out as two interpolation matrices;
Conv3x3-BatchNorm(eps 1e-5)-ReLU; the Conv3x3 class head.
Departures, as the program makes them: the softmax of the logits and the
landmark head (two bias-free 1x1 convolutions over [features, logits]).
Dropout is left out: the benchmark runs the net in eval mode, and
``train`` here means BatchNorm's batch statistics, which ``stats``
collects per layer key as (mean, biased variance) for calibration.

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

ROOT = "transformer.embeddings.hybrid_model."
LAYER = "transformer.encoder.layer.{}."


def _mm(num: Numerics, a, b):
    if num.tf32 and a.device.type == "cpu":
        a, b = unet.round_tf32(a), unet.round_tf32(b)
    return a @ b


def _linear(num, p, key, x):
    return _mm(num, x, p[key + ".weight"].T) + p[key + ".bias"]


def _std_conv(num, p, key, x, stride=1, padding=0):
    w = p[key + ".weight"]
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    return unet._conv(num, x, (w - mean) / torch.sqrt(var + 1e-5), None, stride, padding)


def _group_norm(p, key, x, groups, eps):
    b = x.shape[0]
    g = x.reshape(b, groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=-1, keepdim=True)
    x = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return x * p[key + ".weight"][:, None, None] + p[key + ".bias"][:, None, None]


def _layer_norm(p, key, x, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[key + ".weight"] + p[key + ".bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _upsample_matrix(n: int, dtype, device):
    """(2n, n) weights of the x2 linear resize with aligned corners."""
    src = torch.arange(2 * n, dtype=torch.float64) * ((n - 1) / (2 * n - 1))
    lo = src.floor().clamp(max=n - 1).long()
    hi = (lo + 1).clamp(max=n - 1)
    frac = src - lo
    m = torch.zeros(2 * n, n, dtype=torch.float64)
    m[torch.arange(2 * n), lo] += 1 - frac
    m[torch.arange(2 * n), hi] += frac
    return m.to(device, dtype)


def _upsample(x):
    wr = _upsample_matrix(x.shape[-2], x.dtype, x.device)
    wc = _upsample_matrix(x.shape[-1], x.dtype, x.device)
    return wr @ x @ wc.T


def _units(p, stage: int) -> int:
    n = 0
    while ROOT + "body.block{}.unit{}.conv1.weight".format(stage, n + 1) in p:
        n += 1
    return n


def _bottleneck(num, p, key, x, stride, groups):
    if key + ".downsample.weight" in p:
        shortcut = _std_conv(num, p, key + ".downsample", x, stride)
        shortcut = _group_norm(p, key + ".gn_proj", shortcut, shortcut.shape[1], 1e-5)
    else:
        shortcut = x
    y = torch.relu(_group_norm(p, key + ".gn1", _std_conv(num, p, key + ".conv1", x), groups, 1e-6))
    y = torch.relu(_group_norm(p, key + ".gn2", _std_conv(num, p, key + ".conv2", y, stride, 1), groups, 1e-6))
    y = _group_norm(p, key + ".gn3", _std_conv(num, p, key + ".conv3", y), groups, 1e-6)
    return torch.relu(shortcut + y)


def encoder(p, x, cfg, num):
    """(embedded tokens (B, N, D), skip features deepest first) of ``x``
    (B, 1 or 3, S, S)."""
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    size, groups = x.shape[-1], cfg["gn_groups"]
    x = _std_conv(num, p, ROOT + "root.conv", x, 2, 3)
    x = torch.relu(_group_norm(p, ROOT + "root.gn", x, groups, 1e-6))
    features = [x]
    x = F.max_pool2d(x, kernel_size=3, stride=2)
    for s in (1, 2, 3):
        for u in range(1, _units(p, s) + 1):
            stride = 2 if s > 1 and u == 1 else 1
            x = _bottleneck(num, p, ROOT + "body.block{}.unit{}".format(s, u), x, stride, groups)
        if s < 3:
            right = size // 4 // s
            feat = x.new_zeros(x.shape[:2] + (right, right))
            feat[:, :, : x.shape[2], : x.shape[3]] = x
            features.append(feat)
    x = unet._conv(num, x, p["transformer.embeddings.patch_embeddings.weight"],
                   p["transformer.embeddings.patch_embeddings.bias"])
    x = x.flatten(2).transpose(1, 2)
    return x + p["transformer.embeddings.position_embeddings"], features[::-1]


def attention(num, q, k, v):
    """softmax(Q K^T / sqrt(d)) V over (B, H, N, d) heads."""
    scores = _mm(num, q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return _mm(num, torch.softmax(scores, dim=-1), v)


def transformer(p, x, cfg, num):
    """The blocks and the final LayerNorm on tokens (B, N, D)."""
    b, n, d = x.shape
    heads = cfg["num_heads"]
    i = 0
    while LAYER.format(i) + "attn.query.weight" in p:
        key = LAYER.format(i)
        h = _layer_norm(p, key + "attention_norm", x)
        q, k, v = (_linear(num, p, key + "attn." + w, h).reshape(b, n, heads, d // heads).transpose(1, 2)
                   for w in ("query", "key", "value"))
        ctx = attention(num, q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + _linear(num, p, key + "attn.out", ctx)
        h = _gelu(_linear(num, p, key + "ffn.fc1", _layer_norm(p, key + "ffn_norm", x)))
        x = x + _linear(num, p, key + "ffn.fc2", h)
        i += 1
    return _layer_norm(p, "transformer.encoder.encoder_norm", x)


def _conv_bn_relu(num, p, key, x, train, stats):
    x = unet._conv(num, x, p[key + ".0.weight"], None, 1, 1)
    return torch.relu(unet._batch_norm(p, key + ".1", x, train, stats))


def decoder(p, tokens, features, cfg, num, train=False, stats=None):
    """(features of the last decoder block, class logits)."""
    b, n, d = tokens.shape
    g = math.isqrt(n)
    x = _conv_bn_relu(num, p, "decoder.conv_more", tokens.transpose(1, 2).reshape(b, d, g, g), train, stats)
    k = 0
    while "decoder.blocks.{}.conv1.0.weight".format(k) in p:
        x = _upsample(x)
        if k < cfg["n_skip"]:
            x = torch.cat([x, features[k]], dim=1)
        for c in ("conv1", "conv2"):
            x = _conv_bn_relu(num, p, "decoder.blocks.{}.{}".format(k, c), x, train, stats)
        k += 1
    return x, unet._conv(num, x, p["segmentation_head.0.weight"], p["segmentation_head.0.bias"], 1, 1)


def forward(p: dict, x: torch.Tensor, cfg: dict, num: Numerics, train: bool = False, stats: dict | None = None):
    """(class probabilities (B, C, S, S), heatmaps (B, L, S, S)) of ``x``
    (B, 1, S, S) under the state dict ``p`` (tensors in ``num.dtype``)."""
    tokens, features = encoder(p, x, cfg, num)
    feats, logits = decoder(p, transformer(p, tokens, cfg, num), features, cfg, num, train, stats)
    h = torch.cat([feats, logits], dim=1)
    j = 0
    while "lands_1x1.{}.weight".format(j) in p:
        h = unet._conv(num, h, p["lands_1x1.{}.weight".format(j)])
        j += 1
    return torch.softmax(logits, dim=1), h


@torch.no_grad()
def ensemble(members, frames, rots, cfg: dict, num: Numerics):
    """``reference/infer.py::ensemble`` of TransUNet members: (mean
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
