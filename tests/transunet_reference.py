"""TransUNet R50-ViT as plain functions of a state dict (Chen et al. 2021,
arXiv:2102.04306; github.com/Beckschen/TransUNet ``networks/
vit_seg_modeling.py`` and ``networks/vit_seg_modeling_resnet_skip.py``),
for the CPU tests of ``deepfluoro_tpu_torch/models/transunet.py``. It
imports neither JAX nor the port; ``fluorobench/reference/transunet.py``
is the benchmark's copy.

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
Dropout is left out (the tests compare train mode with the program's
dropout at 0), and ``train`` means BatchNorm's batch statistics (eps
1e-5, biased variance). The arithmetic runs in the state dict's dtype:
float64 for the tests.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ROOT = "transformer.embeddings.hybrid_model."
LAYER = "transformer.encoder.layer.{}."


def _linear(p, key, x):
    return x @ p[key + ".weight"].T + p[key + ".bias"]


def _std_conv(p, key, x, stride=1, padding=0):
    w = p[key + ".weight"]
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    return F.conv2d(x, (w - mean) / torch.sqrt(var + 1e-5), None, stride, padding)


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


def _bottleneck(p, key, x, stride, groups):
    if key + ".downsample.weight" in p:
        shortcut = _std_conv(p, key + ".downsample", x, stride)
        shortcut = _group_norm(p, key + ".gn_proj", shortcut, shortcut.shape[1], 1e-5)
    else:
        shortcut = x
    y = torch.relu(_group_norm(p, key + ".gn1", _std_conv(p, key + ".conv1", x), groups, 1e-6))
    y = torch.relu(_group_norm(p, key + ".gn2", _std_conv(p, key + ".conv2", y, stride, 1), groups, 1e-6))
    y = _group_norm(p, key + ".gn3", _std_conv(p, key + ".conv3", y), groups, 1e-6)
    return torch.relu(shortcut + y)


def encoder(p, x, cfg):
    """(embedded tokens (B, N, D), skip features deepest first) of ``x``
    (B, 1 or 3, S, S)."""
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    size, groups = x.shape[-1], cfg["gn_groups"]
    x = _std_conv(p, ROOT + "root.conv", x, 2, 3)
    x = torch.relu(_group_norm(p, ROOT + "root.gn", x, groups, 1e-6))
    features = [x]
    x = F.max_pool2d(x, kernel_size=3, stride=2)
    for s in (1, 2, 3):
        for u in range(1, _units(p, s) + 1):
            stride = 2 if s > 1 and u == 1 else 1
            x = _bottleneck(p, ROOT + "body.block{}.unit{}".format(s, u), x, stride, groups)
        if s < 3:
            right = size // 4 // s
            feat = x.new_zeros(x.shape[:2] + (right, right))
            feat[:, :, : x.shape[2], : x.shape[3]] = x
            features.append(feat)
    x = F.conv2d(x, p["transformer.embeddings.patch_embeddings.weight"],
                 p["transformer.embeddings.patch_embeddings.bias"])
    x = x.flatten(2).transpose(1, 2)
    return x + p["transformer.embeddings.position_embeddings"], features[::-1]


def attention(q, k, v):
    """softmax(Q K^T / sqrt(d)) V over (B, H, N, d) heads."""
    return torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1) @ v


def transformer(p, x, cfg):
    """The blocks and the final LayerNorm on tokens (B, N, D)."""
    b, n, d = x.shape
    heads = cfg["num_heads"]
    i = 0
    while LAYER.format(i) + "attn.query.weight" in p:
        key = LAYER.format(i)
        h = _layer_norm(p, key + "attention_norm", x)
        q, k, v = (_linear(p, key + "attn." + w, h).reshape(b, n, heads, d // heads).transpose(1, 2)
                   for w in ("query", "key", "value"))
        ctx = attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + _linear(p, key + "attn.out", ctx)
        h = _gelu(_linear(p, key + "ffn.fc1", _layer_norm(p, key + "ffn_norm", x)))
        x = x + _linear(p, key + "ffn.fc2", h)
        i += 1
    return _layer_norm(p, "transformer.encoder.encoder_norm", x)


def _batch_norm(p, key, x, train, stats):
    if train:
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[key] = (mean, var)
    else:
        mean, var = p[key + ".running_mean"], p[key + ".running_var"]
    x = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    return x * p[key + ".weight"][:, None, None] + p[key + ".bias"][:, None, None]


def _conv_bn_relu(p, key, x, train, stats):
    return torch.relu(_batch_norm(p, key + ".1", F.conv2d(x, p[key + ".0.weight"], None, 1, 1), train, stats))


def decoder(p, tokens, features, cfg, train=False, stats=None):
    """(features of the last decoder block, class logits)."""
    b, n, d = tokens.shape
    g = math.isqrt(n)
    x = _conv_bn_relu(p, "decoder.conv_more", tokens.transpose(1, 2).reshape(b, d, g, g), train, stats)
    k = 0
    while "decoder.blocks.{}.conv1.0.weight".format(k) in p:
        x = _upsample(x)
        if k < cfg["n_skip"]:
            x = torch.cat([x, features[k]], dim=1)
        for c in ("conv1", "conv2"):
            x = _conv_bn_relu(p, "decoder.blocks.{}.{}".format(k, c), x, train, stats)
        k += 1
    return x, F.conv2d(x, p["segmentation_head.0.weight"], p["segmentation_head.0.bias"], 1, 1)


def forward(p: dict, x: torch.Tensor, cfg: dict, train: bool = False, stats: dict | None = None):
    """(class probabilities (B, C, S, S), heatmaps (B, L, S, S)) of ``x``
    (B, 1, S, S) under the state dict ``p`` (in ``x``'s dtype)."""
    tokens, features = encoder(p, x, cfg)
    feats, logits = decoder(p, transformer(p, tokens, cfg), features, cfg, train, stats)
    h = torch.cat([feats, logits], dim=1)
    j = 0
    while "lands_1x1.{}.weight".format(j) in p:
        h = F.conv2d(h, p["lands_1x1.{}.weight".format(j)])
        j += 1
    return torch.softmax(logits, dim=1), h
