"""Swin UNETR in 2D as plain functions of a state dict (Hatamizadeh et al.
2022, arXiv:2201.01266; MONAI ``monai/networks/nets/swin_unetr.py``,
``monai/networks/blocks/unetr_block.py`` and ``dynunet_block.py``), for
the benchmark's comparison that decides ``correct``.

Keys are MONAI's module names (``swinViT.patch_embed.proj``,
``swinViT.layers{i}.0.blocks.{j}.{norm1,attn.{qkv,proj,
relative_position_bias_table},norm2,mlp.{linear1,linear2}}``,
``swinViT.layers{i}.0.downsample.{norm,reduction}``,
``encoder{1,2,3,4,10}.layer.conv{1,2,3}.conv``,
``decoder{5,4,3,2,1}.{transp_conv.conv,conv_block.conv{1,2,3}.conv}``,
``out.conv.conv``) and the landmark head's ``lands_1x1.{j}``. Widths and
depths are read from the state dict's shapes; ``cfg`` gives
``swin_heads`` and ``window_size``.

As published for ``spatial_dims=2``: the 2x2 stride-2 patch embedding;
each block ``x + attn(LN(x))``, ``x + MLP(LN(x))`` (LN eps 1e-5, exact
GELU), whose attention half zero-pads the LayerNorm's output at the
bottom and right to whole windows, rolls it by (-s, -s) in odd blocks,
cuts it into windows (``window_partition``), and undoes the three;
``get_window_size``'s clamp of a side at or under the window (the window
becomes the side, the shift 0); the attention written out as
``softmax(q * d^-1/2 @ k^T + B + M) @ v`` with the bias gathered from the
table by the relative-position index cut to the window's n tokens
(``[:n, :n]``, as published) and ``compute_mask``'s -100 between the
shift's regions; ``PatchMerging`` (the 2x2 phases in MONAI's order,
LN(4C), Linear without bias); ``proj_out``'s LayerNorm over channels
without affine; ``UnetResBlock`` (conv3x3, InstanceNorm without affine at
eps 1e-5, LeakyReLU 0.01, conv3x3, InstanceNorm, the 1x1 residual where
channels change, LeakyReLU) in the encoders and, after a 2x2 stride-2
transposed convolution and the concatenated skip, in the up blocks; the
1x1 out block with bias.
Departures, as the program makes them: the softmax of the logits and the
landmark head (two bias-free 1x1 convolutions over [decoder1's features,
logits]); 2D; 7 classes. Dropout and drop path (published rates 0) are
left out.

``Numerics`` is ``unet.Numerics``: with ``tf32`` every convolution and
matrix product runs at TF32 precision (on the card cuDNN's and cuBLAS's
switch; on the CPU the operands rounded first).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from fluorobench.reference import infer as ref_infer
from fluorobench.reference import unet
from fluorobench.reference.unet import Numerics

SWIN = "swinViT."
STAGES = 4


def _mm(num: Numerics, a, b):
    if num.tf32 and a.device.type == "cpu":
        a, b = unet.round_tf32(a), unet.round_tf32(b)
    return a @ b


def _linear(num, p, key, x):
    y = _mm(num, x, p[key + ".weight"].T)
    return y + p[key + ".bias"] if key + ".bias" in p else y


def _layer_norm(x, weight=None, bias=None, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + eps)
    return x if weight is None else x * weight + bias


def _ln(p, key, x):
    return _layer_norm(x, p[key + ".weight"], p[key + ".bias"])


def _instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _leaky_relu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def get_window_size(side: int, window: int, shift: int) -> tuple[int, int]:
    return (side, 0) if side <= window else (window, shift)


def window_partition(x, w):
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, w * w, c)


def window_reverse(windows, w, b, h, wd):
    x = windows.view(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, wd, -1)


def relative_position_index(window: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def compute_mask(hp: int, wp: int, w: int, s: int, device) -> torch.Tensor:
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in slice(-w), slice(-w, -s), slice(-s, None):
        for ws in slice(-w), slice(-w, -s), slice(-s, None):
            img[:, hs, ws, :] = cnt
            cnt += 1
    windows = window_partition(img, w).squeeze(-1)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def window_attention(num, p, key, x, heads, window, mask):
    """x (B * windows, n, C) -> the attention's output, written out."""
    b, n, c = x.shape
    qkv = _linear(num, p, key + ".qkv", x).reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = _mm(num, q, k.transpose(-2, -1))
    index = relative_position_index(window).to(x.device)[:n, :n].reshape(-1)
    bias = p[key + ".relative_position_bias_table"][index].reshape(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b // nw, nw, heads, n, n) + mask.to(attn.dtype).unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return _linear(num, p, key + ".proj", _mm(num, attn, v).transpose(1, 2).reshape(b, n, c))


def block(num, p, key, x, heads, window, shift, mask):
    """One ``SwinTransformerBlock`` on x (b, h, w, c)."""
    b, h, wd, c = x.shape
    w, s = get_window_size(h, window, shift)
    shortcut = x
    x = _ln(p, key + ".norm1", x)
    pad_b, pad_r = (w - h % w) % w, (w - wd % w) % w
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = x.shape[1], x.shape[2]
    if s > 0:
        x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
    else:
        mask = None
    out = window_attention(num, p, key + ".attn", window_partition(x, w), heads, window, mask)
    x = window_reverse(out.view(-1, w, w, c), w, b, hp, wp)
    if s > 0:
        x = torch.roll(x, shifts=(s, s), dims=(1, 2))
    x = x[:, :h, :wd, :].contiguous()
    x = shortcut + x
    y = _gelu(_linear(num, p, key + ".mlp.linear1", _ln(p, key + ".norm2", x)))
    return x + _linear(num, p, key + ".mlp.linear2", y)


def basic_layer(num, p, key, x, heads, window):
    """One stage on x (b, c, h, w), its merge included."""
    b, c, h, wd = x.shape
    shift = window // 2
    w, s = get_window_size(h, window, shift)
    x = x.permute(0, 2, 3, 1)
    hp, wp = -(-h // w) * w, -(-wd // w) * w
    mask = compute_mask(hp, wp, w, s, x.device) if s > 0 else None
    j = 0
    while "{}.blocks.{}.norm1.weight".format(key, j) in p:
        x = block(num, p, "{}.blocks.{}".format(key, j), x, heads, window, 0 if j % 2 == 0 else shift, mask)
        j += 1
    x = torch.cat([x[:, jj::2, i::2, :] for i, jj in itertools.product(range(2), range(2))], -1)
    x = _linear(num, p, key + ".downsample.reduction", _ln(p, key + ".downsample.norm", x))
    return x.permute(0, 3, 1, 2)


def proj_out(x):
    return _layer_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def swin(p, x, cfg, num):
    """The embedding's and the four stages' outputs through ``proj_out``."""
    x = unet._conv(num, x, p[SWIN + "patch_embed.proj.weight"], p[SWIN + "patch_embed.proj.bias"], 2)
    out = [proj_out(x)]
    for i in range(STAGES):
        x = basic_layer(num, p, SWIN + "layers{}.0".format(i + 1), x, cfg["swin_heads"][i], cfg["window_size"])
        out.append(proj_out(x))
    return out


def res_block(num, p, key, x):
    y = _leaky_relu(_instance_norm(unet._conv(num, x, p[key + ".conv1.conv.weight"], None, 1, 1)))
    y = _instance_norm(unet._conv(num, y, p[key + ".conv2.conv.weight"], None, 1, 1))
    if key + ".conv3.conv.weight" in p:
        x = _instance_norm(unet._conv(num, x, p[key + ".conv3.conv.weight"]))
    return _leaky_relu(y + x)


def up_block(num, p, key, x, skip):
    x = unet._conv(num, x, p[key + ".transp_conv.conv.weight"], None, 2, transposed=True)
    return res_block(num, p, key + ".conv_block", torch.cat([x, skip], dim=1))


def forward(p: dict, x: torch.Tensor, cfg: dict, num: Numerics):
    """(class probabilities (B, C, S, S), heatmaps (B, L, S, S)) of ``x``
    (B, 1, S, S) under the state dict ``p`` (tensors in ``num.dtype``)."""
    hs = swin(p, x, cfg, num)
    enc0 = res_block(num, p, "encoder1.layer", x)
    enc1 = res_block(num, p, "encoder2.layer", hs[0])
    enc2 = res_block(num, p, "encoder3.layer", hs[1])
    enc3 = res_block(num, p, "encoder4.layer", hs[2])
    dec4 = res_block(num, p, "encoder10.layer", hs[4])
    y = up_block(num, p, "decoder5", dec4, hs[3])
    y = up_block(num, p, "decoder4", y, enc3)
    y = up_block(num, p, "decoder3", y, enc2)
    y = up_block(num, p, "decoder2", y, enc1)
    y = up_block(num, p, "decoder1", y, enc0)
    logits = unet._conv(num, y, p["out.conv.conv.weight"], p["out.conv.conv.bias"])
    h = torch.cat([y, logits], dim=1)
    j = 0
    while "lands_1x1.{}.weight".format(j) in p:
        h = unet._conv(num, h, p["lands_1x1.{}.weight".format(j)])
        j += 1
    return torch.softmax(logits, dim=1), h


@torch.no_grad()
def ensemble(members, frames, rots, cfg: dict, num: Numerics):
    """``reference/infer.py::ensemble`` of Swin UNETR members: (mean
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
