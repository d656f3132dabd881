"""Swin UNETR in 2D (Hatamizadeh et al. 2022, arXiv:2201.01266; the
published code: MONAI, ``monai/networks/nets/swin_unetr.py`` with its
blocks in ``monai/networks/blocks/unetr_block.py`` and
``dynunet_block.py``) as an NCHW ``nn.Module`` with the port's output
contract: softmax class probabilities, and with landmarks the heatmaps of
the recipe's landmark head. The JAX package has no counterpart.

Module names are MONAI's, so a published state dict's keys map over
with a short rename table:

  swinViT.patch_embed.proj                              Conv 2x2 s2, bias
  swinViT.layers{1..4}.0.blocks.{0,1}.{norm1,norm2}     LayerNorms
  swinViT.layers{i}.0.blocks.{j}.attn.{qkv,proj,
      relative_position_bias_table,relative_position_index}
  swinViT.layers{i}.0.blocks.{j}.mlp.{linear1,linear2}
  swinViT.layers{i}.0.downsample.{norm,reduction}       PatchMerging
  encoder{1,2,3,4,10}.layer.conv{1,2[,3]}.conv          UnetResBlock
  decoder{5,4,3,2,1}.transp_conv.conv                   ConvTranspose 2x2 s2
  decoder{k}.conv_block.conv{1,2,3}.conv                UnetResBlock
  out.conv.conv                                         Conv 1x1, bias
  lands_1x1.{j}                                         landmark head

The forward, as published for ``spatial_dims=2``. The patch embedding is
a 2x2 stride-2 convolution with bias and no norm. Four stages
(``BasicLayer``) of ``depths`` blocks at widths f, 2f, 4f and 8f work on
``b h w c`` maps; a block is ``x + attn(LN(x))`` then ``x + MLP(LN(x))``
(LN eps 1e-5; MLP Linear(C, 4C), exact GELU, Linear(4C, C)). The attention
half zero-pads the LayerNorm's output at the bottom and right to whole
windows, rolls it by (-s, -s) in odd blocks, cuts it into w x w windows,
runs ``WindowAttention``, and undoes the three. ``get_window_size``: a
side at or under the window makes the window that side and the shift 0.
``WindowAttention``: ``qkv`` Linear(C, 3C) with bias, heads of C / heads,
``softmax(q k^T / sqrt(d) + B[h] (+ M[w] in shifted blocks)) v``, ``proj``
Linear(C, C). ``B`` is gathered from a ((2w - 1)^2, heads) table by the
relative-position index; where the window is clamped to n < w^2 tokens
the index is cut to its first n rows and columns, as published.
``compute_mask`` labels nine regions of the padded grid with the slices
(:-w), (-w:-s), (-s:) a side and puts -100 between tokens of a window
whose labels differ. Padded tokens take part in the attention of the
unshifted blocks; the mask covers only the shift. A stage ends with
``PatchMerging``: the four 2x2 phases concatenated in MONAI's order,
LayerNorm(4C), Linear(4C, 2C) without bias. The embedding and each
stage's output go through ``proj_out``: a LayerNorm over channels
without affine (``normalize`` True). ``UnetResBlock``: conv3x3 (no bias),
InstanceNorm (no affine, eps 1e-5), LeakyReLU(0.01), conv3x3,
InstanceNorm, plus the residual (a 1x1 conv and InstanceNorm where the
channels change), LeakyReLU. Encoders 1-4 and 10 are such blocks on the
raw input and on the embedding's and stages' outputs; each of the five
up blocks is a transposed 2x2 stride-2 convolution (no bias), the skip
concatenated, and a res block; ``out`` is a 1x1 convolution with bias.

Departures from the published code: the landmark head (the U-Net's, two
bias-free 1x1 convolutions over [decoder1's features, class logits]) and
the softmax on the logits, as ``models/unet.py`` returns them; dropout
and drop path are left out (published rates 0). The input side must be a
multiple of 32, MONAI's own check; the patch size is 2.

The window attention runs in ``F.scaled_dot_product_attention`` with the
bias (and in shifted blocks the shift mask) as an additive float mask,
on the card pinned to the memory-efficient kernel (float32-accurate;
``torch.nn.attention.sdpa_kernel``). An unshifted block's mask is the
(1, heads, n, n) bias for every window of every frame. A shifted block's
mask differs per window and per head, so it is the (windows, heads, n, n)
sum of the two, made once a forward, and each frame's windows are one
call; nothing of the size of the batch is materialised. The mask's rows
are padded to a multiple of 8 elements, the kernel's alignment, so that
it is not copied again inside the call. The shift mask is made once per
grid and held.

The forward records two spans (``utils/profiling.py``) while a profiler
runs: ``swinunetr.swin`` (the embedding, the stages, the merges and
``proj_out``) and ``swinunetr.decoder`` (the conv encoders, the up
blocks, the out block and the landmark head), and counts
``window_attention_calls``, one per block's attention.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepfluoro_tpu_torch.utils.profiling import count, span

PATCH_SIZE = 2
MERGES = 4  # the stages' patch merges, so the input side divides by PATCH_SIZE * 2**MERGES
MASK_ALIGN = 8  # elements; the memory-efficient kernel copies a mask whose rows are not so aligned
SHIFT_FILL = -100.0
LEAKY_SLOPE = 0.01


def window_size_of(side: int, window: int, shift: int) -> tuple[int, int]:
    """MONAI's ``get_window_size`` for a square grid: a side at or under
    the window makes the window that side and the shift 0."""
    return (side, 0) if side <= window else (window, shift)


def relative_position_index(window: int) -> torch.Tensor:
    """(w^2, w^2) indices into the ((2w - 1)^2, heads) bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(b, h, w, c) -> (b * windows, window^2, c), frame-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, b: int, h: int, w: int) -> torch.Tensor:
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shift_mask(side: int, window: int, shift: int, device) -> torch.Tensor:
    """MONAI's ``compute_mask`` for a padded ``side`` x ``side`` grid:
    (windows, window^2, window^2), 0 between tokens of one region and
    ``SHIFT_FILL`` between tokens of two; its rows padded with zeros
    (``padded``)."""
    labels = torch.zeros(1, side, side, 1, device=device)
    cuts = (slice(-window), slice(-window, -shift), slice(-shift, None))
    for n, (rows, cols) in enumerate(itertools.product(cuts, cuts)):
        labels[:, rows, cols, :] = n
    lw = window_partition(labels, window).squeeze(-1)
    diff = lw.unsqueeze(1) - lw.unsqueeze(2)
    return padded(torch.zeros_like(diff).masked_fill(diff != 0, SHIFT_FILL))


def padded(t: torch.Tensor) -> torch.Tensor:
    """(..., n, n) -> a contiguous (..., n, m) copy, m the next multiple
    of ``MASK_ALIGN``, the added columns 0: a mask whose ``[..., :n]``
    view the kernel takes as it is."""
    n = t.shape[-1]
    return F.pad(t.contiguous(), (0, -n % MASK_ALIGN))


def _attention(q, k, v, mask):
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n) relative-position bias of an n-token window."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, frames: int, mask: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` (frames * windows, n, C) frame-major; ``mask`` the
        ``padded`` (windows, n, m) shift mask in a shifted block."""
        bw, n, c = x.shape
        q, k, v = self.qkv(x).view(bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        count("window_attention_calls")
        bias = padded(self.bias(n))[None]
        # the output comes as (windows, heads, n, d) over a (windows, n,
        # heads, d) buffer: transposed back it is contiguous
        if mask is None:
            out = _attention(q, k, v, bias[..., :n]).transpose(1, 2)
        else:
            both = (bias + mask[:, None])[..., :n]
            nw = mask.shape[0]
            out = torch.cat([_attention(q[f * nw : (f + 1) * nw], k[f * nw : (f + 1) * nw], v[f * nw : (f + 1) * nw],
                                        both).transpose(1, 2) for f in range(frames)])
        return self.proj(out.reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """``x`` (b, h, w, c); ``mask`` the stage's shift mask, or None
        where its grid is clamped."""
        b, h, w, c = x.shape
        window, shift = window_size_of(h, self.window, self.shift)
        y = self.norm1(x)
        pad = -h % window
        if pad:
            y = F.pad(y, (0, 0, 0, pad, 0, pad))
        hp = h + pad
        if shift:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        y = self.attn(window_partition(y, window), b, mask if shift else None)
        y = window_reverse(y, window, b, hp, hp)
        if shift:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        if pad:
            y = y[:, :h, :w]
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        x = torch.cat([x[:, j::2, i::2] for i, j in itertools.product(range(2), range(2))], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks, unshifted and shifted in turn, then a
    patch merge. Holds the shift mask of each grid it has seen."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, window // 2
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window, 0 if i % 2 == 0 else self.shift, mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(dim)
        self._masks: dict = {}

    def mask(self, side: int, device) -> torch.Tensor | None:
        window, shift = window_size_of(side, self.window, self.shift)
        if not shift:
            return None
        grid = side + -side % window
        key = (grid, str(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(grid, window, shift, device)
        return self._masks[key]

    def forward(self, x):
        """(b, c, h, w) -> (b, 2c, h / 2, w / 2)."""
        x = x.permute(0, 2, 3, 1)
        mask = self.mask(x.shape[1], x.device)
        for block in self.blocks:
            x = block(x, mask)
        return self.downsample(x).permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, kernel_size=PATCH_SIZE, stride=PATCH_SIZE)

    def forward(self, x):
        return self.proj(x)


def proj_out(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of (b, c, h, w), without affine."""
    return F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2]).permute(0, 3, 1, 2)


class SwinTransformer(nn.Module):
    def __init__(self, cin: int, dim: int, depths, heads, window: int, mlp_ratio: float):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        for i, (depth, h) in enumerate(zip(depths, heads)):
            setattr(self, "layers{}".format(i + 1), nn.ModuleList([BasicLayer(dim * 2**i, depth, h, window, mlp_ratio)]))

    def forward(self, x):
        """The embedding's and the four stages' outputs, each through
        ``proj_out``."""
        x = self.patch_embed(x)
        out = [proj_out(x)]
        for i in range(MERGES):
            x = getattr(self, "layers{}".format(i + 1))[0](x.contiguous())
            out.append(proj_out(x))
        return out


def _conv(cin: int, cout: int, k: int, stride: int = 1, transposed: bool = False, bias: bool = False):
    """MONAI's ``Convolution`` holding one convolution under ``conv``."""
    if transposed:
        conv = nn.ConvTranspose2d(cin, cout, kernel_size=k, stride=stride, bias=bias)
    else:
        conv = nn.Conv2d(cin, cout, kernel_size=k, stride=stride, padding=k // 2, bias=bias)
    return nn.Sequential(OrderedDict(conv=conv))


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3)
        self.conv2 = _conv(cout, cout, 3)
        if cin != cout:
            self.conv3 = _conv(cin, cout, 1)

    def forward(self, x):
        y = F.leaky_relu(F.instance_norm(self.conv1(x)), LEAKY_SLOPE)
        y = F.instance_norm(self.conv2(y))
        residual = F.instance_norm(self.conv3(x)) if hasattr(self, "conv3") else x
        return F.leaky_relu(y + residual, LEAKY_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = _conv(cin, cout, 2, stride=2, transposed=True)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class SwinUNETR(nn.Module):
    """Swin UNETR (defaults: the published feature size 48) for
    ``size`` x ``size`` inputs of ``in_channels``. ``forward(x (B, 1, S,
    S))`` returns the class probabilities ``(B, n_classes, S, S)``, or
    ``(seg, heat_maps (B, num_lands, S, S))`` when ``num_lands > 0``."""

    def __init__(
        self,
        n_classes: int,
        size: int,
        num_lands: int = 0,
        feature_size: int = 48,
        depths=(2, 2, 2, 2),
        heads=(3, 6, 12, 24),
        window: int = 7,
        mlp_ratio: float = 4.0,
        in_channels: int = 1,
        lands_num_1x1: int = 2,
    ):
        super().__init__()
        step = PATCH_SIZE * 2**MERGES
        if size % step:
            raise ValueError("Swin UNETR takes inputs whose side is a multiple of {}; got {}".format(step, size))
        if len(depths) != MERGES or len(heads) != MERGES:
            raise ValueError("Swin UNETR takes {} stages; got depths {} and heads {}".format(MERGES, depths, heads))
        if feature_size % 12:
            raise ValueError("Swin UNETR's feature size is a multiple of 12; got {}".format(feature_size))
        f = feature_size
        self.num_lands = num_lands
        self.swinViT = SwinTransformer(in_channels, f, depths, heads, window, mlp_ratio)
        self.encoder1 = UnetrBasicBlock(in_channels, f)
        self.encoder2 = UnetrBasicBlock(f, f)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f)
        self.decoder1 = UnetrUpBlock(f, f)
        self.out = UnetOutBlock(f, n_classes)
        self.lands_1x1 = nn.ModuleList()
        if num_lands > 0:
            if lands_num_1x1 < 1:
                raise ValueError("the landmark head needs at least one 1x1 convolution")
            n_out = num_lands + (n_classes if lands_num_1x1 > 1 else 0)
            self.lands_1x1.append(nn.Conv2d(f + n_classes, n_out, kernel_size=1, bias=False))
            for _ in range(lands_num_1x1 - 1):
                self.lands_1x1.append(nn.Conv2d(n_out, num_lands, kernel_size=1, bias=False))
                n_out = num_lands

    def set_bands(self, bands):
        """The full-res path clears the bands of row sharding with None;
        Swin UNETR runs on whole frames only."""
        if bands is not None:
            raise ValueError("Swin UNETR runs on whole frames; it cannot be row-sharded")
        return ()

    def forward(self, x):
        with span("swinunetr.swin"):
            hs = self.swinViT(x)
        with span("swinunetr.decoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hs[0])
            enc2 = self.encoder3(hs[1])
            enc3 = self.encoder4(hs[2])
            y = self.decoder5(self.encoder10(hs[4]), hs[3])
            y = self.decoder4(y, enc3)
            y = self.decoder3(y, enc2)
            y = self.decoder2(y, enc1)
            y = self.decoder1(y, enc0)
            logits = self.out(y)
            seg = torch.softmax(logits, dim=1)
            if self.num_lands <= 0:
                return seg
            h = torch.cat([y, logits], dim=1)
            for conv in self.lands_1x1:
                h = conv(h)
        return seg, h
