"""TransUNet R50-ViT-B/16 (Chen et al. 2021, arXiv:2102.04306; the
published code: github.com/Beckschen/TransUNet, ``networks/
vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``,
``networks/vit_seg_configs.py::get_r50_b16_config``) as an NCHW
``nn.Module`` with the port's output contract: softmax class
probabilities, and with landmarks the heatmaps of the recipe's landmark
head. The JAX package has no counterpart.

Module names are the published ones, so a published state dict's keys
map over with a rename table:

  transformer.embeddings.hybrid_model.root.{conv,gn}     StdConv 7x7 s2, GN
  transformer.embeddings.hybrid_model.body.block{s}.unit{u}
      .{conv1,gn1,conv2,gn2,conv3,gn3[,downsample,gn_proj]}  bottlenecks
  transformer.embeddings.{patch_embeddings,position_embeddings}
  transformer.encoder.layer.{i}.{attention_norm,ffn_norm}  LayerNorms
  transformer.encoder.layer.{i}.attn.{query,key,value,out}
  transformer.encoder.layer.{i}.ffn.{fc1,fc2}
  transformer.encoder.encoder_norm
  decoder.conv_more.{0,1}                                 Conv3x3, BN
  decoder.blocks.{k}.{conv1,conv2}.{0,1}                  Conv3x3, BN
  segmentation_head.0                                     Conv3x3, bias
  lands_1x1.{j}                                           landmark head

The forward, as published: a 1-channel input is repeated to 3 channels.
The root is a weight-standardised 7x7 stride-2 convolution (``StdConv2d``:
each output channel's weight less its mean over the input channels and
kernel, over the square root of its biased variance plus 1e-5),
GroupNorm(32, eps 1e-6) and ReLU, then a 3x3 stride-2 max pool with no
padding. The ResNet-50 body's pre-activation bottlenecks (1x1, 3x3 with
the stride, 1x1; each StdConv then GroupNorm, ReLU between) end in
``relu(shortcut + y)``; the first unit of a stage projects its shortcut
with a StdConv 1x1 and ``GroupNorm(cout, cout)`` (the published eps,
torch's 1e-5). A stage's skip feature is zero-padded at the bottom and
right to ``size / 4 / (i + 1)`` where the map is smaller (the stride-2
stage that follows runs on the unpadded map). A 1x1 convolution embeds
the 1/16 grid, a learned table of one row per grid cell is added, then
dropout (0.1, as in the MLP; the published attention dropout is 0).
Twelve pre-LayerNorm blocks (eps 1e-6): multi-head attention
(``F.scaled_dot_product_attention``, softmax of QK^T / sqrt(d_head)) and
a residual add, then an MLP with exact (erf) GELU and a residual add; a
final LayerNorm. The cascaded decoder reshapes the tokens to the grid, a
Conv3x3-BatchNorm-ReLU to 512 channels, then four blocks of bilinear x2
upsampling (aligned corners), the concatenated skip (the published
``n_skip`` is 3: the fourth block takes none) and two
Conv3x3-BatchNorm-ReLU; a Conv3x3 head gives the class logits.

Departures from the published code: the landmark head (the U-Net's, two
bias-free 1x1 convolutions over [features, class logits]) on the
decoder's last features, and the softmax on the logits, as
``models/unet.py`` returns them. The input side must be a multiple of 16
(the grid is then side / 16 and the patch size 1, as the published
training script's ``grid = img_size / 16`` sets it); the position table
has one row per grid cell at the configured side.

The forward records three spans (``utils/profiling.py``) while a
profiler runs: ``transunet.encoder`` (root, body and embeddings),
``transunet.transformer`` (the blocks and the final LayerNorm) and
``transunet.decoder`` (the reshape to the heads), and counts
``attention_calls``, one per block's attention call.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepfluoro_tpu_torch.models.unet import BatchNorm2d
from deepfluoro_tpu_torch.utils.profiling import count, span

HEAD_CHANNELS = 512  # the decoder's first convolution (published DecoderCup)
GRID_STRIDE = 16
DROPOUT = 0.1  # after the embeddings and in the MLP; the published attention dropout is 0
N_SKIP = 3  # skips the decoder takes: the second and first stages' outputs and the root's


class StdConv2d(nn.Conv2d):
    """A convolution of the weight standardised per output channel."""

    def forward(self, x):
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + 1e-5)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def _std_conv(cin: int, cout: int, k: int, stride: int = 1) -> StdConv2d:
    return StdConv2d(cin, cout, kernel_size=k, stride=stride, padding=k // 2, bias=False)


class PreActBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, cmid: int, stride: int, groups: int):
        super().__init__()
        self.gn1 = nn.GroupNorm(groups, cmid, eps=1e-6)
        self.conv1 = _std_conv(cin, cmid, 1)
        self.gn2 = nn.GroupNorm(groups, cmid, eps=1e-6)
        self.conv2 = _std_conv(cmid, cmid, 3, stride)
        self.gn3 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv3 = _std_conv(cmid, cout, 1)
        if stride != 1 or cin != cout:
            self.downsample = _std_conv(cin, cout, 1, stride)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x):
        shortcut = self.gn_proj(self.downsample(x)) if hasattr(self, "downsample") else x
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(shortcut + self.gn3(self.conv3(y)))


class ResNetV2(nn.Module):
    """The hybrid encoder's ResNet: the root and three stages of
    ``units`` bottlenecks at ``width`` (stage outputs 4, 8 and 16 times
    it)."""

    def __init__(self, units, width: int, groups: int):
        super().__init__()
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(3, width, kernel_size=7, stride=2, padding=3, bias=False)),
            ("gn", nn.GroupNorm(groups, width, eps=1e-6)),
            ("relu", nn.ReLU()),
        ]))
        stages, cin = [], width
        for s, n in enumerate(units):
            cmid = width * 2**s
            cout = 4 * cmid
            stage = [("unit1", PreActBottleneck(cin, cout, cmid, 1 if s == 0 else 2, groups))]
            stage += [("unit{}".format(u), PreActBottleneck(cout, cout, cmid, 1, groups)) for u in range(2, n + 1)]
            stages.append(("block{}".format(s + 1), nn.Sequential(OrderedDict(stage))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(stages))

    def forward(self, x):
        """(the last stage's map, the skip features deepest first)."""
        size = x.shape[-1]
        x = self.root(x)
        features = [x]
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        for i, stage in enumerate(self.body[:-1]):
            x = stage(x)
            pad = size // (4 * (i + 1)) - x.shape[-1]
            if not 0 <= pad < 3:
                raise ValueError("a {}^2 input gives a {}^2 stage map".format(size, x.shape[-1]))
            features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return self.body[-1](x), features[::-1]


class Embeddings(nn.Module):
    def __init__(self, units, width: int, groups: int, hidden: int, tokens: int):
        super().__init__()
        self.hybrid_model = ResNetV2(units, width, groups)
        self.patch_embeddings = nn.Conv2d(16 * width, hidden, kernel_size=1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens, hidden))
        self.dropout = nn.Dropout(DROPOUT)

    def forward(self, x):
        x, features = self.hybrid_model(x)
        x = self.patch_embeddings(x).flatten(2).transpose(-1, -2)
        if x.shape[1] != self.position_embeddings.shape[1]:
            raise ValueError("the input gives {} tokens; the position table has {} rows".format(
                x.shape[1], self.position_embeddings.shape[1]))
        return self.dropout(x + self.position_embeddings), features


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = (lin(x).view(b, n, self.heads, d // self.heads).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        count("attention_calls")
        ctx = F.scaled_dot_product_attention(q, k, v)
        return self.out(ctx.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        self.dropout = nn.Dropout(DROPOUT)

    def forward(self, x):
        return self.dropout(self.fc2(self.dropout(F.gelu(self.fc1(x)))))


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp_dim)
        self.attn = Attention(hidden, heads)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, layers: int, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp_dim) for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, x):
        for block in self.layer:
            x = block(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    """The published ``Transformer``'s two parts, under its key names;
    ``TransUNet.forward`` calls each in its own span."""

    def __init__(self, embeddings: Embeddings, encoder: Encoder):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    """Published ``Conv2dReLU``: Conv3x3 (no bias), BatchNorm, ReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel_size=3, padding=1, bias=False),
                         BatchNorm2d(cout, eps=1e-5, momentum=0.1), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin + skip, cout)
        self.conv2 = _conv_bn_relu(cout, cout)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, channels, skips):
        super().__init__()
        self.conv_more = _conv_bn_relu(hidden, HEAD_CHANNELS)
        cins = [HEAD_CHANNELS] + list(channels[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(ci, co, s) for ci, co, s in zip(cins, channels, skips))

    def forward(self, tokens, features):
        b, n, d = tokens.shape
        g = int(round(n**0.5))
        x = self.conv_more(tokens.transpose(1, 2).reshape(b, d, g, g))
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < N_SKIP else None)
        return x


class TransUNet(nn.Module):
    """TransUNet R50-ViT (defaults: R50-ViT-B/16) for ``size`` x ``size``
    inputs. ``forward(x (B, 1, S, S))`` returns the class probabilities
    ``(B, n_classes, S, S)``, or ``(seg, heat_maps (B, num_lands, S, S))``
    when ``num_lands > 0``."""

    def __init__(
        self,
        n_classes: int,
        size: int,
        num_lands: int = 0,
        hidden: int = 768,
        heads: int = 12,
        mlp_dim: int = 3072,
        layers: int = 12,
        units=(3, 4, 9),
        width: int = 64,
        groups: int = 32,
        decoder_channels=(256, 128, 64, 16),
        lands_num_1x1: int = 2,
    ):
        super().__init__()
        if size % GRID_STRIDE:
            raise ValueError("TransUNet takes inputs whose side is a multiple of {}; got {}".format(GRID_STRIDE, size))
        if len(units) != 3 or len(decoder_channels) != 4:
            raise ValueError("TransUNet takes 3 ResNet stages and 4 decoder blocks")
        self.num_lands = num_lands
        tokens = (size // GRID_STRIDE) ** 2
        self.transformer = Transformer(Embeddings(units, width, groups, hidden, tokens),
                                       Encoder(layers, hidden, heads, mlp_dim))
        self.decoder = DecoderCup(hidden, decoder_channels, (8 * width, 4 * width, width, 0))
        self.segmentation_head = nn.Sequential(nn.Conv2d(decoder_channels[-1], n_classes, kernel_size=3, padding=1),
                                               nn.Identity())
        self.lands_1x1 = nn.ModuleList()
        if num_lands > 0:
            if lands_num_1x1 < 1:
                raise ValueError("the landmark head needs at least one 1x1 convolution")
            n_out = num_lands + (n_classes if lands_num_1x1 > 1 else 0)
            self.lands_1x1.append(nn.Conv2d(decoder_channels[-1] + n_classes, n_out, kernel_size=1, bias=False))
            for _ in range(lands_num_1x1 - 1):
                self.lands_1x1.append(nn.Conv2d(n_out, num_lands, kernel_size=1, bias=False))
                n_out = num_lands

    def set_bands(self, bands):
        """The full-res path clears the bands of row sharding with None;
        TransUNet runs on whole frames only."""
        if bands is not None:
            raise ValueError("TransUNet runs on whole frames; it cannot be row-sharded")
        return ()

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        with span("transunet.encoder"):
            tokens, features = self.transformer.embeddings(x)
        with span("transunet.transformer"):
            tokens = self.transformer.encoder(tokens)
        with span("transunet.decoder"):
            x = self.decoder(tokens, features)
            logits = self.segmentation_head(x)
            seg = torch.softmax(logits, dim=1)
            if self.num_lands <= 0:
                return seg
            h = torch.cat([x, logits], dim=1)
            for conv in self.lands_1x1:
                h = conv(h)
        return seg, h
