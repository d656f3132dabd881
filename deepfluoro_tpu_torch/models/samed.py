"""SAMed (Zhang & Liu 2023, arXiv:2304.13785; the published code:
github.com/hitachinsk/SAMed, ``sam_lora_image_encoder.py`` and its copy
of ``segment_anything``): SAM's ViT-B (Kirillov et al. 2023,
arXiv:2304.02643; ``segment_anything/build_sam.py::build_sam_vit_b``)
with LoRA on the image encoder's q and v, run with no prompt and one mask
token per class, as an NCHW ``nn.Module`` with the port's output
contract: softmax class probabilities, and with landmarks the heatmaps of
the recipe's landmark head. The JAX package has no counterpart.

Module names are SAM's, with SAMed's ``_LoRA_qkv`` in place of each
encoder block's ``qkv``, so a published state dict's keys map over (less
SAMed's ``sam.`` prefix):

  image_encoder.patch_embed.proj                        Conv 16x16 s16, bias
  image_encoder.pos_embed                               (1, g, g, 768)
  image_encoder.blocks.{i}.{norm1,norm2}                LayerNorms
  image_encoder.blocks.{i}.attn.qkv.{qkv,linear_a_q,linear_b_q,
      linear_a_v,linear_b_v}                            qkv with LoRA
  image_encoder.blocks.{i}.attn.{proj,rel_pos_h,rel_pos_w}
  image_encoder.blocks.{i}.mlp.{lin1,lin2}
  image_encoder.neck.{0,1,2,3}                          Conv, LN2d, Conv, LN2d
  prompt_encoder.{pe_layer.positional_encoding_gaussian_matrix,no_mask_embed}
  mask_decoder.transformer.layers.{j}.{self_attn,cross_attn_token_to_image,
      cross_attn_image_to_token}.{q,k,v,out}_proj
  mask_decoder.transformer.layers.{j}.{norm1..norm4,mlp.{lin1,lin2}}
  mask_decoder.transformer.{final_attn_token_to_image,norm_final_attn}
  mask_decoder.{iou_token,mask_tokens,output_upscaling,
      output_hypernetworks_mlps.{t}.layers.{0,1,2}}
  lands_1x1.{j}                                         landmark head

Only the modules the forward runs are built: the prompt encoder's point
embeddings and mask branch and the decoder's IoU head are not, so a
published state dict loads with their keys left out.

The forward, as published. The 1-channel input is repeated to 3 channels
(SAMed's ``pixel_mean`` 0 and ``pixel_std`` 1: no further
normalization). ``ImageEncoderViT``: a 16x16 stride-16 convolution with
bias to ``b g g 768`` maps plus the absolute ``pos_embed``; 12 blocks of
``x + attn(LN(x))`` then ``x + MLP(LN(x))`` (LN eps 1e-6; MLP 768 -> 3072
-> 768, exact GELU). ``qkv`` is Linear(768, 2304) with bias plus SAMed's
LoRA: ``linear_b_q(linear_a_q(x))`` and ``linear_b_v(linear_a_v(x))``
(rank 4, no bias) added to the q and v thirds. Heads of 64; the logits
are ``(q / 8) k^T + rel_h + rel_w`` with SAM's decomposed relative
positions (``add_decomposed_rel_pos``): ``rel_h[i, j_h] = q_i . R_h[i_h,
j_h]`` and ``rel_w[i, j_w] = q_i . R_w[i_w, j_w]`` of the unscaled q, R
gathered from the ``(2s - 1, 64)`` tables ``rel_pos_h``, ``rel_pos_w`` at
``i - j + s - 1`` (``get_rel_pos`` without its resize: the tables are
built for the input's grid). Blocks in ``global_attn_indexes`` attend over
the whole g x g grid; the others zero-pad the LayerNorm's output at the
bottom and right to whole w x w windows (``window_partition``), attend
within each window with w-sized tables, and cut the padding off after
(``window_unpartition``). The padded tokens pass through ``qkv`` and are
attended to unmasked, as published. ``proj`` is Linear(768, 768). The neck:
1x1 convolution to 256 without bias, ``LayerNorm2d`` (eps 1e-6), 3x3
convolution without bias, ``LayerNorm2d``.

``PromptEncoder`` without points, boxes or masks: no sparse tokens; the
dense embedding is ``no_mask_embed`` broadcast over the grid; the image's
positional encoding (``PositionEmbeddingRandom``) maps the cell centres
``(idx + 0.5) / g`` as (x, y) to ``2c - 1``, multiplies them by the (2,
128) Gaussian matrix and by 2 pi, and takes ``[sin, cos]``.
``MaskDecoder``: the tokens ``[iou_token, mask_tokens]`` broadcast over
the batch; the image embedding plus the dense embedding;
``TwoWayTransformer`` of depth 2 at width 256 (8 heads, MLP 2048 with
ReLU): each block's self-attention of the tokens (the first block's
without the positional encoding and without the residual), LN,
token-to-image cross attention, LN, MLP, LN, image-to-token cross
attention on the image side, LN; the cross attentions project to 128
(``downsample_rate`` 2); then the final token-to-image attention and
``norm_final_attn``. ``output_upscaling``: ConvTranspose 256 -> 64 (2x2,
stride 2), ``LayerNorm2d``, GELU, ConvTranspose 64 -> 32 (2x2, stride 2),
GELU, to (B, 32, 4g, 4g). Each mask token's three-layer MLP (256, 256,
32; ReLU between) gives a row of ``hyper_in``; the masks are ``hyper_in @
upscaled``, (B, tokens, 4g, 4g). ``postprocess_masks``: bilinear
(``align_corners=False``) to the input's side; its crop and second resize
are the identity where the input is the encoder's size, as here.

Departures from the published code, as SAMed reads SAM: every mask
token's mask is returned, the first (background) included, so
``n_classes`` is ``num_multimask_outputs + 1`` (SAMed's
``num_classes + 1``); then the softmax over them, as ``models/unet.py``
returns its probabilities. The IoU head is not built: its output is
outside the port's contract. The recipe's landmark
head (the U-Net's, two bias-free 1x1 convolutions) runs over [the
upscaled 32 channels, the low-res mask logits] at 4g x 4g, and its maps
are resized with the masks. Any side that is a multiple of 16 is taken;
the grid is side / 16 and the global tables have 2g - 1 rows.

Each encoder block's attention is one ``F.scaled_dot_product_attention``
call a batch with the decomposed terms as an additive float mask, on the
card pinned to the memory-efficient kernel (float32-accurate): ``rel_h``
and ``rel_w`` are two small batched products, and their broadcast sum is
written into a (B windows, heads, n, n) mask whose rows are padded to a
multiple of 8 elements, the kernel's alignment, so that it is not copied
again inside the call. The decoder's attentions are plain SDPA without a
mask.

The forward records three spans (``utils/profiling.py``) while a
profiler runs: ``samed.encoder`` (the patch embedding, the blocks and the
neck), ``samed.decoder`` (the dense embedding and positional encoding,
the two-way transformer, the upscaling, the hypernetworks, the resize,
the softmax and the landmark head) and, inside each encoder block's
attention, ``samed.rel_pos_attention`` (the rel-pos mask and the SDPA
call; the device time of what it launches is summed), and counts
``rel_pos_attention_calls``, one per encoder block's SDPA call.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepfluoro_tpu_torch.utils.profiling import count, span

PATCH_SIZE = 16
LN_EPS = 1e-6
MASK_ALIGN = 8  # elements; the memory-efficient kernel copies a mask whose rows are not so aligned
IN_CHANS = 3  # the 1-channel input repeated, as SAMed feeds SAM
DOWNSAMPLE_RATE = 2  # the two-way transformer's cross attentions project to half width
DECODER_DEPTH = 2  # the TwoWayTransformer's blocks, in every SAM variant
LORA_RANK = 4  # SAMed's rank on q and v


def rel_pos_index(size: int, device=None) -> torch.Tensor:
    """(size, size) rows of a (2 size - 1)-row table: ``i - j + size - 1``."""
    idx = torch.arange(size, device=device)
    return idx[:, None] - idx[None, :] + (size - 1)


def rel_pos_mask(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """SAM's decomposed relative positions of ``q`` (b, heads, h * w, d),
    unscaled, as the (b, heads, n, n) additive mask ``rel_h[..., :, None]
    + rel_w[..., None, :]``: a view of a buffer whose rows are padded to a
    multiple of ``MASK_ALIGN`` elements."""
    if rel_pos_h.shape[0] != 2 * h - 1 or rel_pos_w.shape[0] != 2 * w - 1:
        raise ValueError("relative-position tables of {} and {} rows do not fit a {}x{} grid".format(
            rel_pos_h.shape[0], rel_pos_w.shape[0], h, w))
    b, heads, n, d = q.shape
    r_q = q.reshape(b * heads, h, w, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rel_pos_h[rel_pos_index(h, q.device)])
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rel_pos_w[rel_pos_index(w, q.device)])
    mask = q.new_empty(b * heads, n, n + -n % MASK_ALIGN)[..., :n]
    torch.add(rel_h[..., :, None], rel_w[..., None, :], out=mask.view(b * heads, h, w, h, w))
    return mask.view(b, heads, n, n)


def _attention(q, k, v, mask):
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm over the channels of (b, c, h, w)."""

    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class LoRAQKV(nn.Module):
    """SAMed's ``_LoRA_qkv``: the frozen ``qkv`` plus rank-r updates of
    its q and v thirds."""

    def __init__(self, dim: int, rank: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.linear_a_q = nn.Linear(dim, rank, bias=False)
        self.linear_b_q = nn.Linear(rank, dim, bias=False)
        self.linear_a_v = nn.Linear(dim, rank, bias=False)
        self.linear_b_v = nn.Linear(rank, dim, bias=False)

    def forward(self, x):
        qkv = self.qkv(x)
        dim = x.shape[-1]
        qkv[..., :dim] += self.linear_b_q(self.linear_a_q(x))
        qkv[..., -dim:] += self.linear_b_v(self.linear_a_v(x))
        return qkv


class Attention(nn.Module):
    """An encoder block's attention over an h x w grid (a window or the
    whole grid of ``size`` a side)."""

    def __init__(self, dim: int, heads: int, size: int, rank: int):
        super().__init__()
        self.heads = heads
        self.qkv = LoRAQKV(dim, rank)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, h, w, c) -> (b, h, w, c)."""
        b, h, w, c = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        with span("samed.rel_pos_attention", device=True):
            mask = rel_pos_mask(q, self.rel_pos_h, self.rel_pos_w, h, w)
            count("rel_pos_attention_calls")
            # the default scale is SAM's head_dim ** -0.5
            out = _attention(q, k, v, mask)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


def window_partition(x: torch.Tensor, window: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(b, h, w, c) zero-padded at the bottom and right -> (b * windows,
    window, window, c) frame-major, and the padded (hp, wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = -h % window, -w % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, padded_hw, hw) -> torch.Tensor:
    (hp, wp), (h, w) = padded_hw, hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w] if hp > h or wp > w else x


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, window: int, grid: int, rank: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, window if window else grid, rank)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, mlp_dim)

    def forward(self, x):
        y = self.norm1(x)
        if self.window:
            h, w = y.shape[1:3]
            y, padded_hw = window_partition(y, self.window)
            y = window_unpartition(self.attn(y), self.window, padded_hw, (h, w))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, kernel_size=PATCH_SIZE, stride=PATCH_SIZE)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, grid: int, cin: int, dim: int, depth: int, heads: int, mlp_dim: int, out_chans: int,
                 window: int, global_attn_indexes, rank: int):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_dim, 0 if i in global_attn_indexes else window, grid, rank) for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out_chans, kernel_size=1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, kernel_size=3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def forward(self, x):
        x = self.patch_embed(x)
        if x.shape[1:3] != self.pos_embed.shape[1:3]:
            raise ValueError("the input gives a {}x{} grid; pos_embed is {}x{}".format(
                *x.shape[1:3], *self.pos_embed.shape[1:3]))
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn(2, num_pos_feats))

    def forward(self, size: int) -> torch.Tensor:
        """(C, size, size) encoding of the cell centres."""
        gauss = self.positional_encoding_gaussian_matrix
        c = (torch.arange(size, device=gauss.device, dtype=gauss.dtype) + 0.5) / size
        coords = torch.stack([c[None, :].expand(size, size), c[:, None].expand(size, size)], dim=-1)
        coords = 2 * math.pi * ((2 * coords - 1) @ gauss)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, dim: int, grid: int):
        super().__init__()
        self.grid = grid
        self.pe_layer = PositionEmbeddingRandom(dim // 2)
        self.no_mask_embed = nn.Embedding(1, dim)

    def dense_embeddings(self) -> torch.Tensor:
        """(1, C, g, g): no mask given."""
        return self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(1, -1, self.grid, self.grid)

    def get_dense_pe(self) -> torch.Tensor:
        return self.pe_layer(self.grid).unsqueeze(0)


class TwoWayAttention(nn.Module):
    """``segment_anything/modeling/transformer.py::Attention``: q, k and v
    projected to ``dim / downsample_rate``, heads, softmax(q k^T /
    sqrt(d)) v, projected back."""

    def __init__(self, dim: int, heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = dim // downsample_rate
        self.heads = heads
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(dim, internal)
        self.v_proj = nn.Linear(dim, internal)
        self.out_proj = nn.Linear(internal, dim)

    def _heads(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, q, k, v):
        out = F.scaled_dot_product_attention(self._heads(self.q_proj(q)), self._heads(self.k_proj(k)),
                                             self._heads(self.v_proj(v)))
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, downsample_rate: int, skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = TwoWayAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = TwoWayAttention(dim, heads, downsample_rate)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, F.relu)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = TwoWayAttention(dim, heads, downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, heads, mlp_dim, DOWNSAMPLE_RATE, i == 0) for i in range(depth))
        self.final_attn_token_to_image = TwoWayAttention(dim, heads, DOWNSAMPLE_RATE)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """(b, c, h, w), (1, c, h, w), (b, tokens, c) -> (queries, keys
        (b, h * w, c))."""
        keys = image_embedding.flatten(2).transpose(1, 2)
        image_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        attn = self.final_attn_token_to_image(queries + point_embedding, keys + image_pe, keys)
        return self.norm_final_attn(queries + attn), keys


class MLP(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int, layers: int):
        super().__init__()
        dims = [cin] + [hidden] * (layers - 1) + [cout]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MaskDecoder(nn.Module):
    def __init__(self, dim: int, tokens: int, heads: int, mlp_dim: int):
        super().__init__()
        self.transformer = TwoWayTransformer(DECODER_DEPTH, dim, heads, mlp_dim)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(tokens, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, kernel_size=2, stride=2),
            LayerNorm2d(dim // 4),
            nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, kernel_size=2, stride=2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(dim, dim, dim // 8, 3) for _ in range(tokens))

    def forward(self, src, image_pe):
        """``src`` the image embeddings plus the dense prompt embedding ->
        (masks (b, tokens, 4h, 4w), upscaled embedding (b, c / 8, 4h,
        4w))."""
        b, c, h, w = src.shape
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight]).unsqueeze(0).expand(b, -1, -1)
        hs, src = self.transformer(src, image_pe, tokens)
        upscaled = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        mask_tokens = hs[:, 1:]
        hyper_in = torch.stack([mlp(mask_tokens[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = (hyper_in @ upscaled.flatten(2)).view(b, -1, *upscaled.shape[2:])
        return masks, upscaled


class SAMed(nn.Module):
    """SAMed over SAM ViT-B (the defaults: ``build_sam_vit_b``'s widths;
    LoRA rank ``LORA_RANK``, decoder depth ``DECODER_DEPTH``) for ``size`` x ``size`` inputs. ``forward(x (B, 1, S,
    S))`` returns the class probabilities ``(B, n_classes, S, S)``, or
    ``(seg, heat_maps (B, num_lands, S, S))`` when ``num_lands > 0``."""

    def __init__(
        self,
        n_classes: int,
        size: int,
        num_lands: int = 0,
        embed_dim: int = 768,
        depth: int = 12,
        heads: int = 12,
        mlp_dim: int = 3072,
        window: int = 14,
        global_attn_indexes=(2, 5, 8, 11),
        prompt_dim: int = 256,
        decoder_heads: int = 8,
        decoder_mlp_dim: int = 2048,
        lands_num_1x1: int = 2,
    ):
        super().__init__()
        if size % PATCH_SIZE:
            raise ValueError("SAMed takes inputs whose side is a multiple of {}; got {}".format(PATCH_SIZE, size))
        if n_classes < 2:
            raise ValueError("SAMed needs a background and at least one class; got {}".format(n_classes))
        grid = size // PATCH_SIZE
        self.num_lands = num_lands
        self.image_encoder = ImageEncoderViT(grid, IN_CHANS, embed_dim, depth, heads, mlp_dim, prompt_dim, window,
                                             tuple(global_attn_indexes), LORA_RANK)
        self.prompt_encoder = PromptEncoder(prompt_dim, grid)
        self.mask_decoder = MaskDecoder(prompt_dim, n_classes, decoder_heads, decoder_mlp_dim)
        self.lands_1x1 = nn.ModuleList()
        if num_lands > 0:
            if lands_num_1x1 < 1:
                raise ValueError("the landmark head needs at least one 1x1 convolution")
            n_out = num_lands + (n_classes if lands_num_1x1 > 1 else 0)
            self.lands_1x1.append(nn.Conv2d(prompt_dim // 8 + n_classes, n_out, kernel_size=1, bias=False))
            for _ in range(lands_num_1x1 - 1):
                self.lands_1x1.append(nn.Conv2d(n_out, num_lands, kernel_size=1, bias=False))
                n_out = num_lands

    def set_bands(self, bands):
        """The full-res path clears the bands of row sharding with None;
        SAMed runs on whole frames only."""
        if bands is not None:
            raise ValueError("SAMed runs on whole frames; it cannot be row-sharded")
        return ()

    def forward(self, x):
        side = x.shape[-2:]
        with span("samed.encoder"):
            embeddings = self.image_encoder(x.repeat(1, IN_CHANS, 1, 1))
        with span("samed.decoder"):
            pe = self.prompt_encoder.get_dense_pe()
            masks, upscaled = self.mask_decoder(embeddings + self.prompt_encoder.dense_embeddings(), pe)
            seg = torch.softmax(F.interpolate(masks, side, mode="bilinear", align_corners=False), dim=1)
            if self.num_lands <= 0:
                return seg
            h = torch.cat([upscaled, masks], dim=1)
            for conv in self.lands_1x1:
                h = conv(h)
            heats = F.interpolate(h, side, mode="bilinear", align_corners=False)
        return seg, heats
