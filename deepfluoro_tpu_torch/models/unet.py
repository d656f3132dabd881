"""Joint segmentation + landmark-heatmap U-Net as an NCHW ``nn.Module``
(JAX counterpart: ``deepfluoro_tpu/models/unet.py``, itself a mirror of the
reference train_test_code/unet.py:41-260).

Module names are the reference's, so its ``.pt`` state dicts load as they
are and ``compat/torch_import.py`` of the JAX package reads this port's
checkpoints:

  downsample_convs.{i}                 learned 2x2 stride-2 downsampling;
                                       the deepest one exists but forward
                                       never uses it (unet.py:92,163-171)
  down_path.{i}.res_conv1x1            residual 1x1 shortcut
  down_path.{i}.block.{j}              [Conv3x3, ReLU, (BatchNorm)] x depth
  up_path.{k}.up                       ConvTranspose 2x2 stride 2 ('upconv'),
                                       or Sequential(Upsample, Conv1x1)
                                       ('upsample', weights at up.1)
  up_path.{k}.conv_block.*             as down_path
  seg_conv                             1x1 class head, no bias
  lands_block.{d}, lands_1x1.{j}       landmark head

Registration order is the reference's (downsample_convs before down_path,
res_conv1x1 before block), which fixes the state_dict and parameters()
order. BatchNorm follows the ReLU (unet.py:213-215) with eps 1e-5 and
torch momentum 0.1 (flax momentum 0.9). Its running statistics follow
flax: a train-mode forward of ``UNet`` moves the running variance toward
the biased batch variance (divisor n), where torch (and the reference)
take the unbiased one; see ``UNet.forward``.

``dtype=torch.bfloat16`` runs the convolutions and BatchNorm in bfloat16
under ``torch.autocast`` on the module's device, with float32 weights,
BatchNorm statistics, softmax and heatmaps, as the JAX package's
``dtype``. ``remat`` recomputes each down and up block's activations in
backward (``torch.utils.checkpoint``), as its ``nn.remat`` per block; the
recompute moves no BatchNorm running statistic, as flax discards the
recomputed ``batch_stats``.

Row sharding (``parallel/sharding.py::shard_rows``, set like the
BatchNorm group): the model then runs on one band of rows of each frame,
and every 3x3 convolution (``Conv3x3``) takes a one-row halo from the
neighbouring bands (``parallel/halo.py``), filled at the frame's edges
by its padding mode, pads its columns here and convolves unpadded. The
residual 1x1s, the 2x2 stride-2 downsamplings and the transposed
upsamplings are row-local as long as every band starts on a block of the
coarsest level (``parallel/mesh.py::row_layout``). Under remat the
recompute trades the halos again, in the same order on every band; under
bfloat16 a halo travels in its activation's dtype.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.parallel import sharding
from deepfluoro_tpu_torch.parallel.halo import sharded_conv2d
from deepfluoro_tpu_torch.parallel.mesh import Axis


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d (same buffers and state_dict keys) that records
    the values per channel of its last train-mode batch, ``n_last``, for
    the running-variance correction in ``UNet.forward``. While
    ``recomputing`` (a rematerialized block's forward, run again inside
    backward), a train-mode forward updates copies of the running
    statistics, which are thrown away: the output and the tensors saved
    for backward are those of the first forward.

    With a process ``group`` (``parallel/sharding.py::sync_batch_norm``,
    data parallelism) the train-mode statistics are those of the group's
    global batch, as the JAX package's data-parallel step computes them:
    ``n_last`` is the global count, and the running statistics take
    torch's update with it, so every rank's buffers stay equal and the
    correction gives flax's. ``nn.SyncBatchNorm`` is not used: its running
    variance keeps the n/(n-1) factor the correction removes. On
    row-sharded frames ``counts`` holds the frame rows of each rank of the
    group, which weigh their statistics."""

    n_last = 0
    recomputing = False
    group = None
    counts = ()

    def forward(self, x):
        if self.training:
            if self.group is not None:
                return self._synchronized(x)
            self.n_last = x.numel() // x.shape[1]
            if self.recomputing:
                return F.batch_norm(
                    x, self.running_mean.clone(), self.running_var.clone(), self.weight, self.bias, True,
                    self.momentum, self.eps,
                )
        return super().forward(x)

    def _synchronized(self, x):
        with torch.no_grad():
            mean, var, n = sharding.global_batch_stats(x, self.group, self.counts)
            self.n_last = n
            if not self.recomputing:
                self.running_mean.lerp_(mean.float(), self.momentum)
                self.running_var.lerp_((var * (n / (n - 1))).float(), self.momentum)
                self.num_batches_tracked.add_(1)
            invstd = torch.rsqrt(var + self.eps).float()
        return sharding.SyncBatchNormFn.apply(x, self.weight, self.bias, mean.float(), invstd, n, self.group)


class Conv3x3(nn.Conv2d):
    """torch's 3x3 Conv2d (same parameters and state_dict keys); over a
    'spatial' axis of several bands (``spatial``, set by ``parallel/
    sharding.py::shard_rows``) it convolves this rank's band of rows with
    a one-row halo of its neighbours."""

    spatial = Axis()

    def forward(self, x):
        if self.spatial.size == 1:
            return super().forward(x)
        return sharded_conv2d(x, self.weight, self.bias, self.spatial, self.padding_mode)


def _conv3x3(in_size: int, out_size: int, padding: bool, pad_mode: str) -> nn.Conv2d:
    return Conv3x3(in_size, out_size, kernel_size=3, padding=int(padding), padding_mode=pad_mode)


class UNetConvBlock(nn.Module):
    """[Conv3x3 -> ReLU -> (BN)] x block_depth with an optional residual 1x1
    shortcut (reference unet.py:196-233). With VALID convs the shortcut is
    center-cropped to the block output, as in the JAX package."""

    def __init__(self, in_size, out_size, padding, batch_norm, pad_mode="zeros", do_res=True, block_depth=2):
        super().__init__()
        assert block_depth > 0
        self.res_conv1x1 = nn.Conv2d(in_size, out_size, kernel_size=1) if do_res else None
        layers = []
        for d in range(block_depth):
            layers.append(_conv3x3(in_size if d == 0 else out_size, out_size, padding, pad_mode))
            layers.append(nn.ReLU())
            if batch_norm:
                layers.append(BatchNorm2d(out_size, eps=1e-5, momentum=0.1))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        if self.res_conv1x1 is not None:
            out = out + center_crop(self.res_conv1x1(x), out.shape[-2:])
        return out


class UNetUpBlock(nn.Module):
    """Upsample, concatenate the center-cropped skip, then a conv block
    (reference unet.py:236-260; concat order [up, bridge] per :257)."""

    def __init__(self, in_size, out_size, up_mode, padding, batch_norm, pad_mode="zeros", do_res=True, block_depth=2):
        super().__init__()
        if up_mode == "upconv":
            self.up = nn.ConvTranspose2d(in_size, out_size, kernel_size=2, stride=2)
        elif up_mode == "upsample":
            self.up = nn.Sequential(
                nn.Upsample(mode="bilinear", scale_factor=2),
                nn.Conv2d(in_size, out_size, kernel_size=1),
            )
        else:
            raise ValueError("up_mode must be 'upconv' or 'upsample', got {!r}".format(up_mode))
        self.conv_block = UNetConvBlock(2 * out_size, out_size, padding, batch_norm, pad_mode, do_res, block_depth)

    def forward(self, x, bridge):
        up = self.up(x)
        return self.conv_block(torch.cat([up, center_crop(bridge, up.shape[-2:])], dim=1))


class UNet(nn.Module):
    """The joint seg + landmark U-Net (reference unet.py:40-193), NCHW.

    ``forward(x (B, 1, H, W))`` returns the class probabilities
    ``(B, n_classes, H', W')`` (logits when ``do_soft_max=False``), or
    ``(seg, heat_maps (B, num_lands, H', W'))`` when ``num_lands > 0``."""

    def __init__(
        self,
        n_classes: int = 2,
        depth: int = 5,
        wf: int = 6,
        padding: bool = False,
        pad_mode: str = "zeros",
        batch_norm: bool = False,
        up_mode: str = "upconv",
        max_pool: bool = True,
        num_lands: int = 0,
        do_res: bool = True,
        block_depth: int = 2,
        lands_block_depth: int = 0,
        lands_num_1x1: int = 2,
        do_soft_max: bool = True,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.max_pool = max_pool
        self.num_lands = num_lands
        self.do_soft_max = do_soft_max

        self.downsample_convs = None
        if not max_pool:
            self.downsample_convs = nn.ModuleList(
                nn.Conv2d(2 ** (wf + i), 2 ** (wf + i), kernel_size=2, stride=2) for i in range(depth)
            )
        self.down_path = nn.ModuleList()
        prev = 1  # one input channel: the projection
        for i in range(depth):
            self.down_path.append(
                UNetConvBlock(prev, 2 ** (wf + i), padding, batch_norm, pad_mode, do_res, block_depth)
            )
            prev = 2 ** (wf + i)
        self.up_path = nn.ModuleList()
        for i in reversed(range(depth - 1)):
            self.up_path.append(
                UNetUpBlock(prev, 2 ** (wf + i), up_mode, padding, batch_norm, pad_mode, do_res, block_depth)
            )
            prev = 2 ** (wf + i)
        self.seg_conv = nn.Conv2d(prev, n_classes, kernel_size=1, bias=False)

        self.lands_block = nn.ModuleList()
        self.lands_1x1 = nn.ModuleList()
        if num_lands > 0:
            # 3x3 stack halving the channels (unet.py:113-137; the reference
            # hardcodes lands_use_non_lin=False, so no activations)
            chan = prev
            for d in range(lands_block_depth):
                self.lands_block.append(_conv3x3(chan if d == 0 else prev // 2, prev // 2, padding, pad_mode))
                chan = prev // 2
            assert lands_num_1x1 > 0
            n_out = num_lands + (n_classes if lands_num_1x1 > 1 else 0)
            self.lands_1x1.append(nn.Conv2d(chan + n_classes, n_out, kernel_size=1, bias=False))
            for _ in range(lands_num_1x1 - 1):
                self.lands_1x1.append(nn.Conv2d(n_out, num_lands, kernel_size=1, bias=False))
                n_out = num_lands
        self._bns = [m for m in self.modules() if isinstance(m, BatchNorm2d)]

    def forward(self, x):
        """In train mode, torch's BatchNorm moves each running variance to
        ``(1-m) old + m n/(n-1) var``; flax, whose running statistics the
        port keeps, to ``(1-m) old + m var`` (var biased, m = 0.1). The
        correction is one lerp of every layer toward ``(1-m) old`` with
        weight ``1/n``, as two multi-tensor launches per forward. It writes
        through ``.data``: autograd saved the buffers for backward, which in
        train mode does not read them. Outputs and gradients are torch's."""
        bns = self._bns if self.training else []
        if bns:
            old = torch._foreach_mul([m.running_var for m in bns], 1.0 - bns[0].momentum)
        if self.dtype == torch.float32:
            out = self._forward(x)
        else:
            with torch.autocast(x.device.type, dtype=self.dtype):
                out = self._forward(x)
        if bns:
            torch._foreach_lerp_([m.running_var.data for m in bns], old, [1.0 / m.n_last for m in bns])
        return out

    @contextlib.contextmanager
    def _recomputing(self):
        for m in self._bns:
            m.recomputing = True
        try:
            yield
        finally:
            for m in self._bns:
                m.recomputing = False

    def _block(self, block, *args):
        """``block(*args)``; with ``remat``, while gradients are recorded,
        its activations are recomputed in backward instead of kept."""
        if not (self.remat and torch.is_grad_enabled()):
            return block(*args)
        return checkpoint(
            block, *args, use_reentrant=False, context_fn=lambda: (contextlib.nullcontext(), self._recomputing())
        )

    def _forward(self, x):
        blocks = []
        depth = len(self.down_path)
        for i, down in enumerate(self.down_path):
            x = self._block(down, x)
            if i != depth - 1:
                blocks.append(x)
                if self.max_pool:
                    x = F.max_pool2d(x, 2)
                else:
                    x = self.downsample_convs[i](x)
        for j, up in enumerate(self.up_path):
            x = self._block(up, x, blocks[-j - 1])

        seg_logits = self.seg_conv(x)
        seg = torch.softmax(seg_logits.float(), dim=1) if self.do_soft_max else seg_logits.float()
        if self.num_lands <= 0:
            return seg

        h = x
        for conv in self.lands_block:
            h = conv(h)
        h = torch.cat([h, center_crop(seg_logits, h.shape[-2:])], dim=1)
        for conv in self.lands_1x1:
            h = conv(h)
        return seg, h.float()
