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

Row sharding (``parallel/sharding.py::shard_rows``, which calls
``UNet.set_bands``): the model then runs on one band of rows of each
frame. ``set_bands`` walks the network's geometry on the host and gives
every layer that maps rows its plan (``parallel/halo.py``): each 3x3
convolution (``Conv3x3.rows``: its window, the halo rows filled at the
frame's edges by its padding mode), each stride-2 downsampling
(``UNet.pool_rows``), each upsampling (``UNetUpBlock.up_rows``), the
residual shortcut's, the skip's and the landmark head's center crops
(``res_rows``, ``bridge_rows``, ``lands_rows``), and each BatchNorm the
rows every rank holds of its layer (``BatchNorm2d.counts``). The plans
of a 'same' 'upconv' U-Net on bands of whole coarsest-level blocks trade
one row a side at each 3x3 convolution and nothing else. Under remat the
recompute trades the rows again, in the same order on every band; under
bfloat16 the rows travel in their activation's dtype.

Tensor parallelism (``parallel/tensor.py::shard_channels``): a
convolution (``Conv2d``, ``ConvTranspose2d``, ``Conv3x3``) cut over
'model' holds ``channels`` (its BatchNorm is cut with it); it takes its
input through ``enter``, and its output (after ReLU and BatchNorm) is
gathered (``gather_channels``) before the next layer that needs every
channel.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.parallel import sharding
from deepfluoro_tpu_torch.parallel.halo import band_conv2d, band_op, fetch_rows, frame_map
from deepfluoro_tpu_torch.parallel.mesh import Axis
from deepfluoro_tpu_torch.parallel.tensor import enter, gather_channels


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
    row-sharded frames ``counts`` holds the rows of this layer's map each
    rank of the group holds (``UNet.set_bands``; a rank may hold none),
    which weigh their statistics. Cut over a 'model' axis it holds its
    channels' share and normalizes those."""

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
        dt = torch.promote_types(x.dtype, torch.float32)  # float32, or a float64 model's float64
        with torch.no_grad():
            mean, var, n = sharding.global_batch_stats(x, self.group, self.counts)
            self.n_last = n
            if not self.recomputing:
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_((var * (n / (n - 1))).to(self.running_var.dtype), self.momentum)
                self.num_batches_tracked.add_(1)
            invstd = torch.rsqrt(var + self.eps).to(dt)
        return sharding.SyncBatchNormFn.apply(x, self.weight, self.bias, mean.to(dt), invstd, n, self.group)


class Conv2d(nn.Conv2d):
    """torch's Conv2d (same parameters and state_dict keys) that takes its
    input through ``enter`` when it is cut over a 'model' axis
    (``channels``)."""

    channels = Axis()

    def forward(self, x):
        return super().forward(enter(x, self.channels))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch's ConvTranspose2d, with ``Conv2d``'s 'model' axis."""

    channels = Axis()

    def forward(self, x):
        return super().forward(enter(x, self.channels))


class Conv3x3(Conv2d):
    """A 3x3 ``Conv2d``; on a band of rows (``rows``, a ``parallel/halo.py::
    Fetch`` set by ``set_bands``) it convolves its window of the band's
    rows, unpadded in rows, its columns padded here."""

    rows = None

    def forward(self, x):
        if self.rows is None:
            return super().forward(x)
        return band_conv2d(enter(x, self.channels), self.weight, self.bias, self.rows, self.padding[1],
                           self.padding_mode)

    def set_bands(self, bands, m):
        """This convolution's plan on ``bands`` (None: none) for its input
        map ``m``; returns its output map."""
        if bands is None:
            self.rows = None
            return m
        self.rows, out = bands.conv(m, 3, self.padding[0], self.padding_mode)
        return out


def _conv3x3(in_size: int, out_size: int, padding: bool, pad_mode: str) -> nn.Conv2d:
    return Conv3x3(in_size, out_size, kernel_size=3, padding=int(padding), padding_mode=pad_mode)


def crop_to(t, plan, hw):
    """``t`` center-cropped to ``hw`` (rows, columns); on a band (``plan``
    from ``Bands.crop``) the band's rows of the crop and the columns."""
    if plan is None:
        return center_crop(t, hw)
    t = fetch_rows(t, plan)
    if t.shape[-1] == hw[1]:
        return t
    c0 = (t.shape[-1] - hw[1]) // 2
    return t[..., c0 : c0 + hw[1]]


class UNetConvBlock(nn.Module):
    """[Conv3x3 -> ReLU -> (BN)] x block_depth with an optional residual 1x1
    shortcut (reference unet.py:196-233). With VALID convs the shortcut is
    center-cropped to the block output, as in the JAX package."""

    res_rows = None

    def __init__(self, in_size, out_size, padding, batch_norm, pad_mode="zeros", do_res=True, block_depth=2):
        super().__init__()
        assert block_depth > 0
        self.res_conv1x1 = Conv2d(in_size, out_size, kernel_size=1) if do_res else None
        layers = []
        for d in range(block_depth):
            layers.append(_conv3x3(in_size if d == 0 else out_size, out_size, padding, pad_mode))
            layers.append(nn.ReLU())
            if batch_norm:
                layers.append(BatchNorm2d(out_size, eps=1e-5, momentum=0.1))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        channels = self.block[0].channels
        out = x
        for layer in self.block:
            if isinstance(layer, nn.Conv2d) and out is not x:
                out = gather_channels(out, channels)
            out = layer(out)
        if self.res_conv1x1 is not None:
            out = out + crop_to(band_op(self.res_conv1x1, x, None), self.res_rows, out.shape[-2:])
        return gather_channels(out, channels)

    def set_bands(self, bands, m):
        m_in = m
        for layer in self.block:
            if isinstance(layer, Conv3x3):
                m = layer.set_bands(bands, m)
            elif isinstance(layer, BatchNorm2d):
                layer.counts = () if bands is None else bands.counts(m)
        self.res_rows = None if bands is None else bands.crop(m_in, m)[0]
        return m


class UNetUpBlock(nn.Module):
    """Upsample, concatenate the center-cropped skip, then a conv block
    (reference unet.py:236-260; concat order [up, bridge] per :257)."""

    up_rows = None
    bridge_rows = None

    def __init__(self, in_size, out_size, up_mode, padding, batch_norm, pad_mode="zeros", do_res=True, block_depth=2):
        super().__init__()
        if up_mode == "upconv":
            self.up = ConvTranspose2d(in_size, out_size, kernel_size=2, stride=2)
        elif up_mode == "upsample":
            self.up = nn.Sequential(
                nn.Upsample(mode="bilinear", scale_factor=2),
                Conv2d(in_size, out_size, kernel_size=1),
            )
        else:
            raise ValueError("up_mode must be 'upconv' or 'upsample', got {!r}".format(up_mode))
        self.conv_block = UNetConvBlock(2 * out_size, out_size, padding, batch_norm, pad_mode, do_res, block_depth)

    def forward(self, x, bridge):
        if isinstance(self.up, nn.ConvTranspose2d):
            up, conv = band_op(self.up, x, self.up_rows), self.up
        else:
            up, conv = band_op(self.up[1], band_op(self.up[0], x, self.up_rows), None), self.up[1]
        up = gather_channels(up, conv.channels)
        return self.conv_block(torch.cat([up, crop_to(bridge, self.bridge_rows, up.shape[-2:])], dim=1))

    def set_bands(self, bands, m, skip):
        if bands is None:
            self.up_rows = self.bridge_rows = None
            return self.conv_block.set_bands(None, m)
        self.up_rows, m = bands.up(m, bilinear=not isinstance(self.up, nn.ConvTranspose2d))
        self.bridge_rows = bands.crop(skip, m)[0]
        return self.conv_block.set_bands(bands, m)


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
                Conv2d(2 ** (wf + i), 2 ** (wf + i), kernel_size=2, stride=2) for i in range(depth)
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
        self.seg_conv = Conv2d(prev, n_classes, kernel_size=1, bias=False)

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
            self.lands_1x1.append(Conv2d(chan + n_classes, n_out, kernel_size=1, bias=False))
            for _ in range(lands_num_1x1 - 1):
                self.lands_1x1.append(Conv2d(n_out, num_lands, kernel_size=1, bias=False))
                n_out = num_lands
        self._bns = [m for m in self.modules() if isinstance(m, BatchNorm2d)]
        self.pool_rows = [None] * (depth - 1)
        self.lands_rows = None

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

    def set_bands(self, bands):
        """Give every layer that maps rows its plan on ``bands`` (a
        ``parallel/halo.py::Bands`` of the padded input frame; None clears
        them) and each BatchNorm its layer's row counts, walking the
        geometry of ``_forward``. Returns (start, stop, total) of this
        band's rows of the output map, () for None."""
        if bands is None:
            m = frame_map(1)
        else:
            m = frame_map(bands.bounds[-1])
        skips = []
        depth = len(self.down_path)
        for i, down in enumerate(self.down_path):
            m = down.set_bands(bands, m)
            if i != depth - 1:
                skips.append(m)
                self.pool_rows[i], m = (None, m) if bands is None else bands.down(m)
        for j, up in enumerate(self.up_path):
            m = up.set_bands(bands, m, skips[-j - 1])
        feat = m
        for conv in self.lands_block:
            feat = conv.set_bands(bands, feat)
        if bands is None:
            self.lands_rows = None
            return ()
        if self.num_lands > 0 and feat != m:
            raise ValueError("row sharding puts a valid landmark 3x3 block's heatmaps on other rows than the classes: "
                             "pad the convolutions or drop the block")
        self.lands_rows = bands.crop(m, feat)[0]
        lo, hi = bands.owned(m)[bands.axis.index]
        return lo, hi, m.rows

    def _forward(self, x):
        blocks = []
        depth = len(self.down_path)
        for i, down in enumerate(self.down_path):
            x = self._block(down, x)
            if i != depth - 1:
                blocks.append(x)
                if self.max_pool:
                    x = band_op(lambda t: F.max_pool2d(t, 2), x, self.pool_rows[i], 2)
                else:
                    conv = self.downsample_convs[i]
                    x = gather_channels(band_op(conv, x, self.pool_rows[i], 2), conv.channels)
        for j, up in enumerate(self.up_path):
            x = self._block(up, x, blocks[-j - 1])

        seg_logits = gather_channels(band_op(self.seg_conv, x, None), self.seg_conv.channels)
        seg = torch.softmax(seg_logits.float(), dim=1) if self.do_soft_max else seg_logits.float()
        if self.num_lands <= 0:
            return seg

        h = x
        for conv in self.lands_block:
            h = gather_channels(conv(h), conv.channels)
        h = torch.cat([h, crop_to(seg_logits, self.lands_rows, h.shape[-2:])], dim=1)
        for conv in self.lands_1x1:
            h = gather_channels(band_op(conv, h, None), conv.channels)
        return seg, h.float()
