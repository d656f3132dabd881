"""The collectives of the data, fold and member axes (JAX counterpart:
``deepfluoro_tpu/parallel/sharding.py``, where GSPMD inserts them).

- **Data parallel**: parameters and optimizer state are replicated, each
  process takes a slice of the global batch. BatchNorm's statistics are
  those of the global batch (``global_batch_stats`` and
  ``SyncBatchNormFn``, which ``models/unet.py::BatchNorm2d`` runs when it
  holds a group), and the gradient is the mean over the global batch:
  each process's loss is the mean over its equal slice, so the mean of
  the processes' gradients (``average_gradients``) is the gradient of the
  global mean, as JAX's replicated step computes it.
- **Ensemble (folds, members)**: independent per process; the per-fold
  losses and the member sums are gathered or summed.
- **Spatial**: each process holds a band of rows of its data slice's
  frames (``parallel/mesh.py::RowShard``); the U-Net's 3x3 convolutions
  trade halo rows (``parallel/halo.py``, ``shard_rows``). BatchNorm's
  statistics span 'data' x 'spatial', each rank weighted by its rows,
  which the layout gives on the host. The losses' per-image sums are
  summed over the bands (``spatial_sum``), so every band of a data slice
  computes that slice's loss. The sums' backward sums the bands'
  gradients too, so each band's gradient is S times its rows' share, and
  the step's mean over 'data' x 'spatial' is the gradient of the global
  batch (``average_gradients``).

Every collective here is an ``all_reduce``, which gloo also takes on CUDA
tensors (two gloo ranks can share one card; NCCL refuses that); a gather
is an ``all_reduce`` of a zero buffer in which each rank fills its own
rows (exact: x + 0 = x).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deepfluoro_tpu_torch.parallel.mesh import Axis


def _flag_device(group):
    """Where a small control tensor of ``group`` lives: NCCL takes CUDA
    tensors only, gloo either."""
    backend = dist.get_backend(group)
    return torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The concatenation over ``axis``'s ranks, in rank order, of each
    rank's ``x`` (same shape on every rank): (size * x.shape[0], ...)."""
    if axis.size == 1:
        return x
    buf = x.new_zeros((axis.size,) + tuple(x.shape))
    buf[axis.index] = x
    dist.all_reduce(buf, group=axis.group)
    return buf.reshape((-1,) + tuple(x.shape[1:]))


def gather_bands(t: torch.Tensor, shard, batch_rows: slice, b: int, crop_hw) -> torch.Tensor:
    """The whole (b, ..., h, w) array of which this process holds ``t``:
    the batch rows ``batch_rows`` (its data slice) and its band's rows
    (``shard``, a ``RowShard``) of the frames' center crop to ``crop_hw``;
    every process's part summed into a zero buffer over 'data' x
    'spatial', so every process gets it (exact: x + 0 = x)."""
    _, rows = shard.window(crop_hw[0])
    buf = t.new_zeros((b,) + tuple(t.shape[1:-2]) + tuple(crop_hw))
    buf[batch_rows, ..., rows, :] = t
    if shard.joint.size > 1:
        dist.all_reduce(buf, group=shard.joint.group)
    return buf


def sum_over(values, group=None) -> list[float]:
    """Elementwise sums, over the processes of ``group`` (default: all),
    of a list of numbers, in float64; the list itself for one process."""
    values = [float(v) for v in values]
    if not dist.is_initialized():
        return values
    t = torch.tensor(values, dtype=torch.float64, device=_flag_device(group))
    dist.all_reduce(t, group=group)
    return t.tolist()


def gather_folds(values, axis: Axis, total: int) -> list[float]:
    """The (``total``,) list of which this rank holds the contiguous block
    ``axis.rows(total)``: every rank's block, summed into the full list."""
    full = [0.0] * total
    full[axis.rows(total)] = [float(v) for v in values]
    return full if axis.size == 1 else sum_over(full, axis.group)


def count_true(flag: bool, group=None) -> int:
    """On how many processes of ``group`` (default: all) ``flag`` holds."""
    return int(sum_over([1.0 if flag else 0.0], group)[0])


def agree_any(flag: bool, group=None) -> bool:
    """Whether ``flag`` holds on any process of ``group`` (default: all)."""
    return count_true(flag, group) > 0


def barrier(group=None) -> None:
    """Every process of ``group`` (default: all) has reached this point
    (an ``all_reduce``: gloo's ``barrier`` takes no CUDA tensors)."""
    count_true(True, group)


def average_gradients(params, loss: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Replace each parameter's gradient with its mean over ``axis``'s
    ranks, and return the mean of ``loss`` over them: one ``all_reduce``
    of a flat buffer of every gradient and the loss. Parameters without a
    gradient (the U-Net's deepest downsampling conv, which forward never
    uses) have none on any rank and stay so.

    A row-sharded step averages over 'data' x 'spatial' (``RowShard.
    joint``): every band of a data slice holds the slice's loss and
    (``spatial_sum``'s backward) S times its rows' share of the slice's
    gradient, so the sum over the S bands, divided by S, is the slice's
    gradient."""
    if axis.size == 1:
        return loss
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=axis.group)
    flat.div_(axis.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1]


class _SpatialSum(torch.autograd.Function):
    """The sum over the bands, whose backward sums the bands' gradients:
    what follows the sum on one band (its own rows' centered values, the
    loss) feeds the sum's gradient on every band. Every band computes the
    same loss, so each band's gradients come out S times its share, which
    ``average_gradients`` divides out."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def spatial_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` (a per-image partial sum over this band's rows) summed over
    the bands of ``axis``; ``x`` itself for one band."""
    return x if axis.size == 1 else _SpatialSum.apply(x, axis.group)


def global_batch_stats(x: torch.Tensor, group, counts=()):
    """Per-channel (mean, biased variance) of ``x`` (B, C, H, W) over the
    batches of every rank of ``group``, in float64, and the global count
    of values per channel. Every rank's batch has the shape of this one
    (the data axis splits each global batch evenly), or, with ``counts``
    (the frame rows each rank of the group holds, in group order: a
    row-sharded frame), the shape of this one with the rows scaled by
    its count; so every count is known here and the host waits on
    nothing. Each rank's (mean, M2) is gathered and combined by Chan's
    rule, weighted by the counts, so no rank's sum of squares cancels."""
    dims = (0, 2, 3)
    c = x.shape[1]
    n_local = x.numel() // c
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    mean = torch.sum(x, dims, dtype=torch.float64) / n_local
    m2 = torch.sum(torch.square(x - mean.to(x.dtype)[None, :, None, None]), dims, dtype=torch.float64)
    stats = x.new_zeros((size, 2 * c), dtype=torch.float64)
    stats[me] = torch.cat([mean, m2])
    dist.all_reduce(stats, group=group)
    means, m2s = stats[:, :c], stats[:, c:]
    if not counts:
        g_mean = means.sum(0) / size
        g_m2 = m2s.sum(0) + n_local * torch.square(means - g_mean).sum(0)
        n = n_local * size
        return g_mean, g_m2 / n, n
    # this level's rows of rank r: its frame rows over the level's stride
    rows = x.shape[2]
    per_row = n_local // rows
    ns = [per_row * (counts[r] * rows // counts[me]) for r in range(size)]
    n = sum(ns)
    w = torch.tensor(ns, dtype=torch.float64, device=x.device)[:, None]
    g_mean = (means * w).sum(0) / n
    g_m2 = m2s.sum(0) + (w * torch.square(means - g_mean)).sum(0)
    return g_mean, g_m2 / n, n


class SyncBatchNormFn(torch.autograd.Function):
    """BatchNorm's train-mode normalization with statistics of the global
    batch (``mean``, ``invstd``, ``n`` values per channel over ``group``).
    Backward reduces the two per-channel gradient sums over the group, so
    each rank's input gradient carries every rank's loss through the
    shared statistics; the weight and bias gradients stay this rank's
    sums, which the gradient average then reduces with the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, n, group):
        shape = (1, -1, 1, 1)
        xf = x.float()
        y = (xf - mean.view(shape)) * invstd.view(shape) * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n, ctx.group = n, group
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dims = (0, 2, 3)
        g = grad_out.float()
        x_hat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_g = g.sum(dims)
        sum_gx = (g * x_hat).sum(dims)
        both = torch.cat([sum_g, sum_gx])
        dist.all_reduce(both, group=ctx.group)
        c = sum_g.numel()
        mean_g, mean_gx = both[:c] / ctx.n, both[c:] / ctx.n
        grad_x = (g - mean_g.view(shape) - x_hat * mean_gx.view(shape)) * (invstd * weight).view(shape)
        return grad_x.to(x.dtype), sum_gx, sum_g, None, None, None, None


def sync_batch_norm(model: torch.nn.Module, axis: Axis, counts=()) -> None:
    """Make every ``models/unet.py::BatchNorm2d`` of ``model`` compute its
    train-mode statistics over ``axis``'s global batch (JAX: the DP step's
    BatchNorm sees the whole sharded batch); ``counts`` as
    ``global_batch_stats``'s, for row-sharded frames. A size-1 axis leaves
    the plain cuDNN path."""
    from deepfluoro_tpu_torch.models.unet import BatchNorm2d

    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = axis.group if axis.size > 1 else None
            m.counts = tuple(counts) if axis.size > 1 else ()


def shard_rows(model: torch.nn.Module, shard) -> None:
    """Run ``model`` (a ``models/unet.py::UNet``) on bands of rows over
    ``shard``'s 'spatial' axis (a ``RowShard``): each 3x3 convolution
    takes a one-row halo by its padding mode, and train-mode BatchNorm's
    statistics span 'data' x 'spatial'. The U-Net must pad its
    convolutions (a valid convolution would shrink bands unevenly) and
    upsample with transposed convolutions (a bilinear upsampling mixes
    rows across bands): ValueError otherwise."""
    from deepfluoro_tpu_torch.models.unet import Conv3x3

    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    if shard.axis.size > 1:
        if any(m.padding != (1, 1) for m in convs):
            raise ValueError("row sharding needs padded convolutions (--unet-padding): a valid convolution shrinks "
                             "the bands")
        if any(isinstance(m, torch.nn.Upsample) for m in model.modules()):
            raise ValueError("row sharding needs up_mode 'upconv': a bilinear upsampling mixes rows across bands")
    for m in convs:
        m.spatial = shard.axis
    sync_batch_norm(model, shard.joint, shard.counts)
