"""Full-resolution ensemble inference: raw archive -> nn-segs/nn-heats
(JAX counterpart: ``deepfluoro_tpu/infer/fullres.py``).

The reference serves only preprocessed per-rung archives
(hdf5_layouts/Readme.md:42-45). Here each batch of raw frames goes through
the whole preprocess on the device (crop 50 px, Beer-Lambert log, rot-180
where flagged, downsample, reflect-pad, z-norm: ``data/preprocess.py::
make_fullres_prep``) and then the ensemble forward of ``infer/ensemble.py``
(K forwards, per-member min-max heats, member mean, argmax), so one
call serves raw 1536^2 frames at any downsample factor.

As for ``ensemble_batches``, the device half (``fullres_batches``) takes
frames from a reader callable and yields host batches, so it runs where
h5py is not installed; ``seg_fullres_dataset`` reads the archive and
writes the output through ``write_ensemble_outputs``: ``nn-segs`` (N, h,
w) u1 gzip 9 and ``nn-heats`` (N, L, h, w), in (specimen, projection-key)
order and in the preprocessed orientation, so ``est_lands_csv`` and
``compute_actual_dice_on_test`` read them against a preprocessed archive
of the same factor. ``quantized`` runs the members' int8 forwards
(``infer/quantized.py``), calibrated on the first batch of frames run
through the same prep. A mesh of 'data' and 'spatial' processes
(``fullres_batches(mesh=...)``, float or int8) splits each batch's frames
over 'data' and their rows over 'spatial'.

Every forward of ``fullres_batches`` (its warm-up, each batch, the int8
calibration) runs inside ``measured_algorithms``: cuDNN times the
candidate algorithms of each convolution shape once and keeps the
fastest, in plan-cache entries of the full-res path's own.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

import torch.distributed as dist

from deepfluoro_tpu_torch.data.preprocess import fullres_crop_size, fullres_shard, make_fullres_prep
from deepfluoro_tpu_torch.infer.ensemble import ensemble_forward, write_ensemble_outputs
from deepfluoro_tpu_torch.models.unet import UNet
from deepfluoro_tpu_torch.parallel.multihost import is_writer
from deepfluoro_tpu_torch.parallel.sharding import gather_bands
from deepfluoro_tpu_torch.utils.profiling import count, span

# candidates cuDNN times per convolution shape under measured_algorithms (in
# the order of its heuristics; torch's default is 10): at the 2x rung on an
# H100 the first forward then takes 2.8 s instead of 5.0-5.4 s, and the
# forward 49.5 ms instead of 49.1-49.4 ms
MEASURED_CANDIDATES = 5


@contextlib.contextmanager
def measured_algorithms():
    """A scope in which cuDNN picks each convolution's algorithm by timing
    its candidates (``torch.backends.cudnn.benchmark``), once per shape,
    at most ``MEASURED_CANDIDATES`` of them; the caller's ``benchmark``,
    ``deterministic`` and ``benchmark_limit`` come back on exit, also on
    an exception. TF32 and ``enabled`` stay as the caller set them."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic, cudnn.benchmark_limit
    # deterministic is set for the plan cache's key, not for
    # reproducibility: torch keys its cached cuDNN plans by shape, strides,
    # dtype, layout, deterministic and TF32, not by benchmark, so without it
    # a plan the heuristic chose for an earlier forward at the same shape
    # (a BatchNorm calibration, say) would be reused here. It costs the
    # transposed convolutions their fastest, non-deterministic algorithms:
    # 6.7 against 2.9 ms of a 49-50 ms forward at the 2x rung on an H100.
    # Measurement may pick other algorithms in another process.
    cudnn.benchmark = cudnn.deterministic = True
    cudnn.benchmark_limit = MEASURED_CANDIDATES
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic, cudnn.benchmark_limit = saved


def list_fullres_frames(src, specimens=None):
    """(specimen, projection-key) index of an open full-res archive, in
    the given specimen order (default: every specimen group in file order)
    and sorted projection keys."""
    if specimens is None:
        specimens = [k for k in src.keys() if k != "proj-params"]
    entries = []
    for spec in specimens:
        if spec not in src:
            raise ValueError(
                "specimen group '{}' not in the archive (has: {})".format(
                    spec, ", ".join(k for k in src.keys() if k != "proj-params")
                )
            )
        for pk in sorted(src[spec]["projections"].keys()):
            entries.append((spec, pk))
    return entries


def fullres_land_names(src, entries):
    """Landmark names from the first projection carrying gt-landmarks, in
    sorted order (``full_res_to_preprocessed``'s convention), or None."""
    for spec, pk in entries:
        pg = src[spec]["projections"][pk]
        if "gt-landmarks" in pg:
            return sorted(pg["gt-landmarks"].keys())
    return None


def fullres_batches(
    read_batch,
    n: int,
    full_hw,
    models,
    ds_factor: int,
    num_lands: int = 0,
    times: list | None = None,
    batch_size: int = 4,
    pad_img_dim: int = 0,
    quantized: bool = False,
    int8_float_levels: int = 0,
    mesh=None,
):
    """A generator of ``(start, labels (b, h, w) uint8, heats (b, L, h, w)
    float32 or None)`` numpy batches of the ensemble over ``n`` raw frames,
    in order, on the members' device.

    ``read_batch(i0, i1) -> (projs (i1 - i0, H, W) float32, rot_flags
    (i1 - i0,) bool)`` numpy arrays gives the frames. A final partial batch
    is padded with its last frame, so every batch has one shape, run once
    before the timing starts. With ``times`` each real frame gets its
    batch's wall-clock over the real frames: the copy to the device, prep,
    K forwards, mean and argmax, up to a synchronise; the readback falls
    outside. Each batch's arrays are its own: they stay valid and unchanged
    however long the consumer keeps them. On a CUDA device they are in
    page-locked host memory, copied there from the device with one wait a
    batch. Raises ValueError at once when the nets' ``pad_img_dim`` is
    below the frame size at ``ds_factor`` (nets of another rung). Every
    forward runs inside ``measured_algorithms``, and never across a
    yield: the consumer runs under the caller's cuDNN flags.

    With ``quantized`` the forwards are int8 (the finest
    ``int8_float_levels`` levels in float), with activation scales
    calibrated here, before the generator starts, on the first
    ``min(batch_size, n)`` whole frames through the same prep (on a mesh
    too: every process reads them and gets the same scales, bit for bit,
    before its members are set to bands).

    With a ``mesh`` of 'data' and 'spatial' axes every process calls this
    in lockstep with the whole ensemble and reads the same frames; each
    runs its data slice of every batch (the batch size must divide by the
    'data' axis) on its band of rows (the module docstring). Process 0
    yields the arrays; the others yield (start, None, None). The members'
    layers stay set to the bands (a later call without a mesh clears
    them)."""
    if n == 0:
        raise ValueError("no projections selected")
    hc = fullres_crop_size(ds_factor, full_hw)[0]
    if pad_img_dim < hc:
        raise ValueError(
            "checkpoint proj_unet_dim {} is smaller than the {}x frame size {} — these nets were trained "
            "for a different downsample factor".format(pad_img_dim, ds_factor, hc)
        )
    prep, orig_hw = make_fullres_prep(ds_factor, pad_img_dim, full_hw)
    batch_size = min(batch_size, n)
    dev = next(models[0].parameters()).device
    for model in models:
        model.eval().set_bands(None)
    if mesh is not None:
        if not all(isinstance(m, UNet) for m in models):
            raise ValueError("full-res inference on a mesh shards U-Net members only; TransUNet runs on one device")
        if set(mesh.axis_names) - {"data", "spatial"}:
            raise ValueError("full-res inference shards over 'data' and 'spatial' axes only; got {}".format(mesh.axes))
        if batch_size % mesh.axis("data").size:
            raise ValueError("batch size {} does not shard evenly over the {}-way 'data' mesh axis".format(
                batch_size, mesh.axis("data").size))
    fwds = models
    if quantized:
        # scales from whole frames, before any member is set to bands:
        # every process reads the same frames and computes the same scales
        from deepfluoro_tpu_torch.infer.quantized import int8_forwards

        projs, rots = read_batch(0, batch_size)
        with measured_algorithms():
            fwds = int8_forwards(models, [prep(torch.from_numpy(projs).to(dev), torch.from_numpy(rots).to(dev))],
                                 int8_float_levels)
    if mesh is not None:
        for model in models:
            shard, _ = fullres_shard(model, mesh, ds_factor, pad_img_dim, full_hw)
        run = _sharded_run(fwds, prep, orig_hw, num_lands, mesh, shard)
        return _batches(read_batch, n, tuple(full_hw), run, dev, times, batch_size, is_writer())

    def run(projs, rots):
        _, heats, labels = ensemble_forward(fwds, prep(projs, rots), orig_hw, num_lands)
        return labels, heats

    return _batches(read_batch, n, tuple(full_hw), run, dev, times, batch_size)


def _band_member_mean(models, x, shard, orig_hw, num_lands: int):
    """The member means of one band's rows of the crop (``models``:
    modules or int8 forwards): softmax seg and heats min-max normalized
    per image over the whole frame (the band minima and maxima reduced
    over 'spatial'; a band with no rows of the crop gives none)."""
    seg_sum = heat_sum = None
    for model in models:
        out = model(x)
        seg, heats = out if num_lands > 0 else (out, None)
        seg = shard.crop(seg, orig_hw)
        seg_sum = seg if seg_sum is None else seg_sum + seg
        if heats is not None:
            heats = shard.crop(heats, orig_hw)
            if heats.shape[2]:
                ext = torch.cat([heats.amax(dim=(1, 2, 3)), -heats.amin(dim=(1, 2, 3))])
            else:
                ext = heats.new_full((2 * heats.shape[0],), -torch.inf)
            if shard.axis.size > 1:
                dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=shard.axis.group)
            b = heats.shape[0]
            hmax, hmin = ext[:b, None, None, None], -ext[b:, None, None, None]
            heats = (heats - hmin) / (hmax - hmin)
            heat_sum = heats if heat_sum is None else heat_sum + heats
    k = len(models)
    return seg_sum / k, None if heat_sum is None else heat_sum / k


def _sharded_run(models, prep, orig_hw, num_lands, mesh, shard):
    """``run(projs, rots) -> (labels, heats)`` of the whole batch on every
    process: this process's data slice and band, gathered."""
    data = mesh.axis("data")

    def run(projs, rots):
        b = int(projs.shape[0])
        local = data.rows(b)
        x = prep(projs[local], rots[local])[:, :, shard.start : shard.stop]
        seg, heats = _band_member_mean(models, x, shard, orig_hw, num_lands)
        labels = gather_bands(seg.argmax(dim=1).to(torch.int32), shard, local, b, orig_hw).to(torch.uint8)
        return labels, None if heats is None else gather_bands(heats, shard, local, b, orig_hw)

    return run


@torch.no_grad()
def _batches(read_batch, n, full_hw, run, dev, times, batch_size, writer=True):
    """Drive ``run(projs, rots) -> (labels, heats)`` over the frames (the
    generator ``fullres_batches`` returns)."""

    def sync():
        count("host_syncs")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def readback(*xs):
        # on a card the copies land in page-locked blocks of torch's caching
        # host allocator (the DMA engine writes the arrays the consumer gets,
        # where a pageable copy is staged through a CUDA bounce buffer);
        # a block is reused only once its array is freed, so each batch's
        # arrays are its own however long they are kept
        count("host_syncs")
        if dev.type != "cuda":
            return [None if x is None else x.cpu().numpy() for x in xs]
        hosts = [None if x is None else torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x, non_blocking=True)
                 for x in xs]
        torch.cuda.current_stream(dev).synchronize()
        count("pinned_readbacks")
        return [None if h is None else h.numpy() for h in hosts]

    with measured_algorithms():
        run(torch.ones((batch_size, *full_hw), device=dev), torch.zeros((batch_size,), dtype=torch.bool, device=dev))
    sync()

    for i0 in range(0, n, batch_size):
        # no span stays open across the yield, where the consumer runs
        with span("fullres.batch", i0):
            i1 = min(i0 + batch_size, n)
            real_b = i1 - i0
            projs, rots = read_batch(i0, i1)
            if real_b < batch_size:
                pad = batch_size - real_b
                projs = np.concatenate([projs, np.repeat(projs[-1:], pad, axis=0)])
                rots = np.concatenate([rots, np.repeat(rots[-1:], pad)])
            t0 = time.perf_counter()
            with span("fullres.copy_up", i0):
                projs, rots = torch.from_numpy(projs).to(dev), torch.from_numpy(rots).to(dev)
            with span("fullres.forward", i0), measured_algorithms():
                labels, heats = run(projs, rots)
                count("measured_algo_runs")
            with span("fullres.sync", i0):
                sync()
            elapsed = time.perf_counter() - t0
            if times is not None:
                times.extend([elapsed / real_b] * real_b)
            if writer:
                with span("fullres.readback", i0):
                    labels, heats = readback(labels[:real_b], None if heats is None else heats[:real_b])
            else:
                labels = heats = None
        yield i0, labels, heats


def seg_fullres_dataset(
    src,
    specimens,
    models,
    h5_f,
    ds_factor: int,
    num_lands: int = 0,
    times: list | None = None,
    batch_size: int = 4,
    pad_img_dim: int = 0,
    quantized: bool = False,
    int8_float_levels: int = 0,
):
    """Run the ensemble over the raw frames of the open full-res archive
    ``src`` (``specimens``: group names, None for all) and write
    ``nn-segs``/``nn-heats`` into the open h5py file ``h5_f``. ``models``
    are members from ``load_net_from_checkpoint``; ``quantized`` and
    ``int8_float_levels`` as ``fullres_batches``. Returns the (specimen,
    projection-key) entries in output order."""
    entries = list_fullres_frames(src, specimens)
    if not entries:
        raise ValueError("no projections selected")
    first = src[entries[0][0]]["projections"][entries[0][1]]
    full_hw = tuple(first["image/pixels"].shape)

    def read_batch(i0, i1):
        projs = np.empty((i1 - i0, *full_hw), np.float32)
        rots = np.empty((i1 - i0,), bool)
        for j, (spec, pk) in enumerate(entries[i0:i1]):
            pg = src[spec]["projections"][pk]
            projs[j] = pg["image/pixels"][:]
            rots[j] = bool(np.asarray(pg["rot-180-for-up"][()]))
        return projs, rots

    batches = fullres_batches(read_batch, len(entries), full_hw, models, ds_factor, num_lands, times, batch_size,
                              pad_img_dim, quantized, int8_float_levels)
    write_ensemble_outputs(h5_f, batches, len(entries), fullres_crop_size(ds_factor, full_hw), num_lands)
    return entries
