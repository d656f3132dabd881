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
over 'data' and their rows over 'spatial'. The batches run through
``infer/batches.py::run_batches``.
"""

from __future__ import annotations

import numpy as np
import torch

import torch.distributed as dist

from deepfluoro_tpu_torch.data.preprocess import fullres_crop_size, fullres_shard, make_fullres_prep
from deepfluoro_tpu_torch.infer.batches import may_capture, measured_algorithms, run_batches
from deepfluoro_tpu_torch.infer.ensemble import ensemble_forward, write_ensemble_outputs
from deepfluoro_tpu_torch.models.unet import UNet
from deepfluoro_tpu_torch.parallel.multihost import is_writer
from deepfluoro_tpu_torch.parallel.sharding import gather_bands


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
    (i1 - i0,) bool)`` numpy arrays gives the frames; ``times``, the
    padding of a final partial batch, the readback and the cuDNN flags are
    ``infer/batches.py::run_batches``' (the timed work here: the copy to
    the device, prep, K forwards, mean and argmax). Raises ValueError at
    once when the nets' ``pad_img_dim`` is below the frame size at
    ``ds_factor`` (nets of another rung).

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
            raise ValueError("full-res inference on a mesh shards U-Net members only; {} runs on one device".format(
                next(type(m).__name__ for m in models if not isinstance(m, UNet))))
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
        return run_batches(read_batch, n, tuple(full_hw), run, dev, times, batch_size, is_writer())

    def run(projs, rots):
        _, heats, labels = ensemble_forward(fwds, prep(projs, rots), orig_hw, num_lands)
        return labels, heats

    return run_batches(read_batch, n, tuple(full_hw), run, dev, times, batch_size,
                       graphable=may_capture(models, quantized=quantized))


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
