"""Full-resolution -> preprocessed frames (JAX counterpart:
``deepfluoro_tpu/data/preprocess.py``).

The reference describes this preprocessing without implementing it
(README.md:84-95): crop 50 px from each border, Beer-Lambert log
(bone-dark to bone-bright), rotate 180 degrees when the archive's
``rot-180-for-up`` says so, and downsample by 2, 4, 8 or 16. Label maps
take the same grid by nearest sampling.

Both resizes repeat ``jax.image.resize``:
- ``"linear"`` antialiases when it shrinks: a triangle filter widened by
  the factor, each output a normalized weighted sum of its input band
  (``resize_linear``). ``F.interpolate(mode="bilinear", align_corners=
  False)`` differs by up to half the intensity range, with ``antialias=
  True`` by float32 rounding of its weights: 6.5e-6 from the float64
  result at 1436 -> 179 on the CPU (as JAX's float32 weights), 2.4e-5
  once z-normed, and other roundings on the card. The port's weights come
  from float64 on the host, so card and CPU apply the same numbers;
- ``"nearest"`` takes source index ``floor((i + 0.5) * m / n)`` as XLA
  computes it (``_nearest_indices``); torch's ``"nearest"`` rounds
  otherwise, and ``"nearest-exact"`` too at 1336 -> 83 (16x), where the
  factor does not divide the size.

Everything runs on the tensors' device; ``make_fused_fullres_infer`` folds
the chain into one eager function in front of a U-Net, and
``make_quantized_fullres_infer`` in front of its int8 forward. Full-res archive
schema: hdf5_layouts/Readme.md:16-93.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from deepfluoro_tpu_torch.ops.image import calc_pad_amount, center_crop, reflect_pad_to, znorm
from deepfluoro_tpu_torch.utils.platform import get_device

BORDER_CROP_PX = 50  # README.md:84

# the paper's specimen numbering of the full-res groups (README.md:74-80)
PAPER_SPEC_IDS = {
    "17-1882": 1, "18-1109": 2, "18-0725": 3,
    "18-2799": 4, "18-2800": 5, "17-1905": 6,
}


def beer_lambert_log(proj: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    """mu*l = log(I0) - log(I) with I0 the image's maximum intensity, over
    the trailing two dims (one I0 per image)."""
    i0 = proj.amax(dim=(-2, -1), keepdim=True)
    return torch.log(i0 + eps) - torch.log(torch.clamp(proj, min=eps))


def _nearest_indices(m: int, n: int, device) -> torch.Tensor:
    """The source rows (or columns) of ``jax.image.resize``'s nearest
    method from size ``m`` to ``n``. It writes floor((i + 0.5) * m / n) in
    float32, and XLA folds ``* m / n`` into one multiply by the float32
    constant m * (1/n), which moves some indices at exact ties (1336 -> 83:
    row 41 reads 667, not 668); this repeats the folded rule."""
    scale = torch.tensor(float(m), dtype=torch.float32) * (torch.tensor(1.0, dtype=torch.float32) / n)
    return torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * scale).long().to(device)


@functools.lru_cache(maxsize=16)
def linear_taps(m: int, n: int):
    """The weights of ``jax.image.resize``'s linear method from size ``m``
    to ``n`` along one axis (``compute_weight_mat`` of jax/_src/image/
    scale.py, in float64): sample i sits at (i + 0.5) m / n - 0.5, the
    triangle is widened by m / n when shrinking, and each output's weights
    are normalized to sum to 1. Returns ``(start (n,) int64, weights (n,
    T) float32)``: output i is the sum over k of weights[i, k] times input
    start[i] + k. Cached per (m, n): callers must not write to them."""
    inv_scale = m / n
    sample = (np.arange(n) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(m)[:, None]) / max(inv_scale, 1.0)
    w = np.maximum(0.0, 1.0 - dist)  # (m, n)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= m - 0.5))[None, :], w, 0.0)
    nz = w != 0
    lo = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    hi = np.where(nz.any(axis=0), m - 1 - nz[::-1].argmax(axis=0), 0)
    taps = int((hi - lo).max()) + 1
    start = np.minimum(lo, m - taps)
    rows = start[:, None] + np.arange(taps)[None, :]
    return start.astype(np.int64), w[rows, np.arange(n)[:, None]].astype(np.float32)


def _apply_taps(x: torch.Tensor, start: np.ndarray, weights: np.ndarray) -> torch.Tensor:
    """Resize the last axis of ``x`` by ``linear_taps``' band."""
    idx = torch.from_numpy(start[:, None] + np.arange(weights.shape[1])[None, :]).to(x.device)
    return (x[..., idx] * torch.from_numpy(weights).to(x.device)).sum(dim=-1)


def resize_linear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """``jax.image.resize(img, out_hw, "linear")`` over the trailing two
    dims of float32 frames, rows then columns."""
    h, w = img.shape[-2:]
    if (h, w) == tuple(out_hw):
        return img
    x = _apply_taps(img.transpose(-2, -1), *linear_taps(h, out_hw[0])).transpose(-2, -1)
    return _apply_taps(x, *linear_taps(w, out_hw[1]))


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """``jax.image.resize(img, out_hw, "nearest")`` over the trailing two
    dims."""
    h, w = img.shape[-2:]
    rows = _nearest_indices(h, out_hw[0], img.device)
    cols = _nearest_indices(w, out_hw[1], img.device)
    return img[..., rows, :][..., cols]


def _crop_borders(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    return img[..., BORDER_CROP_PX : h - BORDER_CROP_PX, BORDER_CROP_PX : w - BORDER_CROP_PX]


def preprocess_projection(img: torch.Tensor, ds_factor: int, rot_180: bool = False, is_seg: bool = False) -> torch.Tensor:
    """Crop borders -> (log) -> (rot180) -> downsample one ``(H, W)``
    frame: linear for intensities, nearest for label maps (returned as
    float32, as the JAX function returns them)."""
    img = _crop_borders(img.to(torch.float32))
    if not is_seg:
        img = beer_lambert_log(img)
    if rot_180:
        img = img.flip(-2, -1)
    hc, wc = img.shape[-2:]
    out_hw = (hc // ds_factor, wc // ds_factor)
    return resize_nearest(img, out_hw) if is_seg else resize_linear(img, out_hw)


def preprocess_landmarks(lands_xy: np.ndarray, full_hw, ds_factor: int, rot_180: bool = False) -> np.ndarray:
    """Map (2, L) full-res landmark coords through the same geometry: the
    50 px crop offset, the optional 180-degree rotation, and the resize's
    own scale (out_dim / cropped_dim, which differs from 1/ds_factor when
    the factor does not divide the cropped size). Out-of-crop landmarks
    are not marked here; the archive loader marks them."""
    h, w = full_hw
    hc, wc = h - 2 * BORDER_CROP_PX, w - 2 * BORDER_CROP_PX
    out = np.asarray(lands_xy, np.float64).copy()
    out[0] -= BORDER_CROP_PX
    out[1] -= BORDER_CROP_PX
    if rot_180:
        out[0] = (wc - 1) - out[0]
        out[1] = (hc - 1) - out[1]
    scale_x = (wc // ds_factor) / wc
    scale_y = (hc // ds_factor) / hc
    out[0] = (out[0] + 0.5) * scale_x - 0.5
    out[1] = (out[1] + 0.5) * scale_y - 0.5
    return out.astype(np.float32)


def full_res_to_preprocessed(
    src_path: str,
    dst_path: str,
    ds_factor: int,
    spec_id_map: dict[str, int] | None = None,
    land_names: list[str] | None = None,
    device=None,
) -> str:
    """Convert a full-resolution archive into the preprocessed schema
    (hdf5_layouts/Readme.md:95-117) at ``ds_factor``, frame by frame on
    ``device`` (default CUDA).

    ``spec_id_map``: {full-res specimen group -> output index}; defaults to
    the paper's numbering when every group is one of its specimens, else
    to sorted order. Ground truth is all or none per specimen: a specimen
    with labels on only some projections raises ValueError, since the
    stacked ``segs``/``lands`` would pair frames with other frames' labels.
    Invisible landmarks are written at (-1, -1), finite, as the loader
    expects."""
    import h5py

    dev = get_device(device)

    def prep(a, rot, is_seg):
        return preprocess_projection(torch.from_numpy(np.asarray(a, np.float32)).to(dev), ds_factor, rot, is_seg).cpu().numpy()

    with h5py.File(src_path, "r") as src, h5py.File(dst_path, "w") as dst:
        spec_names = [k for k in src.keys() if k != "proj-params"]
        if spec_id_map is None:
            if all(n in PAPER_SPEC_IDS for n in spec_names):
                spec_id_map = {n: PAPER_SPEC_IDS[n] for n in spec_names}
            else:
                spec_id_map = {n: i + 1 for i, n in enumerate(sorted(spec_names))}

        all_land_names = land_names
        for spec_name in spec_names:
            projs_g = src[spec_name]["projections"]
            projs_out, segs_out, lands_out = [], [], []
            for pk in sorted(projs_g.keys()):
                pg = projs_g[pk]
                img = pg["image/pixels"][:]
                rot = bool(np.asarray(pg["rot-180-for-up"][()]))
                projs_out.append(prep(img, rot, False))
                if "gt-seg" in pg:
                    segs_out.append(prep(pg["gt-seg/pixels"][:], rot, True).astype(np.uint8))
                if "gt-landmarks" in pg:
                    lg = pg["gt-landmarks"]
                    if all_land_names is None:
                        all_land_names = sorted(lg.keys())
                    pts = np.full((2, len(all_land_names)), -1.0, np.float32)
                    for li, name in enumerate(all_land_names):
                        if name in lg:
                            xy = np.asarray(lg[name][:], np.float64).reshape(-1)[:2]
                            pts[:, li] = preprocess_landmarks(xy.reshape(2, 1), img.shape, ds_factor, rot)[:, 0]
                    lands_out.append(pts)

            for what, got in (("gt-seg", segs_out), ("gt-landmarks", lands_out)):
                if got and len(got) != len(projs_out):
                    raise ValueError(
                        "specimen {}: {} of {} projections have {}; the stacked datasets would misalign "
                        "with 'projs'".format(spec_name, len(got), len(projs_out), what)
                    )
            og = dst.create_group("{:02d}".format(spec_id_map[spec_name]))
            og.create_dataset("projs", data=np.stack(projs_out))
            if segs_out:
                og.create_dataset("segs", data=np.stack(segs_out))
            if lands_out:
                og.create_dataset("lands", data=np.stack(lands_out))

        if all_land_names:
            lg = dst.create_group("land-names")
            lg["num-lands"] = len(all_land_names)
            for li, name in enumerate(all_land_names):
                lg["land-{:02d}".format(li)] = name
    return dst_path


def fullres_crop_size(ds_factor: int, full_hw) -> tuple[int, int]:
    """The frame size after the border crop and the downsample; raises
    ValueError unless it is square."""
    hc = (full_hw[0] - 2 * BORDER_CROP_PX) // ds_factor
    wc = (full_hw[1] - 2 * BORDER_CROP_PX) // ds_factor
    if hc != wc:
        raise ValueError("square frames expected, got {} -> {}x{}".format(tuple(full_hw), hc, wc))
    return hc, wc


def make_fullres_prep(ds_factor: int, pad_dim: int, full_hw):
    """The prep half of fused full-res inference: crop 50 px borders ->
    Beer-Lambert log -> rot-180 where flagged -> downsample (linear) ->
    reflect-pad to ``pad_dim`` -> z-norm per image (ddof 1, the training
    contract).

    Returns ``(prep, (hc, wc))``: ``prep(projs (B, H_full, W_full) float32,
    rot_flags (B,) bool) -> (B, 1, P, P)`` on the frames' device, and the
    pre-pad size the network outputs are cropped back to."""
    full_hw = tuple(int(v) for v in full_hw)
    hc, wc = fullres_crop_size(ds_factor, full_hw)

    def prep(projs: torch.Tensor, rot_flags: torch.Tensor) -> torch.Tensor:
        if tuple(projs.shape[-2:]) != full_hw:
            raise ValueError("frames of {} given to the prep for {}".format(tuple(projs.shape[-2:]), full_hw))
        x = beer_lambert_log(_crop_borders(projs.to(torch.float32)))
        rot = rot_flags.to(device=x.device, dtype=torch.bool)[:, None, None]
        x = torch.where(rot, x.flip(-2, -1), x)
        x = reflect_pad_to(resize_linear(x, (hc, wc)), pad_dim)
        return znorm(x, dim=(-2, -1))[:, None]

    return prep, (hc, wc)


def make_fused_fullres_infer(model, ds_factor: int, pad_dim: int, full_hw, apply_fn=None):
    """Full-res frames -> prep -> ``model`` (eval mode, on the frames'
    device) -> crop to the frame -> argmax.

    Returns ``infer(projs (B, H_full, W_full), rot_flags (B,)) -> (labels
    (B, h, w) uint8, heats (B, L, h, w) float32 or None)``; heats are the
    net's raw maps, as the JAX program returns them. ``apply_fn(x) -> seg
    | (seg, heats)`` replaces the float forward ``model(x)``;
    ``make_quantized_fullres_infer`` passes the int8 forward through it."""
    prep, (hc, wc) = make_fullres_prep(ds_factor, pad_dim, full_hw)
    if apply_fn is None:
        apply_fn = model

    @torch.no_grad()
    def infer(projs: torch.Tensor, rot_flags: torch.Tensor):
        out = apply_fn(prep(projs, rot_flags))
        seg, heats = out if isinstance(out, tuple) else (out, None)
        labels = center_crop(seg, (hc, wc)).argmax(dim=1).to(torch.uint8)
        return labels, None if heats is None else center_crop(heats, (hc, wc))

    return infer


def fullres_shard(model, mesh, ds_factor: int, pad_dim: int, full_hw):
    """This process's band (``parallel/mesh.py::RowShard``) of the padded
    network input at ``ds_factor`` on ``mesh``'s 'spatial' axis, with
    ``model``'s layers set to it (``parallel/sharding.py::shard_rows``).
    Returns (shard, (hc, wc))."""
    from deepfluoro_tpu_torch.parallel.sharding import shard_rows

    hc, wc = fullres_crop_size(ds_factor, tuple(int(v) for v in full_hw))
    rows = hc + 2 * calc_pad_amount(pad_dim, hc) if pad_dim > hc else hc
    return shard_rows(model, mesh, rows), (hc, wc)


def make_sharded_fullres_infer(model, ds_factor: int, pad_dim: int, full_hw, mesh, apply_fn=None):
    """``make_fused_fullres_infer`` over a mesh of 'data' and 'spatial'
    processes (JAX: ``make_sharded_fullres_infer``, where GSPMD partitions
    the program): each process takes its data slice of the frames, runs
    the raw-frame prep on them whole (crop, log, rot-180, resize, pad,
    z-norm: a small share of the work, and the rot-180 and the resize mix
    rows), keeps its band of rows and runs ``model`` (eval mode, its
    layers set to the band: ``fullres_shard``) with row exchanges; the
    argmax is row-local. The labels and the raw heats are gathered, so
    every process returns the whole batch: same contract as
    ``make_fused_fullres_infer``. The batch size must divide by the 'data'
    axis. ``apply_fn(x)`` (an int8 forward of ``model``) replaces
    ``model(x)`` on the band."""
    from deepfluoro_tpu_torch.parallel.sharding import gather_bands

    prep, _ = make_fullres_prep(ds_factor, pad_dim, full_hw)
    shard, crop_hw = fullres_shard(model, mesh, ds_factor, pad_dim, full_hw)
    data = mesh.axis("data")
    if apply_fn is None:
        apply_fn = model

    @torch.no_grad()
    def infer(projs: torch.Tensor, rot_flags: torch.Tensor):
        b = int(projs.shape[0])
        local = data.rows(b)
        out = apply_fn(prep(projs[local], rot_flags[local])[:, :, shard.start : shard.stop])
        seg, heats = out if isinstance(out, tuple) else (out, None)
        labels = shard.crop(seg, crop_hw).argmax(dim=1).to(torch.int32)
        labels = gather_bands(labels, shard, local, b, crop_hw).to(torch.uint8)
        return labels, None if heats is None else gather_bands(shard.crop(heats, crop_hw), shard, local, b, crop_hw)

    return infer


def make_quantized_fullres_infer(model, ds_factor: int, pad_dim: int, full_hw, calib_projs, calib_rot_flags,
                                 float_levels: int = 0, mesh=None):
    """The int8 variant of ``make_fused_fullres_infer``: activation scales
    calibrated on ``calib_projs`` ((B, H_full, W_full) raw frames, B >= 1,
    on the model's device) and ``calib_rot_flags`` run through the same
    prep, weights quantized per output channel (the JAX docstring says per
    tensor; its code, like this, quantizes per channel), and the U-Net's
    convolutions int8 (``infer/quantized.py``), the finest
    ``float_levels`` levels in float. Same return contract. With a
    ``mesh`` (JAX: the sharded int8 program) the scales come from the
    whole calibration frames, which every process passes, before
    ``make_sharded_fullres_infer`` sets the model to its band."""
    from deepfluoro_tpu_torch.infer.quantized import int8_forwards

    if calib_projs.ndim != 3 or calib_projs.shape[0] < 1:
        raise ValueError("int8 calibration needs at least one (B, H, W) raw frame; got shape {}".format(
            tuple(calib_projs.shape)))
    prep, _ = make_fullres_prep(ds_factor, pad_dim, full_hw)
    model.set_bands(None)
    (apply_fn,) = int8_forwards([model], [prep(calib_projs, calib_rot_flags)], float_levels)
    if mesh is not None:
        return make_sharded_fullres_infer(model, ds_factor, pad_dim, full_hw, mesh, apply_fn=apply_fn)
    return make_fused_fullres_infer(model, ds_factor, pad_dim, full_hw, apply_fn=apply_fn)
