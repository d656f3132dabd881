"""Ensemble inference (JAX counterpart: ``deepfluoro_tpu/infer/ensemble.py``,
itself after reference util.py:167-377 and test_ensemble.py).

Each member is rebuilt from its checkpoint alone. For every batch of
frames: reflect-pad and z-norm (the no-augmentation ``prepare_batch``), K
plain forwards, each member's output center-cropped to the frame and its
heatmaps min-max normalized per image over all landmarks, the mean over
the members, and the argmax of the mean as uint8 labels. The results go to
``nn-segs`` (u1) and ``nn-heats`` in an HDF5 file, gzip 9, one chunk per
image (per image and landmark for the heats).

The JAX package unrolls the K forwards into one program instead of
vmapping over stacked weights (grouped convolutions tile badly,
``map_over_nets``); here they are K eager forwards through cuDNN. The
device work is a generator of host batches (``ensemble_batches``), so it
runs where h5py is not installed; ``write_ensemble_outputs`` consumes it
into the file.

``quantized`` runs the members' int8 forwards instead
(``infer/quantized.py``), with activation scales calibrated on the first
``calib_batches`` prepared batches of the same unshuffled iterator, and
the finest ``int8_float_levels`` U-Net levels left in float.

With a mesh (``parallel/mesh.py``) of an 'ensemble' axis of E processes
and a 'data' axis of D, one process per card, each process runs its K/E
members on its 1/D slice of every batch (an uneven tail padded), the
member sums of the seg and heats are summed over all processes and
divided by the total K, and process 0 writes the file (JAX:
``parallel/sharding.py::make_sharded_ensemble_forward``, its int8 twin).

Members load from the port's and the reference's ``.pt`` files and from
the JAX package's msgpack checkpoints (``train/checkpoint.py::
load_checkpoint``), with no JAX installed.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from deepfluoro_tpu_torch.data.augment import AugmentConfig, prepare_batch
from deepfluoro_tpu_torch.data.hdf5 import FluoroData
from deepfluoro_tpu_torch.data.pipeline import BatchIterator
from deepfluoro_tpu_torch.ops.image import center_crop
from deepfluoro_tpu_torch.ops.losses import per_sample_dice, per_sample_joint
from deepfluoro_tpu_torch.parallel.multihost import is_writer, process_count
from deepfluoro_tpu_torch.parallel.sharding import sum_over
from deepfluoro_tpu_torch.train.checkpoint import is_torch_checkpoint, load_checkpoint
from deepfluoro_tpu_torch.train.config import TrainConfig, build_model
from deepfluoro_tpu_torch.utils.platform import get_device


def _count_keys(state_dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in state_dict:
        n += 1
    return n


def load_net_from_checkpoint(path: str, device=None, verbose: bool = True):
    """Rebuild ``(model, cfg)`` from a checkpoint file alone (contract of
    reference test_ensemble.py:61-107): the port's own checkpoints and the
    reference's ``train.py`` files share the ``.pt`` layout, as do those
    the JAX package's ``compat/torch_import.py::export_torch_checkpoint``
    writes; the JAX package's own msgpack checkpoints are converted to it
    on load (``compat/from_jax.py::torch_checkpoint_from_jax``). The model is in eval mode on ``device`` (default CUDA), at
    the checkpoint's compute dtype and remat setting, as the JAX loader's
    ``build_model(cfg)`` builds it.

    Checkpoints do not store the landmark head's shape; it is read from
    the state-dict keys (``lands_block.*``, ``lands_1x1.*``), as the JAX
    package's importer does. A ``.pt`` file is a pickle that may hold
    other objects than tensors (numpy scalars in a scheduler state), so it
    is loaded in full, as the reference and the JAX package load it: load
    only files you trust."""
    dev = get_device(device)
    jax_file = not is_torch_checkpoint(path)
    ck = load_checkpoint(path, weights_only=False)
    meta = {k: v for k, v in ck.items() if not k.endswith("state-dict") and k != "loss"}
    cfg = TrainConfig.from_checkpoint_meta(meta)
    sd = ck["model-state-dict"]
    if verbose:
        print("  loading unet params from {} checkpoint...".format("JAX (msgpack)" if jax_file else "torch (reference)"))
        print("             num. classes: {}".format(cfg.num_classes))
        print("                    depth: {}".format(cfg.depth))
        print("        init. feats. exp.: {}".format(cfg.init_feats_exp))
        print("              batch norm.: {}".format(cfg.batch_norm))
        print("    reflect pad img. dim.: {}".format(cfg.proj_unet_dim))
        print("              num. lands.: {}".format(cfg.num_lands))
    head = {}
    if cfg.num_lands > 0:
        head = dict(
            lands_block_depth=_count_keys(sd, "lands_block.{}.weight"),
            lands_num_1x1=_count_keys(sd, "lands_1x1.{}.weight"),
        )
    model = build_model(cfg, **head)
    model.load_state_dict(sd)
    return model.to(dev).eval(), cfg


def _crop_output(out, orig_hw, num_lands: int):
    """One member's forward output, center-cropped to the frame: (seg,
    heats or None), NCHW."""
    seg, heats = out if num_lands > 0 else (out, None)
    return center_crop(seg, orig_hw), None if heats is None else center_crop(heats, orig_hw)


def postprocess_net_output(out, orig_hw, num_lands: int):
    """Crop one member's forward output to the frame and min-max normalize
    its heatmaps per image over all landmarks at once (reference
    util.py:345-356: ``.min()``/``.max()`` of the image's (1, L, H, W))."""
    seg, heats = _crop_output(out, orig_hw, num_lands)
    if heats is not None:
        hmin = heats.amin(dim=(1, 2, 3), keepdim=True)
        hmax = heats.amax(dim=(1, 2, 3), keepdim=True)
        heats = (heats - hmin) / (hmax - hmin)
    return seg, heats


def _member_sum(models, proj: torch.Tensor, orig_hw, num_lands: int, post):
    """The sum over members of ``post(model(proj), orig_hw, num_lands)``:
    (seg, heats or None), one forward per member; a member is a module or
    any callable of ``proj`` (``infer/quantized.py::member_forwards``)."""
    seg_sum = heat_sum = None
    for model in models:
        seg, heats = post(model(proj), orig_hw, num_lands)
        seg_sum = seg if seg_sum is None else seg_sum + seg
        if heats is not None:
            heat_sum = heats if heat_sum is None else heat_sum + heats
    return seg_sum, heat_sum


def _member_mean(models, proj: torch.Tensor, orig_hw, num_lands: int, post):
    seg_sum, heat_sum = _member_sum(models, proj, orig_hw, num_lands, post)
    k = len(models)
    return seg_sum / k, None if heat_sum is None else heat_sum / k


@torch.no_grad()
def ensemble_forward(models, proj: torch.Tensor, orig_hw, num_lands: int, mesh=None):
    """(prepared ``proj`` (B, 1, Hp, Wp)) -> (mean softmax seg (B, C, H, W),
    mean normalized heats (B, L, H, W) or None, argmax labels (B, H, W)
    uint8). K forwards, one per member; the members must be in eval mode
    (``load_net_from_checkpoint`` returns them so) or be callables, as the
    int8 members of ``infer/quantized.py``.

    With ``mesh`` the ensemble is spread over its processes: ``models``
    are this process's members, the same number on each, and ``proj`` the
    whole batch, whose rows divide by the 'data' axis. Each process runs
    its members on its slice of the rows; the sums, each process's in its
    own rows of a zero buffer, are summed over all processes, so every
    process gets the whole batch's result. The mean divides by the total
    member count, not by the number of processes. One process runs its
    members on the whole batch and reduces nothing."""
    k = len(models) if mesh is None else len(models) * mesh.axis("ensemble").size
    b = int(proj.shape[0])
    rows = slice(0, b) if mesh is None else mesh.axis("data").rows(b)
    shared = mesh is not None and process_count() > 1
    sums = []
    for part in _member_sum(models, proj[rows], orig_hw, num_lands, postprocess_net_output):
        if part is not None and shared:
            full = part.new_zeros((b,) + tuple(part.shape[1:]))
            full[rows] = part
            dist.all_reduce(full)
            part = full
        sums.append(None if part is None else part / k)
    avg_seg, avg_heats = sums
    return avg_seg, avg_heats, avg_seg.argmax(dim=1).to(torch.uint8)


def _device_of(models) -> torch.device:
    return next(models[0].parameters()).device


def _calibration_inputs(it, prep, calib_batches: int):
    """The first ``calib_batches`` prepared batches of ``it``'s unshuffled
    epoch (JAX: the same iterator as the inference pass)."""
    if calib_batches < 1:
        raise ValueError("--int8 needs at least one calibration batch (got --int8-calib-batches {})".format(calib_batches))
    calib = []
    for projs, _, _ in it.epoch():
        calib.append(prep(projs))
        if len(calib) >= calib_batches:
            break
    if not calib:
        raise ValueError("cannot calibrate int8 activation scales on an empty dataset")
    return calib


def _member_forwards(models, it, prep, quantized: bool, calib_batches: int, int8_float_levels: int):
    """The members' forwards: the models themselves, or with ``quantized``
    their int8 forwards, calibrated here on ``it``'s first batches."""
    if not quantized:
        return models
    from deepfluoro_tpu_torch.infer.quantized import int8_forwards

    return int8_forwards(models, _calibration_inputs(it, prep, calib_batches), int8_float_levels)


def ensemble_batches(
    data: FluoroData,
    models,
    num_lands: int = 0,
    times: list | None = None,
    batch_size: int = 1,
    pad_img_dim: int = 0,
    num_classes: int = 7,
    quantized: bool = False,
    calib_batches: int = 4,
    int8_float_levels: int = 0,
    mesh=None,
):
    """Yield ``(start, labels (b, H, W) uint8, heats (b, L, H, W) float32 or
    None)`` numpy batches over ``data`` in order, the final partial batch
    included, on the members' device.

    With ``times`` each image gets its batch's wall-clock divided by the
    batch size: pad, z-norm, the K forwards and the mean, up to a
    synchronise inside the timed region; the readback falls outside. Every
    batch shape, the final partial one too, runs once before timing, so
    no first-call cost lands in it. With ``quantized`` the forwards are
    int8, calibrated before the warm-up on the first ``calib_batches``
    batches (ValueError for fewer than 1, or for an empty dataset).

    With ``mesh`` every process calls this in lockstep with its own
    members, the same number on each (``ensemble_forward``); the batch
    size must divide by the 'data' axis, and a final partial batch is
    padded to a multiple of it with copies of its last frame. Each
    process calibrates its own int8 members on the whole leading batches.
    Process 0 yields the arrays; the others yield (start, None, None)."""
    dev = _device_of(models)
    orig_hw = data.orig_img_shape
    n = len(data)
    writer, d = True, 1
    if mesh is not None:
        writer, d = is_writer(), mesh.axis("data").size
        if sum_over([len(models)])[0] != len(models) * process_count():
            raise ValueError("every process must hold the same number of ensemble members")
        if batch_size % d:
            raise ValueError("batch size {} does not shard evenly over the {}-way 'data' mesh axis".format(
                batch_size, d))
    aug_cfg = AugmentConfig(num_classes=num_classes, proj_pad_dim=pad_img_dim, prob_of_aug=0.0, include_heat_map=False)

    def prep(projs):
        return prepare_batch(aug_cfg, None, projs)["proj"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for model in models:
        model.eval()
    it = BatchIterator(data, batch_size=batch_size, device=dev)
    fwds = _member_forwards(models, it, prep, quantized, calib_batches, int8_float_levels)

    def run(projs):
        b = int(projs.shape[0])
        pad = (-b) % d
        if pad:
            projs = torch.cat([projs, projs[-1:].expand(pad, *projs.shape[1:])])
        out = ensemble_forward(fwds, prep(projs), orig_hw, num_lands, mesh)
        return tuple(None if t is None else t[:b] for t in out)

    for warm_b in {min(batch_size, n), n % batch_size} - {0}:
        run(it.projs[:warm_b])
    sync()

    start = 0
    for projs, _, _ in it.epoch():
        b = int(projs.shape[0])
        t0 = time.perf_counter()
        _, avg_heats, labels = run(projs)
        sync()
        elapsed = time.perf_counter() - t0
        if times is not None:
            times.extend([elapsed / b] * b)
        if writer:
            yield start, labels.cpu().numpy(), None if avg_heats is None else avg_heats.cpu().numpy()
        else:
            yield start, None, None
        start += b


def write_ensemble_outputs(h5_f, batches, n: int, orig_hw, num_lands: int) -> None:
    """Write ``ensemble_batches``' output into an open h5py file:
    ``nn-segs`` (n, H, W) u1 with chunks (1, H, W) and, with landmarks,
    ``nn-heats`` (n, L, H, W) with chunks (1, 1, H, W), both gzip 9
    (reference util.py:293-377)."""
    segs_ds = h5_f.create_dataset(
        "nn-segs", (n, *orig_hw), dtype="u1", chunks=(1, *orig_hw), compression="gzip", compression_opts=9
    )
    heats_ds = None
    if num_lands > 0:
        heats_ds = h5_f.create_dataset(
            "nn-heats", (n, num_lands, *orig_hw), chunks=(1, 1, *orig_hw), compression="gzip", compression_opts=9
        )
    written = 0
    for start, labels, heats in batches:
        segs_ds[start : start + labels.shape[0]] = labels
        if heats_ds is not None:
            heats_ds[start : start + heats.shape[0]] = heats
        written = start + labels.shape[0]
    if written != n:
        raise RuntimeError("wrote {} of {} images".format(written, n))


def seg_dataset_ensemble(
    data: FluoroData,
    models,
    h5_f,
    num_lands: int = 0,
    times: list | None = None,
    batch_size: int = 1,
    pad_img_dim: int = 0,
    num_classes: int = 7,
    quantized: bool = False,
    calib_batches: int = 4,
    int8_float_levels: int = 0,
    mesh=None,
) -> None:
    """Run the ensemble over ``data`` and write ``nn-segs``/``nn-heats``
    into the open h5py file ``h5_f`` (reference util.py:293-377).
    ``models``: the members from ``load_net_from_checkpoint``, all of one
    architecture and on one device; ``quantized``, ``mesh`` and the rest
    as ``ensemble_batches``. Under a mesh, process 0 writes the file and
    every other process passes ``h5_f=None``."""
    batches = ensemble_batches(data, models, num_lands, times, batch_size, pad_img_dim, num_classes, quantized,
                               calib_batches, int8_float_levels, mesh)
    if (h5_f is None) == (mesh is None or is_writer()):
        raise ValueError("process 0 writes the output file: it passes h5_f, every other process None")
    if h5_f is None:
        for _ in batches:
            pass
        return
    write_ensemble_outputs(h5_f, batches, len(data), data.orig_img_shape, num_lands)


def seg_dataset(
    data: FluoroData,
    model,
    h5_f,
    num_lands: int = 0,
    batch_size: int = 1,
    pad_img_dim: int = 0,
    num_classes: int = 7,
    quantized: bool = False,
    calib_batches: int = 4,
    int8_float_levels: int = 0,
) -> None:
    """One network as an ensemble of one (reference util.py:243-291). The
    reference's single-net path does not min-max normalize the heatmaps;
    like the JAX package this one does (monotonic per image, so landmark
    decoding is unchanged)."""
    seg_dataset_ensemble(
        data, [model], h5_f, num_lands=num_lands, batch_size=batch_size, pad_img_dim=pad_img_dim,
        num_classes=num_classes, quantized=quantized, calib_batches=calib_batches,
        int8_float_levels=int8_float_levels,
    )


@torch.no_grad()
def test_dataset_ensemble(
    data: FluoroData,
    models,
    num_lands: int = 0,
    dice_only: bool = False,
    batch_size: int = 1,
    pad_img_dim: int = 0,
    num_classes: int = 7,
    heat_coeff: float = 0.5,
    quantized: bool = False,
    calib_batches: int = 4,
    int8_float_levels: int = 0,
):
    """Ensemble validation loss (reference util.py:167-241): the mean over
    members of each image's seg and heatmaps, then the per-image joint loss
    (or the dice term alone) -> (mean, std with N-1) over the images.
    As in the reference, this path does not min-max normalize the members'
    heatmaps (util.py:216-222). ``quantized`` and the rest as
    ``ensemble_batches`` (the JAX package has no int8 loss evaluation)."""
    dev = _device_of(models)
    orig_hw = data.orig_img_shape
    use_lands = num_lands > 0 and not dice_only
    aug_cfg = AugmentConfig(num_classes=num_classes, proj_pad_dim=pad_img_dim, prob_of_aug=0.0, include_heat_map=use_lands)
    for model in models:
        model.eval()
    it = BatchIterator(data, batch_size=batch_size, device=dev)
    fwds = _member_forwards(models, it, lambda projs: prepare_batch(aug_cfg, None, projs)["proj"],
                            quantized, calib_batches, int8_float_levels)
    losses = []
    for projs, segs, lands in it.epoch():
        prepared = prepare_batch(aug_cfg, None, projs, segs, lands)
        avg_seg, avg_heats = _member_mean(fwds, prepared["proj"], orig_hw, num_lands, _crop_output)
        if use_lands:
            losses.append(per_sample_joint(avg_seg, avg_heats, prepared["seg"], prepared["heats"], heat_coeff))
        else:
            losses.append(per_sample_dice(avg_seg, prepared["seg"], skip_bg=False))
    losses = torch.cat(losses).cpu().numpy()
    std = float(losses.std(ddof=1)) if losses.size > 1 else 0.0
    return float(losses.mean()), std
