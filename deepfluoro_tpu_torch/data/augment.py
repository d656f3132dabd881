"""Batch preparation and augmentation on the device (JAX counterpart:
``deepfluoro_tpu/data/augment.py``).

The reference runs its chain per sample on the host (dataset.py:91-328):
invert -> noise -> gamma -> affine -> random erase -> reflect pad -> z-norm
-> Gaussian heatmaps. Here it runs batched on the device, in two parts:

  ``draw_augmentation``  every random number of a batch, from an explicit
                         ``torch.Generator``;
  ``apply_augmentation`` the deterministic chain fed those draws.

Torch cannot reproduce JAX's threefry streams, so the split lets the tests
feed ``apply_augmentation`` the draws JAX itself makes, and hold the torch
draws to their ranges by their distributions.

Stage semantics (reference dataset.py):
  aug gate  P(augment sample) = 0.5                               (:63,107)
  invert    p = max(p) - p, P = 0.5                               (:110-118)
  noise     sigma ~ U(0.005, 0.01) on [0,1]-scaled data           (:120-133)
  gamma     gamma ~ U(0.7, 1.3) on [0,1]-scaled data              (:135-148)
  affine    rot U(-5,5) deg, translate U(0,20) px in a uniformly random
            direction, shear U(-1,1) deg on both axes, scale U(0.9,1.1);
            warped straight into the padded frame with mirror boundaries
            (bilinear projection, nearest labels); landmarks by the forward
            matrix, out of bounds -> inf                          (:150-251)
  erase     P = 0.25; 1-5 boxes, dims ~ round(N(mu, mu)), mu = 15% of each
            dim, clipped into range; noise sigma = 0.2*(roi max-min) (:253-283)
  pad       reflect pad to proj_pad_dim                           (:287-290)
  z-norm    zero mean / unit std (N-1) per sample                 (:292-293)
  heatmaps  sigma 2.5 Gaussians at label resolution, inf -> zeros (:296-326)
The divergences the JAX package documents (corrected landmark bounds
check, exact warp center for landmarks, clipped erase dims) hold here too.

The warp goes through ``ops/warp.py::affine_warp_pair``: the CUDA kernel
for CUDA tensors, the plain version for CPU tensors. With ``prob_of_aug >
0`` every sample is warped and the gate selects afterwards, so a batch
costs one kernel launch, which warps the projection and the labels.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from deepfluoro_tpu_torch.ops import warp
from deepfluoro_tpu_torch.ops.heatmap import synthesize_heatmaps
from deepfluoro_tpu_torch.ops.image import calc_pad_amount, inverse_affine_matrix, transform_landmarks, znorm


ERASE_PROB = 0.25
MAX_ERASE_BOXES = 5
HEAT_SIGMA = 2.5


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The settings the training loop varies; every stage of the chain is
    on (the JAX package's per-stage switches have no caller here)."""

    num_classes: int = 7
    proj_pad_dim: int = 0  # 0 disables padding
    prob_of_aug: float = 0.5  # 0 disables the whole augmentation chain
    include_heat_map: bool = True


def _extra_pad(cfg: AugmentConfig, img_dim: int) -> int:
    return calc_pad_amount(cfg.proj_pad_dim, img_dim) if cfg.proj_pad_dim > img_dim else 0


def _reflect_pad(p: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(p, (pad, pad, pad, pad), mode="reflect") if pad > 0 else p


def _rescale01(p: torch.Tensor):
    lo = p.amin(dim=(1, 2), keepdim=True)
    hi = p.amax(dim=(1, 2), keepdim=True)
    return (p - lo) / (hi - lo), lo, hi


@functools.lru_cache(maxsize=None)
def _erase_sizes(hp: int, wp: int, device: torch.device):
    """The erase boxes' mean size and the frame's (rows, cols), float32
    ``(2,)`` tensors on ``device``, made once per frame and device: a copy
    from host memory inside the step could not be captured in a CUDA graph
    (``train/step.py::StepGraph``)."""
    return (torch.tensor([hp * 0.15, wp * 0.15], dtype=torch.float32, device=device),
            torch.tensor([hp, wp], dtype=torch.float32, device=device))


def draw_augmentation(gen: torch.Generator, b: int, h: int, w: int, cfg: AugmentConfig) -> dict:
    """Every random number the augmentation of a ``(b, h, w)`` batch uses,
    drawn on ``gen``'s device. Keys, all with leading batch dim B:
      aug, invert, erase     bool gates
      sigma, gamma, rot, scale          (B,)
      noise                  (B, h, w) standard normal
      trans, shear           (B, 2) pixels / degrees (x, y)
      num_boxes              (B,) int64 in [1, K]
      box_normal, box_uniform (B, K, 2) standard normal / U(0, 1) per box
                             (row, col) for the box dims and start,
                             K = MAX_ERASE_BOXES
      box_noise              (B, K, hp, wp) standard normal, the padded frame
    """
    dev = gen.device
    k = MAX_ERASE_BOXES
    hp = h + 2 * _extra_pad(cfg, h)
    wp = w + 2 * _extra_pad(cfg, w)

    def uniform(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    direction = normal(b, 2)
    return {
        "aug": uniform(b) < cfg.prob_of_aug,
        "invert": uniform(b) < 0.5,
        "sigma": uniform(b, lo=0.005, hi=0.01),
        "noise": normal(b, h, w),
        "gamma": uniform(b, lo=0.7, hi=1.3),
        "rot": uniform(b, lo=-5.0, hi=5.0),
        "trans": direction / torch.linalg.vector_norm(direction, dim=1, keepdim=True) * uniform(b, 1) * 20.0,
        "shear": uniform(b, 2, lo=-1.0, hi=1.0),
        "scale": uniform(b, lo=0.9, hi=1.1),
        "erase": uniform(b) < ERASE_PROB,
        "num_boxes": torch.randint(1, k + 1, (b,), generator=gen, device=dev),
        "box_normal": normal(b, k, 2),
        "box_uniform": uniform(b, k, 2),
        "box_noise": normal(b, k, hp, wp),
    }


def apply_augmentation(draws: dict, p: torch.Tensor, s: torch.Tensor | None, lands: torch.Tensor | None, cfg: AugmentConfig):
    """The augmented branch for every sample of a batch, deterministic given
    ``draws``: p (B, H, W) float32, s (B, H, W) labels or None, lands
    (B, 2, L) or None. Returns (p (B, Hp, Wp) in the padded frame, s as
    float32 or None, lands or None)."""
    b, h, w = p.shape
    extra = _extra_pad(cfg, h)
    p = p.float()
    col = lambda v: v[:, None, None]  # noqa: E731

    p = torch.where(col(draws["invert"]), p.amax(dim=(1, 2), keepdim=True) - p, p)

    p01, lo, hi = _rescale01(p)
    p01 = p01 + draws["noise"] * col(draws["sigma"])
    p = p01 * (hi - lo) + lo

    p01, lo, hi = _rescale01(p)
    p01 = torch.pow(torch.clamp(p01, min=0.0), col(draws["gamma"]))
    p = p01 * (hi - lo) + lo

    p01, lo, hi = _rescale01(p)
    trans = (draws["trans"][:, 0], draws["trans"][:, 1])
    shear = (draws["shear"][:, 0], draws["shear"][:, 1])
    m = inverse_affine_matrix((w * 0.5, h * 0.5), draws["rot"], trans, draws["scale"], shear).to(p.device)
    # warping about the original center straight into the padded frame with
    # mirror boundaries equals the reference's reflect-pad -> warp ->
    # center-crop chain (dataset.py:158-203)
    p_warp, s = warp.affine_warp_pair(
        p01.contiguous(), None if s is None else s.float().contiguous(), m,
        out_shape=(h + 2 * extra, w + 2 * extra), out_offset_xy=(-extra, -extra),
    )
    p = p_warp * (hi - lo) + lo
    if lands is not None:
        # the exact center of the image warp in index space
        ml = inverse_affine_matrix((w / 2.0 - 0.5, h / 2.0 - 0.5), draws["rot"], trans, draws["scale"], shear)
        lands = transform_landmarks(lands, ml.to(p.device), (h, w))

    hp2, wp2 = p.shape[1:]
    box_mean, limit = _erase_sizes(hp2, wp2, p.device)
    rows = torch.arange(hp2, device=p.device)[None, :, None]
    cols = torch.arange(wp2, device=p.device)[None, None, :]
    for k in range(MAX_ERASE_BOXES):
        dims = torch.round(draws["box_normal"][:, k] * box_mean + box_mean)
        dims = torch.minimum(torch.clamp(dims, min=1.0), limit).long()  # (B, 2)
        starts = torch.floor(draws["box_uniform"][:, k] * (limit.long() - dims + 1).float()).long()
        active = draws["erase"] & (k < draws["num_boxes"])
        r0, c0 = col(starts[:, 0]), col(starts[:, 1])
        mask = (rows >= r0) & (rows < r0 + col(dims[:, 0])) & (cols >= c0) & (cols < c0 + col(dims[:, 1]))
        roi_max = torch.where(mask, p, -torch.inf).amax(dim=(1, 2), keepdim=True)
        roi_min = torch.where(mask, p, torch.inf).amin(dim=(1, 2), keepdim=True)
        noise = draws["box_noise"][:, k] * ((roi_max - roi_min) * 0.2)
        p = p + torch.where(mask & col(active), noise, torch.zeros_like(noise))

    return p, s, lands


def prepare_batch(cfg: AugmentConfig, gen: torch.Generator | None, projs: torch.Tensor, segs=None, lands=None,
                  draw_rows: tuple[int, int] | None = None) -> dict:
    """Maybe-augment, pad, z-norm, one-hot and heatmaps for a batch.

    projs (B, H, W); segs (B, H, W) integer labels or None; lands (B, 2, L)
    or None. ``gen`` may be None when ``cfg.prob_of_aug == 0``. Returns
    'proj' (B, 1, Hp, Wp) and, for the inputs given, 'seg' (B, C, H, W)
    one-hot, 'lands' (B, 2, L) and 'heats' (B, L, H, W): the JAX package's
    arrays with channels first.

    ``draw_rows=(start, total)``, by default (0, B): the batch is rows
    [start, start + B) of a larger one of ``total`` rows (a process's
    slice of a data-parallel global batch, or its folds of a lockstep
    step). The draws are made for all ``total`` rows and these rows' are
    kept, so every process takes the generator's stream as one process
    would, and the augmented rows equal one process's. Every later stage
    works per row."""
    b, h, w = projs.shape
    # the pad amounts, warp frames and erase boxes assume square frames
    assert h == w, "only square projections supported (reference dataset.py:85)"
    extra = _extra_pad(cfg, h)
    p = projs.float()

    if cfg.prob_of_aug > 0:
        start, total = draw_rows or (0, b)
        draws = {k: v[start : start + b] for k, v in draw_augmentation(gen, total, h, w, cfg).items()}
        p_aug, s_aug, l_aug = apply_augmentation(draws, p, segs, lands, cfg)
        take = draws["aug"][:, None, None]
        p = torch.where(take, p_aug, _reflect_pad(p, extra))
        if segs is not None:
            segs = torch.where(take, s_aug, segs.float())
        if lands is not None:
            lands = torch.where(take, l_aug, lands)
    else:
        p = _reflect_pad(p, extra)

    p = znorm(p, dim=(1, 2))

    out = {"proj": p[:, None]}
    if segs is not None:
        labels = torch.clamp(torch.round(segs.float()).long(), 0, cfg.num_classes - 1)
        out["seg"] = F.one_hot(labels, cfg.num_classes).permute(0, 3, 1, 2).float()
    if lands is not None:
        out["lands"] = lands
        if cfg.include_heat_map:
            out["heats"] = synthesize_heatmaps(lands, h, w, sigma=HEAT_SIGMA)
    return out
