"""The training step in plain PyTorch: batch preparation with the
augmentation chain, the joint Dice + heatmap-NCC loss, and SGD with
Nesterov momentum and L2 weight decay (reference dataset.py:91-328,
dice.py, ncc.py, train.py:331-440; SURVEY.md §2-§3).

The augmentation is fed its random numbers (``draws``: the program's own
draws for the step, as the benchmark records them) and works out every
output from them and the raw batch, in float32, the precision the recipe
states for its data: per sample, with probability gate ``aug``, invert
(``invert``), Gaussian noise of ``sigma`` on [0, 1]-scaled data, gamma,
then an affine warp (rotation, translation, shear, scale about the frame
center, torchvision's inverse-matrix convention) with mirror boundaries
straight into the reflect-padded frame (bilinear for the projection,
nearest with floor(x + 0.5) for the labels, half-pixel centers), the
landmarks through the forward matrix (out of view -> inf), and up to 5
random-erase boxes of noise; then reflect pad, per-image z-norm (N - 1),
one-hot labels and sigma-2.5 Gaussian heatmaps at label resolution.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fluorobench.reference import unet

MAX_ERASE_BOXES = 5
HEAT_SIGMA = 2.5


def inverse_affine(center_xy, rot_deg, trans_xy, scale, shear_deg):
    """(B, 2, 3) matrices mapping output (x, y) to input (x, y)
    (torchvision ``_get_inverse_affine_matrix``), float32."""
    cx, cy = center_xy
    tx, ty = trans_xy
    rot = torch.deg2rad(rot_deg)
    sx, sy = torch.deg2rad(shear_deg[0]), torch.deg2rad(shear_deg[1])
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)
    m00, m01, m10, m11 = d / scale, -b / scale, -c / scale, a / scale
    m02 = m00 * (-cx - tx) + m01 * (-cy - ty) + cx
    m12 = m10 * (-cx - tx) + m11 * (-cy - ty) + cy
    return torch.stack([torch.stack([m00, m01, m02], -1), torch.stack([m10, m11, m12], -1)], -2)


def _mirror(i, n):
    s = n - 1
    return torch.abs(torch.remainder(i + s, 2 * s) - s)


def warp(img, m, order, out_hw, offset):
    """Mirror-boundary warp of (B, H, W): output pixel (x, y) samples the
    input at m @ [x + offset + 0.5, y + offset + 0.5, 1] - 0.5."""
    b, h, w = img.shape
    oh, ow = out_hw
    dev = img.device
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5 + offset)[None, None, :]
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5 + offset)[None, :, None]
    e = lambda r, c: m[:, r, c][:, None, None]  # noqa: E731
    in_x = e(0, 0) * xs + e(0, 1) * ys + e(0, 2) - 0.5
    in_y = e(1, 0) * xs + e(1, 1) * ys + e(1, 2) - 0.5
    flat = img.reshape(b, h * w)

    def tap(iy, ix):
        return torch.gather(flat, 1, (_mirror(iy, h) * w + _mirror(ix, w)).reshape(b, -1)).reshape(b, oh, ow)

    if order == 0:
        return tap(torch.floor(in_y + 0.5).long(), torch.floor(in_x + 0.5).long())
    fy, fx = torch.floor(in_y), torch.floor(in_x)
    wy1, wx1 = in_y - fy, in_x - fx
    y0, x0 = fy.long(), fx.long()
    return ((1 - wy1) * (1 - wx1) * tap(y0, x0) + (1 - wy1) * wx1 * tap(y0, x0 + 1)
            + wy1 * (1 - wx1) * tap(y0 + 1, x0) + wy1 * wx1 * tap(y0 + 1, x0 + 1))


def _rescale01(p):
    lo = p.amin(dim=(1, 2), keepdim=True)
    hi = p.amax(dim=(1, 2), keepdim=True)
    return (p - lo) / (hi - lo), lo, hi


def move_landmarks(lands, m_inv, hw):
    """(B, 2, L) landmarks through the forward matrix (the inverse of the
    3x3 form of ``m_inv``); out of the frame or not finite -> inf."""
    last = torch.tensor([0.0, 0.0, 1.0], device=lands.device).expand(m_inv.shape[0], 1, 3)
    fwd = torch.linalg.inv(torch.cat([m_inv, last], dim=1))[:, :2]
    x, y = lands[:, 0], lands[:, 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    x, y = torch.where(finite, x, 0.0), torch.where(finite, y, 0.0)
    nx = fwd[:, 0, 0, None] * x + fwd[:, 0, 1, None] * y + fwd[:, 0, 2, None]
    ny = fwd[:, 1, 0, None] * x + fwd[:, 1, 1, None] * y + fwd[:, 1, 2, None]
    h, w = hw
    keep = finite & (nx >= 0) & (nx <= w - 1) & (ny >= 0) & (ny <= h - 1)
    return torch.stack([torch.where(keep, nx, math.inf), torch.where(keep, ny, math.inf)], dim=1)


def heatmaps(lands, h, w):
    """(B, L, H, W) sigma-2.5 Gaussians exp(-d^2 / 2 s^2) / (2 pi s^2) at
    each landmark; zero for landmarks out of view."""
    mx, my = lands[:, 0], lands[:, 1]
    finite = torch.isfinite(mx) & torch.isfinite(my)
    mx = torch.where(finite, mx, 0.0)[..., None, None]
    my = torch.where(finite, my, 0.0)[..., None, None]
    ys = torch.arange(h, dtype=torch.float32, device=lands.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=lands.device)[None, :]
    s2 = HEAT_SIGMA * HEAT_SIGMA
    pdf = torch.exp(((xs - mx) ** 2 + (ys - my) ** 2) / (-2.0 * s2)) / (2.0 * math.pi * s2)
    return torch.where(finite[..., None, None], pdf, 0.0)


def augment(draws, p, s, lands, pad):
    """The augmented branch of every sample: (proj in the padded frame,
    labels as float32, landmarks)."""
    b, h, w = p.shape
    col = lambda v: v[:, None, None]  # noqa: E731
    p = torch.where(col(draws["invert"]), p.amax(dim=(1, 2), keepdim=True) - p, p)
    q, lo, hi = _rescale01(p)
    p = (q + draws["noise"] * col(draws["sigma"])) * (hi - lo) + lo
    q, lo, hi = _rescale01(p)
    p = torch.pow(torch.clamp(q, min=0.0), col(draws["gamma"])) * (hi - lo) + lo
    q, lo, hi = _rescale01(p)
    trans = (draws["trans"][:, 0], draws["trans"][:, 1])
    shear = (draws["shear"][:, 0], draws["shear"][:, 1])
    m = inverse_affine((w * 0.5, h * 0.5), draws["rot"], trans, draws["scale"], shear)
    p = warp(q, m, 1, (h + 2 * pad, w + 2 * pad), -pad) * (hi - lo) + lo
    s = warp(s.float(), m, 0, (h, w), 0.0)
    ml = inverse_affine((w / 2.0 - 0.5, h / 2.0 - 0.5), draws["rot"], trans, draws["scale"], shear)
    lands = move_landmarks(lands, ml, (h, w))

    hp, wp = p.shape[1:]
    mean = torch.tensor([hp * 0.15, wp * 0.15], device=p.device)
    limit = torch.tensor([hp, wp], dtype=torch.float32, device=p.device)
    rows = torch.arange(hp, device=p.device)[None, :, None]
    cols = torch.arange(wp, device=p.device)[None, None, :]
    for k in range(MAX_ERASE_BOXES):
        dims = torch.minimum(torch.clamp(torch.round(draws["box_normal"][:, k] * mean + mean), min=1.0), limit).long()
        starts = torch.floor(draws["box_uniform"][:, k] * (limit.long() - dims + 1).float()).long()
        active = draws["erase"] & (k < draws["num_boxes"])
        r0, c0 = col(starts[:, 0]), col(starts[:, 1])
        box = (rows >= r0) & (rows < r0 + col(dims[:, 0])) & (cols >= c0) & (cols < c0 + col(dims[:, 1]))
        span = torch.where(box, p, -torch.inf).amax(dim=(1, 2), keepdim=True) - torch.where(
            box, p, torch.inf).amin(dim=(1, 2), keepdim=True)
        p = p + torch.where(box & col(active), draws["box_noise"][:, k] * (span * 0.2), 0.0)
    return p, s, lands


def prepare(draws, projs, segs, lands, num_classes: int, pad_dim: int):
    """A raw batch -> (network input (B, 1, Hp, Wp), one-hot labels
    (B, C, H, W), heatmaps (B, L, H, W)), float32."""
    b, h, w = projs.shape
    pad = math.ceil((pad_dim - h) / 2) if pad_dim > h else 0
    p = projs.float()
    p_aug, s_aug, l_aug = augment(draws, p, segs, lands, pad)
    take = draws["aug"][:, None, None]
    p = torch.where(take, p_aug, F.pad(p[:, None], (pad,) * 4, mode="reflect")[:, 0] if pad else p)
    s = torch.where(take, s_aug, segs.float())
    lands = torch.where(take, l_aug, lands)
    p = (p - p.mean(dim=(1, 2), keepdim=True)) / p.std(dim=(1, 2), correction=1, keepdim=True)
    labels = torch.clamp(torch.round(s).long(), 0, num_classes - 1)
    onehot = F.one_hot(labels, num_classes).permute(0, 3, 1, 2).float()
    return p[:, None], onehot, heatmaps(lands, h, w)


def joint_loss(seg, heats, tgt_seg, tgt_heats, heat_coeff: float):
    """Mean over the batch of (1 - c) dice + c heat, with dice the negated
    soft Dice of every class (eps 1e-4) and heat the landmark mean of
    (NCC + 1) / -2 (NCC with N - 1 standard deviations, eps 1e-8)."""
    seg = center_crop_to(seg, tgt_seg)
    heats = center_crop_to(heats, tgt_heats)
    num = -2.0 * (tgt_seg * seg).sum(dim=(2, 3)) + 1e-4
    den = (tgt_seg * tgt_seg).sum(dim=(2, 3)) + (seg * seg).sum(dim=(2, 3)) + 1e-4
    dice = (num / den).sum(dim=1) / seg.shape[1]
    n = heats.shape[2] * heats.shape[3]
    xz = heats - heats.mean(dim=(2, 3), keepdim=True)
    yz = tgt_heats - tgt_heats.mean(dim=(2, 3), keepdim=True)
    xs = torch.sqrt((xz * xz).sum(dim=(2, 3)) / (n - 1))
    ys = torch.sqrt((yz * yz).sum(dim=(2, 3)) / (n - 1))
    ncc = (xz * yz).sum(dim=(2, 3)) / (n * (xs * ys) + 1e-8)
    heat = ((ncc + 1.0) * -0.5).mean(dim=1)
    return ((1.0 - heat_coeff) * dice + heat_coeff * heat).mean()


def center_crop_to(t, like):
    return unet.center_crop(t, like.shape[-2:])


class SGD:
    """torch.optim.SGD's update with momentum, dampening 0, Nesterov and
    weight decay folded into the gradient: d = g + wd p; buf = d (first
    step) or mu buf + d; p -= lr (d + mu buf)."""

    def __init__(self, momentum: float, nesterov: bool, wgt_decay: float):
        self.momentum, self.nesterov, self.wgt_decay = momentum, nesterov, wgt_decay
        self.buf = {}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float):
        for k, p in params.items():
            if grads[k] is None:  # a parameter no output reaches is skipped, as torch skips it
                continue
            d = grads[k] + self.wgt_decay * p
            buf = self.buf.get(k)
            buf = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
            self.buf[k] = buf
            p.sub_(lr * (d + self.momentum * buf if self.nesterov else buf))


def train_steps(state: dict, param_keys, steps, cfg: dict, num: unet.Numerics, buf0: dict | None = None):
    """Follow the recorded steps (each a dict of the raw batch 'batch',
    'draws' and 'lr') from ``state`` (the weights before the first) and
    the momentum buffers ``buf0`` (none: SGD's first step). Returns
    dict(losses, grad1 (the first step's gradients, before weight decay),
    buf1 (the momentum buffers after the first step), params (after the
    last step))."""
    params = {k: state[k].detach().to(num.dtype).clone().requires_grad_(True) for k in param_keys}
    fixed = {k: v.to(num.dtype) if v.is_floating_point() else v for k, v in state.items() if k not in params}
    opt = SGD(cfg["momentum"], cfg["nesterov"], cfg["wgt_decay"])
    opt.buf = {k: v.detach().to(num.dtype).clone() for k, v in (buf0 or {}).items()}
    out = {"losses": []}
    with num.scope():
        for i, st in enumerate(steps):
            projs, segs, lands = st["batch"]
            x, tgt_seg, tgt_heats = prepare(st["draws"], projs, segs, lands, cfg["num_classes"], cfg["proj_unet_dim"])
            seg, heats = unet.forward({**fixed, **params}, x.to(num.dtype), cfg, num, train=True)
            loss = joint_loss(seg.to(num.dtype), heats.to(num.dtype), tgt_seg.to(num.dtype),
                              tgt_heats.to(num.dtype), cfg["heat_coeff"])
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
            out["losses"].append(float(loss.detach()))
            opt.step(params, grads, st["lr"])
            if i == 0:
                out["grad1"] = {k: torch.zeros_like(params[k]) if g is None else g.detach() for k, g in grads.items()}
                out["buf1"] = {k: b.clone() for k, b in opt.buf.items()}
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out
