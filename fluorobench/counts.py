"""Operations and bytes worked out from a configuration's shapes alone, so
they stay the same whatever implements the layers.

``unet_forward_flops`` walks the U-Net's geometry (the reference's layer
equations, ``reference/unet.py``) and counts 2 operations per multiply-add
of every convolution and transposed convolution, the convention of
``torch.utils.flop_counter``: BatchNorm, ReLU, softmax and the losses are
not counted. A training step counts three forwards (forward, and backward
for inputs and weights); recomputation is not counted.

``warp_pair_bytes`` is the least traffic of one augmentation warp launch:
the projection and the label map read once, both outputs written once, the
matrices read once.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores


def conv_flops(c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> int:
    return 2 * c_in * c_out * k * k * h_out * w_out


def unet_forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one ``size`` x ``size`` frame through
    the configuration's U-Net: 'same' 3x3 convolutions with a residual 1x1
    per block, 2x2 stride-2 learned downsampling, 2x2 stride-2 transposed
    upsampling, skips center-cropped, a 1x1 class head and the landmark
    head's 1x1 convolutions."""
    if not (cfg["padding"] and cfg["no_max_pool"] and cfg["up_mode"] == "upconv"):
        raise ValueError("counts cover padded, learned-downsampling, transposed-upsampling U-Nets")
    depth, wf, nb = cfg["depth"], cfg["init_feats_exp"], cfg["block_depth"]
    h = w = size
    c_in = 1
    total = 0
    for i in range(depth):
        c = 2 ** (wf + i)
        total += conv_flops(c_in, c, 3, h, w) + (nb - 1) * conv_flops(c, c, 3, h, w)
        if cfg["use_res"]:
            total += conv_flops(c_in, c, 1, h, w)
        if i != depth - 1:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
            total += conv_flops(c, c, 2, h, w)
        c_in = c
    for i in reversed(range(depth - 1)):
        c = 2 ** (wf + i)
        # each input pixel meets the 2x2 kernel once: Cin x Cout x 4 per pixel
        total += conv_flops(c_in, c, 2, h, w)
        h, w = 2 * h, 2 * w
        total += conv_flops(2 * c, c, 3, h, w) + (nb - 1) * conv_flops(c, c, 3, h, w)
        if cfg["use_res"]:
            total += conv_flops(2 * c, c, 1, h, w)
        c_in = c
    n_cls, n_lands = cfg["num_classes"], cfg["num_lands"]
    total += conv_flops(c_in, n_cls, 1, h, w)
    if n_lands > 0:
        total += conv_flops(c_in + n_cls, n_lands + n_cls, 1, h, w) + conv_flops(n_lands + n_cls, n_lands, 1, h, w)
    return total


def pad_size(cfg: dict, frame: int) -> int:
    """The network input's side for a ``frame`` x ``frame`` projection:
    reflect-padded by ceil((pad - frame) / 2) a side when the pad target
    is larger (an odd difference gives one row more than the target)."""
    pad = cfg["proj_unet_dim"]
    if pad <= frame:
        return frame
    return frame + 2 * -((frame - pad) // 2)


def train_step_flops(cfg: dict, frame: int) -> int:
    """Operations of one training frame: three forwards."""
    return 3 * unet_forward_flops(cfg, pad_size(cfg, frame))


def warp_pair_bytes(batch: int, frame: int, out: int) -> int:
    """One launch's least bytes: projection in (frame^2) and out (out^2),
    labels in and out (frame^2 each), six matrix entries, float32 each."""
    return 4 * (batch * frame * frame + batch * out * out + 2 * batch * frame * frame + 6 * batch)


def warp_pair_bound_s(batch: int, frame: int, out: int) -> float:
    return warp_pair_bytes(batch, frame, out) / HBM_BYTES_PER_S
