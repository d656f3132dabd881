"""Dataset-exploration overlays (JAX counterpart: ``deepfluoro_tpu/viz/
examples.py``; reference examples_dataset/make_preproc_overlays.py and
make_full_res_overlays.py): per specimen, one tiled PNG of all its
projections with the GT segmentation blended in and the GT landmarks
dotted.

The blends run on ``device`` (``overlays.py``'s tensor functions, a
specimen's frames at once in the preprocessed archive); PIL draws the
marks, downscales and writes the PNG on the host. h5py and PIL are
imported inside the functions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepfluoro_tpu_torch.utils.platform import get_device
from deepfluoro_tpu_torch.viz.overlays import blend_seg, normalized_proj_rgb, to_uint8


def tile_images(imgs: torch.Tensor, nrow: int = 8, padding: int = 2) -> torch.Tensor:
    """Grid-tile (N, H, W, C) images in torchvision's ``save_image`` layout
    (8 per row, 2 px of zero padding around and between them)."""
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nr = -(-n // ncol)
    cells = imgs.new_zeros((nr * ncol, h + padding, w + padding, c))
    cells[:n, padding:, padding:] = imgs
    rows = cells.reshape(nr, ncol, h + padding, w + padding, c).permute(0, 2, 1, 3, 4)
    grid = imgs.new_zeros((nr * (h + padding) + padding, ncol * (w + padding) + padding, c))
    grid[: nr * (h + padding), : ncol * (w + padding)] = rows.reshape(nr * (h + padding), ncol * (w + padding), c)
    return grid


def _save_grid(overlays: list[torch.Tensor], out_path: str) -> None:
    from PIL import Image

    Image.fromarray(to_uint8(tile_images(torch.stack(overlays))).numpy(), "RGB").save(out_path)


def _as_float(pil) -> torch.Tensor:
    """A drawn PIL image back to [0, 1] float32, as the JAX package
    re-reads it before tiling (``np.asarray(pil, np.float32) / 255.0``)."""
    return torch.from_numpy(np.asarray(pil, np.float32)) / 255.0


def make_preproc_overlays(h5_path: str, out_dir: str = ".", device=None) -> list[str]:
    """Per specimen: every projection with the GT seg blended and the GT
    landmarks as yellow dots, tiled; the landmark-names group is skipped;
    the dot's box radius scales with the resolution, max(16 h / 1536, 3)
    (make_preproc_overlays.py:38-139). Returns the PNGs' paths."""
    import h5py
    from PIL import Image, ImageDraw

    dev = get_device(device)
    written = []
    with h5py.File(h5_path, "r") as f:
        box_radius = None
        for spec_idx_str in f:
            spec_g = f[spec_idx_str]
            if "projs" not in spec_g:
                continue
            projs = torch.from_numpy(spec_g["projs"][:]).to(dev)
            # archives converted from sources without GT annotations carry
            # projs only (data/preprocess.py writes segs and lands when present)
            segs = torch.from_numpy(spec_g["segs"][:]).to(dev) if "segs" in spec_g else None
            lands = spec_g["lands"][:] if "lands" in spec_g else None
            n, h, w = projs.shape
            if box_radius is None:
                box_radius = max(16 * (h / 1536.0), 3.0)

            img = normalized_proj_rgb(projs)
            if segs is not None:
                img = blend_seg(img, segs)
            frames = to_uint8(img).cpu().numpy()
            overlays = []
            for i in range(n):
                pil = Image.fromarray(frames[i], "RGB")
                draw = ImageDraw.Draw(pil)
                for li in range(lands.shape[2] if lands is not None else 0):
                    x, y = lands[i, 0, li], lands[i, 1, li]
                    if 0 <= x < w and 0 <= y < h:
                        draw.ellipse([(x - box_radius, y - box_radius), (x + box_radius, y + box_radius)],
                                     fill="yellow")
                del draw
                overlays.append(_as_float(pil))

            out_path = os.path.join(out_dir, "{}.png".format(spec_idx_str))
            _save_grid(overlays, out_path)
            written.append(out_path)
    return written


def make_full_res_overlays(h5_path: str, out_dir: str = ".", overlay_ds_factor: float = 0.125,
                           device=None) -> list[str]:
    """The full-resolution archive's version: reads proj-params, flips
    image, seg and landmarks by rot-180-for-up, writes the femur-FOV
    validity text, downscales each overlay by ``overlay_ds_factor`` (PIL's
    bilinear) and tiles them (make_full_res_overlays.py:28-202). Returns
    the PNGs' paths."""
    import h5py
    from PIL import Image, ImageDraw, ImageFont

    dev = get_device(device)
    written = []
    with h5py.File(h5_path, "r") as f:
        pp = f["proj-params"]
        num_cols = int(pp["num-cols"][()])
        num_rows = int(pp["num-rows"][()])
        ds_cols = int(round(num_cols * overlay_ds_factor))
        ds_rows = int(round(num_rows * overlay_ds_factor))

        try:
            font = ImageFont.truetype("Arial.ttf", 48)
        except OSError:  # no such font here: PIL's default
            font = None

        for spec_id in f:
            if spec_id == "proj-params":
                continue
            projs_g = f["{}/projections".format(spec_id)]
            overlays = []
            for pk in sorted(projs_g.keys()):
                pg = projs_g[pk]
                proj = torch.from_numpy(np.asarray(pg["image/pixels"][:], np.float32)).to(dev)
                seg = torch.from_numpy(np.asarray(pg["gt-seg/pixels"][:])).to(dev)

                lands = []
                fhl_idx = fhr_idx = None
                for name in pg["gt-landmarks"]:
                    pt = np.asarray(pg["gt-landmarks"][name][:], np.float64).reshape(-1)[:2]
                    if 0 <= pt[0] < num_cols and 0 <= pt[1] < num_rows:
                        if name == "FH-l":
                            fhl_idx = len(lands)
                        elif name == "FH-r":
                            fhr_idx = len(lands)
                        lands.append(pt.copy())

                if bool(np.asarray(pg["rot-180-for-up"][()])):
                    proj = torch.flip(proj, dims=(0, 1))
                    seg = torch.flip(seg, dims=(0, 1))
                    for pt in lands:
                        pt[0] = num_cols - 1 - pt[0]
                        pt[1] = num_rows - 1 - pt[1]

                l_ok = bool(np.asarray(pg["gt-poses/left-femur-good-fov"][()]))
                r_ok = bool(np.asarray(pg["gt-poses/right-femur-good-fov"][()]))

                pil = Image.fromarray(to_uint8(blend_seg(normalized_proj_rgb(proj), seg)).cpu().numpy(), "RGB")
                draw = ImageDraw.Draw(pil)
                for pt in lands:
                    draw.ellipse([(pt[0] - 16, pt[1] - 16), (pt[0] + 16, pt[1] + 16)], fill="yellow")
                if l_ok:
                    xy = tuple(lands[fhl_idx]) if fhl_idx is not None else (0, 0)
                    draw.text(xy, "L. Femur FOV OK", font=font)
                if r_ok:
                    xy = tuple(lands[fhr_idx]) if fhr_idx is not None else (0, 0)
                    draw.text(xy, "R. Femur FOV OK", font=font)
                del draw

                overlays.append(_as_float(pil.resize((ds_cols, ds_rows), Image.BILINEAR)))

            out_path = os.path.join(out_dir, "{}.png".format(spec_id))
            _save_grid(overlays, out_path)
            written.append(out_path)
    return written
