"""Overlays and projective geometry (JAX counterpart: ``deepfluoro_tpu/
viz/``): tensor blends on any device, PIL for the marks and PNGs, vtk for
the 3D viewer, both imported only inside the functions that need them."""

from deepfluoro_tpu_torch.viz.overlays import (
    LABEL_COLORS,
    blend_heat,
    blend_seg,
    make_overlay_est_ann,
    make_overlay_est_heat,
    normalized_proj_rgb,
)

__all__ = [
    "LABEL_COLORS",
    "normalized_proj_rgb",
    "blend_seg",
    "blend_heat",
    "make_overlay_est_ann",
    "make_overlay_est_heat",
]
