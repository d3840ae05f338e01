"""Device-side image / geometry operators (pure JAX)."""

from dvo_tpu.ops.image import cull_image, cull_mask, cull_intrinsic, gradients
from dvo_tpu.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu.ops.warp import (
    project,
    back_project,
    warp_points,
    warp_image,
    map_depth_to_gray,
)
from dvo_tpu.ops.depth_filter import gaussian_fuse, gaussian_update_with_reset

__all__ = [
    "cull_image",
    "cull_mask",
    "cull_intrinsic",
    "gradients",
    "bilinear_dense",
    "bilinear_masked",
    "project",
    "back_project",
    "warp_points",
    "warp_image",
    "map_depth_to_gray",
    "gaussian_fuse",
    "gaussian_update_with_reset",
]
