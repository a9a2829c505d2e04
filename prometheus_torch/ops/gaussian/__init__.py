"""Differentiable 3D Gaussian splatting (``prometheus_tpu/ops/gaussian``):
projection, binning, the tile compositor (kernels B and C) and the
renderer.

- ``render_gaussians``: batched ``(B, N)``-view RGB, expected depth, alpha;
- ``convert_gaussians``: decoder channels -> world-space gaussians;
- ``project_gaussians`` / ``composite_tiled``: the two stages of one view;
- ``composite_naive``: the exact O(HW N) reference.
"""
from .composite_grad import CompositeFunction, composite_tiled_grad
from .compositor import (composite_tiles, composite_tiles_bwd,
                         composite_tiles_bwd_plain, composite_tiles_plain,
                         gather_rows, run_compositor_kernel,
                         sorted_tile_segments)
from .converter import (GAUSSIAN_CHANNELS, NUM_GAUSSIAN_CHANNELS,
                        convert_gaussians)
from .naive import composite_naive
from .projection import (Projected, bbox_extents, covariance_3d,
                         project_gaussians, w2c_from_camera_vector)
from .renderer import render_gaussians, render_gaussians_tile_sharded
from .tiled import (composite_tiled, default_instance_budget,
                    sorted_instances, tile_overflow_stats)

__all__ = [
    "CompositeFunction", "GAUSSIAN_CHANNELS", "NUM_GAUSSIAN_CHANNELS",
    "Projected", "bbox_extents", "composite_naive", "composite_tiled",
    "composite_tiled_grad", "composite_tiles", "composite_tiles_bwd",
    "composite_tiles_bwd_plain", "composite_tiles_plain",
    "convert_gaussians", "covariance_3d", "default_instance_budget",
    "gather_rows", "project_gaussians", "render_gaussians",
    "render_gaussians_tile_sharded", "run_compositor_kernel",
    "sorted_instances", "sorted_tile_segments", "tile_overflow_stats",
    "w2c_from_camera_vector",
]
