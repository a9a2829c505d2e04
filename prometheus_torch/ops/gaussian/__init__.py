from .composite_grad import CompositeFunction, composite_tiled_grad
from .compositor import (composite_tiles, composite_tiles_bwd,
                         composite_tiles_bwd_plain, composite_tiles_plain,
                         gather_rows, run_compositor_kernel,
                         sorted_tile_segments)
from .converter import convert_gaussians
from .projection import Projected, bbox_extents, project_gaussians
from .renderer import render_gaussians, render_gaussians_tile_sharded
from .tiled import default_instance_budget, tile_overflow_stats

__all__ = [
    "CompositeFunction", "Projected", "bbox_extents", "composite_tiled_grad",
    "composite_tiles", "composite_tiles_bwd", "composite_tiles_bwd_plain",
    "composite_tiles_plain", "convert_gaussians", "default_instance_budget",
    "gather_rows", "project_gaussians", "render_gaussians",
    "render_gaussians_tile_sharded",
    "run_compositor_kernel", "sorted_tile_segments", "tile_overflow_stats",
]
