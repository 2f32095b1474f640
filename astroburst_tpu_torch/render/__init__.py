"""Rendering: tile pyramids (counterpart of astroburst_tpu/render;
reference: src-tauri/src/infra/render/)."""

from astroburst_tpu_torch.render.tiles import (TileParams, TilePyramid,
                                               generate_tile_pyramid,
                                               generate_tile_pyramid_rgb,
                                               generate_tile_pyramid_rgb_stf)

__all__ = ["TileParams", "TilePyramid", "generate_tile_pyramid",
           "generate_tile_pyramid_rgb", "generate_tile_pyramid_rgb_stf"]
