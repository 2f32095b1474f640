"""Visualization commands (counterpart of
astroburst_tpu/api/visualization.py; reference:
src-tauri/src/cmd/visualization/mod.rs): ``apply_stf_render`` and the
deep-zoom pyramids ``generate_tiles`` and ``generate_tiles_rgb``.

The pyramids follow the reference, not the JAX package (ROADMAP C1):
``generate_tiles`` auto-STFs the plane first (``compute_image_stats`` →
``auto_stf`` → ``apply_stf_f32``, mod.rs:60-61) and builds the
percentile pyramid on the stretched plane; ``generate_tiles_rgb``
renders every level through the linked auto-STF to u8 (mod.rs:83-100,
tiles.rs:363-373). The JAX package passes the raw linear planes to the
percentile quantize.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (Timer, load_from_cache_or_disk,
                                             png_path_for)
from astroburst_tpu_torch.dtypes import StfParams
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, auto_stf
from astroburst_tpu_torch.render.tiles import (TileParams,
                                               generate_tile_pyramid,
                                               generate_tile_pyramid_rgb_stf)
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir


def apply_stf_render(path: str, output_dir: str, shadow: float,
                     midtone: float, highlight: float, *,
                     device: Optional[torch.device] = None) -> dict:
    """cmd/visualization/mod.rs:12 — render with user STF params."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_from_cache_or_disk(path, device)
    params = StfParams(shadow=shadow, midtone=midtone, highlight=highlight)
    png_path = png_path_for(path, out_dir, suffix="stf")
    helpers.save_stf_preview_png(entry.image, params, entry.stats, png_path)
    h, w = entry.image.shape
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [w, h],
        C.RES_STF: params.to_dict(),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def generate_tiles(path: str, output_dir: str,
                   tile_size: Optional[int] = None, *,
                   device: Optional[torch.device] = None) -> dict:
    """cmd/visualization/mod.rs:50 — mono deep-zoom pyramid of the
    auto-STF'd plane."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_from_cache_or_disk(path, device)
    stretched = apply_stf_f32(entry.image, auto_stf(entry.stats),
                              entry.stats)
    stem = os.path.splitext(os.path.basename(path))[0] or "tiles"
    tiles_dir = os.path.join(out_dir, f"{stem}_tiles")
    pyramid = generate_tile_pyramid(stretched, tiles_dir,
                                    TileParams(tile_size or 256))
    out = pyramid.to_dict()
    out[C.RES_ELAPSED_MS] = t0.elapsed_ms()
    return out


def generate_tiles_rgb(output_dir: str, tile_size: Optional[int] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """cmd/visualization/mod.rs:73 — composite RGB pyramid through the
    linked auto-STF."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    er, eg, eb = helpers.load_composite_rgb(device)
    linked = helpers.compute_linked_stf(er.stats, eg.stats, eb.stats)
    tiles_dir = os.path.join(out_dir, "composite_tiles")
    pyramid = generate_tile_pyramid_rgb_stf(
        er.image, eg.image, eb.image, linked, er.stats, eg.stats, eb.stats,
        tiles_dir, TileParams(tile_size or 256))
    out = pyramid.to_dict()
    out[C.RES_ELAPSED_MS] = t0.elapsed_ms()
    return out
