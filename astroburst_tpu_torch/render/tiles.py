"""Deep-zoom tile pyramid (counterpart of astroburst_tpu/render/tiles.py).

Reference: src-tauri/src/infra/render/tiles.rs — NaN-aware 2× area
downsample, 8-bit render against global 0.1%/99.9% percentile bounds,
mono/RGB variants, and the RGB variant rendered through an STF
(``generate_tile_pyramid_rgb_stf``, tiles.rs:363-373).

Each level is made and quantized to u8 on the device, fetched once
(an RGB level's three planes in one transfer) and cut into
``{tx}_{ty}.png`` tiles on the host, zero-padded to the tile size. The
percentile bounds are exact order statistics of the valid values
(``ops/select.py``; the JAX package takes them by compare-count, within
range/8⁶: ROADMAP C21), so the levels equal the JAX package's given
equal bounds.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from astroburst_tpu_torch.dtypes import ImageStats, StfParams
from astroburst_tpu_torch.imaging.stf import apply_stf_u8
from astroburst_tpu_torch.io.png import save_gray_png, save_rgb_png
from astroburst_tpu_torch.ops.select import (rank_indices, select_ranks,
                                             sorted_rows)
from astroburst_tpu_torch.runtime.device import as_f32


@dataclass
class TileParams:
    tile_size: int = 256


@dataclass
class TileLevel:
    level: int
    width: int
    height: int
    cols: int
    rows: int
    scale_factor: float

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class TilePyramid:
    tile_size: int
    original_width: int
    original_height: int
    levels: List[TileLevel]
    base_dir: str

    def to_dict(self) -> dict:
        d = self.__dict__.copy()
        d["levels"] = [lv.to_dict() for lv in self.levels]
        return d


def downsample_2x(data: torch.Tensor) -> torch.Tensor:
    """NaN-aware 2× box downsample; an odd last row or column is
    replicated, as the reference's min(y0 + 1, rows − 1) clamp reads it
    (tiles.rs:40-70). The four values of a box are added in one fixed
    order (y0x0, y0x1, y1x0, y1x1), elementwise, so the card and the CPU
    give the same bits."""
    if data.shape[0] % 2:
        data = torch.cat([data, data[-1:]], dim=0)
    if data.shape[1] % 2:
        data = torch.cat([data, data[:, -1:]], dim=1)
    quads = [data[dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)]
    s = c = None
    for q in quads:   # one fixed order of adds: the same bits on any device
        fin = torch.isfinite(q)
        v, n = torch.where(fin, q, 0.0), fin.to(torch.float32)
        s, c = (v, n) if s is None else (s + v, c + n)
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)


def compute_num_levels(width: int, height: int, tile_size: int) -> int:
    """tiles.rs:137-147."""
    max_dim = max(width, height)
    if max_dim <= tile_size:
        return 1
    return max(int(np.ceil(np.log2(max_dim / tile_size))) + 1, 1)


def _bounds(data: torch.Tensor) -> torch.Tensor:
    """[lo, hi] f32 on the device: the 0.1% and 99.9% values of the
    finite values above 1e-7 (0-based indices floor(n · pct), capped at
    n − 1: tiles.rs:162-176), or the finite min and max (0 and 1 where
    there is none) when no value is above 1e-7."""
    flat = data.reshape(-1)
    finite = torch.isfinite(flat)
    inf = float("inf")
    rows = sorted_rows(flat, lambda s: torch.where(
        torch.isfinite(s) & (s > 1e-7), s, inf))
    cnt = torch.isfinite(rows).sum()
    vals = select_ranks(rows, rank_indices(cnt, (0.001, 0.999)))
    fmn = torch.where(finite, flat, inf).min()
    fmx = torch.where(finite, flat, -inf).max()
    fallback = torch.stack([torch.where(torch.isfinite(fmn), fmn, 0.0),
                            torch.where(torch.isfinite(fmx), fmx, 1.0)])
    return torch.where(cnt > 0, vals, fallback)


def percentile_bounds(data) -> Tuple[float, float]:
    lo, hi = _bounds(as_f32(data)).tolist()
    return lo, hi


def quantize(data: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """round((v − lo) · 255 / (hi − lo)) clipped to [0, 255], non-finite
    → 0, as u8."""
    inv = 255.0 / torch.clamp(hi - lo, min=1e-10)
    q = torch.clamp(torch.round((data - lo) * inv), 0.0, 255.0)
    return torch.where(torch.isfinite(data), q, 0.0).to(torch.uint8)


def _save_level_tiles(level_u8: List[np.ndarray], level_dir: str,
                      tile_size: int, rgb: bool) -> Tuple[int, int]:
    h, w = level_u8[0].shape
    tile_cols = -(-w // tile_size)
    tile_rows = -(-h // tile_size)
    os.makedirs(level_dir, exist_ok=True)
    for ty in range(tile_rows):
        for tx in range(tile_cols):
            y0, x0 = ty * tile_size, tx * tile_size
            path = os.path.join(level_dir, f"{tx}_{ty}.png")
            planes = []
            for p in level_u8:
                tile = np.zeros((tile_size, tile_size), np.uint8)
                sub = p[y0:y0 + tile_size, x0:x0 + tile_size]
                tile[:sub.shape[0], :sub.shape[1]] = sub
                planes.append(tile)
            if rgb:
                save_rgb_png(planes[0], planes[1], planes[2], path)
            else:
                save_gray_png(planes[0], path)
    return tile_cols, tile_rows


def _build_pyramid(planes, output_dir: str, params: TileParams,
                   render) -> TilePyramid:
    """Levels from ``planes`` (coarsest first); ``render(level_planes)``
    gives each level's u8 planes on the device."""
    tile_size = params.tile_size
    orig_rows, orig_cols = planes[0].shape
    num_levels = compute_num_levels(orig_cols, orig_rows, tile_size)
    os.makedirs(output_dir, exist_ok=True)

    stack = [planes]
    for _ in range(1, num_levels):
        stack.append([downsample_2x(p) for p in stack[-1]])

    max_level = num_levels - 1
    levels = []
    for level in range(num_levels):
        u8 = list(torch.stack(render(stack[max_level - level])).cpu()
                  .numpy())
        level_dir = os.path.join(output_dir, str(level))
        tile_cols, tile_rows = _save_level_tiles(u8, level_dir, tile_size,
                                                 len(u8) == 3)
        lh, lw = u8[0].shape
        levels.append(TileLevel(
            level=level, width=lw, height=lh, cols=tile_cols,
            rows=tile_rows, scale_factor=1.0 / (1 << (max_level - level))))
    return TilePyramid(tile_size=tile_size, original_width=orig_cols,
                       original_height=orig_rows, levels=levels,
                       base_dir=output_dir)


def _percentile_render(bounds_plane: torch.Tensor):
    lo, hi = _bounds(bounds_plane).unbind()
    return lambda level_planes: [quantize(p, lo, hi) for p in level_planes]


def generate_tile_pyramid(normalized, output_dir: str,
                          params: TileParams = TileParams()) -> TilePyramid:
    """Mono pyramid against the plane's own percentile bounds
    (tiles.rs:179-255)."""
    plane = as_f32(normalized)
    return _build_pyramid([plane], output_dir, params,
                          _percentile_render(plane))


def generate_tile_pyramid_rgb(r, g, b, output_dir: str,
                              params: TileParams = TileParams()
                              ) -> TilePyramid:
    """RGB pyramid with shared luminance-based bounds (tiles.rs:363+)."""
    planes = [as_f32(p) for p in (r, g, b)]
    lum = 0.2126 * planes[0] + 0.7152 * planes[1] + 0.0722 * planes[2]
    return _build_pyramid(planes, output_dir, params,
                          _percentile_render(lum))


def generate_tile_pyramid_rgb_stf(r, g, b, stf: StfParams, stats_r: ImageStats,
                                  stats_g: ImageStats, stats_b: ImageStats,
                                  output_dir: str,
                                  params: TileParams = TileParams()
                                  ) -> TilePyramid:
    """RGB pyramid whose every level is rendered to u8 through ``stf``
    with each channel's own stats (``imaging/stf.apply_stf_u8``), in
    place of the percentile quantize (tiles.rs:363-373,
    generate_tile_pyramid_rgb_stf)."""
    planes = [as_f32(p) for p in (r, g, b)]
    stats = (stats_r, stats_g, stats_b)
    return _build_pyramid(
        planes, output_dir, params,
        lambda level_planes: [apply_stf_u8(p, stf, st)
                              for p, st in zip(level_planes, stats)])
