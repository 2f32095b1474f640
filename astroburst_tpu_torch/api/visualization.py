"""Visualization commands (counterpart of
astroburst_tpu/api/visualization.py; reference:
src-tauri/src/cmd/visualization/mod.rs). ``apply_stf_render`` is
ported; the tile pyramids (``generate_tiles*``) come with the cube and
tile slice (ROADMAP C1).
"""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (Timer, load_from_cache_or_disk,
                                             png_path_for)
from astroburst_tpu_torch.dtypes import StfParams
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
