"""Stats payloads and the STF preview (the part of
astroburst_tpu/api/helpers.py that the ``stack`` command runs;
reference: src-tauri/src/cmd/helpers.rs).
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.dtypes import ImageStats, StfParams
from astroburst_tpu_torch.imaging.stf import apply_stf_u8
from astroburst_tpu_torch.io.png import save_gray_png
from astroburst_tpu_torch.ops.ipc import nearest_downsample


def stats_json(stats: ImageStats) -> dict:
    """Short stats payload (helpers.rs:146-154)."""
    return {
        C.RES_MIN: stats.min,
        C.RES_MAX: stats.max,
        C.RES_MEAN: stats.mean,
        C.RES_SIGMA: stats.sigma,
        C.RES_MEDIAN: stats.median,
    }


def stats_json_full(stats: ImageStats) -> dict:
    """Stats payload incl. MAD (helpers.rs:156-165)."""
    d = stats_json(stats)
    d[C.RES_MAD] = stats.mad
    return d


def save_stf_preview_png(plane: torch.Tensor, stf: StfParams,
                         stats: ImageStats, path: str,
                         max_dim: int = 4096) -> None:
    """Nearest-downsample the f32 plane first, then STF-map and
    quantise (the STF is pointwise, so it commutes with subsampling),
    fetch the u8 preview and save it."""
    small = nearest_downsample(plane, max_dim)
    save_gray_png(apply_stf_u8(small, stf, stats).cpu().numpy(), path)
