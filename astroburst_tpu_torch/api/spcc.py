"""SPCC command (counterpart of astroburst_tpu/api/spcc.py; reference:
src-tauri/src/cmd/spcc.rs): the composite's colour calibration through
``astrometry/spcc.py``, whose detection runs kernels K10 and K11."""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import Timer, load_cached_full
from astroburst_tpu_torch.astrometry.spcc import (SpccConfig,
                                                  spcc_calibrate_rgb)
from astroburst_tpu_torch.errors import InvalidInput
from astroburst_tpu_torch.runtime.device import device_or_cuda


def spcc_calibrate_cmd(path: Optional[str] = None,
                       min_snr: Optional[float] = None,
                       max_stars: Optional[int] = None,
                       saturation_limit: Optional[float] = None,
                       catalog: Optional[str] = None,
                       white_reference: Optional[str] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """cmd/spcc.rs:14 — SPCC over the composite held for ``device`` (the
    ORIG planes, else the KEY ones); the header is the composite's, else
    ``path``'s."""
    t0 = Timer()
    device = device_or_cuda(device)
    er, eg, eb = helpers.load_orig_or_composite(device)
    header = er.header
    if header is None and path:
        header = load_cached_full(path, device).header
    if header is None:
        raise InvalidInput("No WCS header available. Run Plate Solve first.")
    config = SpccConfig(
        min_snr=min_snr if min_snr is not None else 20.0,
        max_stars=max_stars if max_stars is not None else 200,
        saturation_limit=(saturation_limit if saturation_limit is not None
                          else 0.90),
        catalog=catalog or "builtin",
        white_reference=(white_reference or "average_spiral"))
    result = spcc_calibrate_rgb(er.image, eg.image, eb.image, header, config,
                                device=device)
    return {
        C.RES_R_FACTOR: result.r_factor,
        C.RES_G_FACTOR: result.g_factor,
        C.RES_B_FACTOR: result.b_factor,
        C.RES_STARS_MATCHED: result.stars_matched,
        C.RES_STARS_TOTAL: result.stars_total,
        C.RES_AVG_COLOR_INDEX: result.avg_color_index,
        C.RES_WHITE_REF: result.white_ref_name,
        C.RES_CATALOG_NAME: result.catalog_name,
        "is_synthetic_catalog": result.is_synthetic_catalog,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
