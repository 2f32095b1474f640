"""Analysis commands (counterpart of astroburst_tpu/api/analysis.py;
reference: src-tauri/src/cmd/analysis/mod.rs).

Ported: the histogram command, star detection on a file or cache key
(``detect_stars``) and on the composite's luminance
(``detect_stars_composite``), both through kernels K10 and K11, and the
subframe metrics (``analyze_subframes_cmd``). ``compute_fft_spectrum``
waits for queue item A13.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.analysis.star_detection import \
    detect_stars as _detect
from astroburst_tpu_torch.analysis.subframe import (SubframeWeightConfig,
                                                    analyze_subframe,
                                                    normalize_weights)
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import Timer, load_from_cache_or_disk
from astroburst_tpu_torch.ops.stats import compute_histogram
from astroburst_tpu_torch.runtime.device import device_or_cuda


def compute_histogram_cmd(path: str, bins: Optional[int] = None, *,
                          device: Optional[torch.device] = None) -> dict:
    """cmd/analysis/mod.rs:22."""
    t0 = Timer()
    entry = load_from_cache_or_disk(path, device_or_cuda(device))
    n_bins = bins or C.HISTOGRAM_BINS_DISPLAY
    hist = compute_histogram(entry.image, n_bins)
    return {
        C.RES_BINS: hist.bins,
        C.RES_BIN_COUNT: len(hist.bins),
        C.RES_BIN_EDGES: hist.bin_edges,
        C.RES_DATA_MIN: hist.min,
        C.RES_DATA_MAX: hist.max,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


# keep the command name matching the reference registration
compute_histogram_command = compute_histogram_cmd


def _stars_payload(result, t0: Timer) -> dict:
    return {
        "stars": [s.to_dict() for s in result.stars],
        "star_count": len(result.stars),
        "background_median": result.background_median,
        "background_sigma": result.background_sigma,
        "threshold_sigma": result.threshold_sigma,
        C.RES_WIDTH: result.image_width,
        C.RES_HEIGHT: result.image_height,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def detect_stars(path: str, sigma_threshold: Optional[float] = None, *,
                 device: Optional[torch.device] = None) -> dict:
    """cmd/analysis/mod.rs:107."""
    t0 = Timer()
    entry = load_from_cache_or_disk(path, device_or_cuda(device))
    result = _detect(entry.image, sigma_threshold or 5.0)
    return _stars_payload(result, t0)


def detect_stars_composite(sigma_threshold: Optional[float] = None, *,
                           device: Optional[torch.device] = None) -> dict:
    """Detection on the composite's BT.709 luminance
    (cmd/analysis/mod.rs:125). The command's own sum, which does not
    scrub non-finite values (``masked_stretch.synthesize_luminance``
    does)."""
    t0 = Timer()
    er, eg, eb = helpers.load_composite_rgb(device_or_cuda(device))
    lum = 0.2126 * er.image + 0.7152 * eg.image + 0.0722 * eb.image
    result = _detect(lum, sigma_threshold or 5.0)
    return _stars_payload(result, t0)


def analyze_subframes_cmd(paths: Sequence[str],
                          config: Optional[dict] = None, *,
                          device: Optional[torch.device] = None) -> dict:
    """Per-frame quality metrics and max-normalized weights
    (cmd/analysis/mod.rs:193)."""
    t0 = Timer()
    device = device_or_cuda(device)
    cfg = SubframeWeightConfig(**(config or {}))
    metrics = []
    for p in paths:
        entry = load_from_cache_or_disk(p, device)
        metrics.append(analyze_subframe(entry.image, p, cfg))
    normalize_weights(metrics)
    return {
        C.RES_FRAMES: [m.to_dict() for m in metrics],
        "accepted_count": sum(1 for m in metrics if m.accepted),
        C.RES_FRAME_COUNT: len(metrics),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
