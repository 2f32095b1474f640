"""Analysis commands (counterpart of astroburst_tpu/api/analysis.py;
reference: src-tauri/src/cmd/analysis/mod.rs). The histogram command
is ported; the FFT spectrum, star detection and subframe commands come
with their slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
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
