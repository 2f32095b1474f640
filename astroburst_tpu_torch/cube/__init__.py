"""IFU data cubes: eager (on the device) and lazy (mmap streaming)
(counterpart of astroburst_tpu/cube; reference: src-tauri/src/core/cube/).
"""

from astroburst_tpu_torch.cube.eager import (GlobalCubeStats,
                                             SpectralClassification,
                                             build_wavelength_axis,
                                             classify_spectral_cube,
                                             collapse_mean, collapse_median,
                                             compute_global_stats,
                                             normalize_with_global)
from astroburst_tpu_torch.cube.lazy import LazyCube

__all__ = ["GlobalCubeStats", "SpectralClassification",
           "build_wavelength_axis", "classify_spectral_cube",
           "collapse_mean", "collapse_median", "compute_global_stats",
           "normalize_with_global", "LazyCube"]
