"""Astrometry: WCS transforms, plate solving, SPCC color calibration
(counterpart of astroburst_tpu/astrometry).

Reference: src-tauri/src/core/astrometry/.
"""

from astroburst_tpu_torch.astrometry.wcs import CelestialCoord, WcsTransform

__all__ = ["WcsTransform", "CelestialCoord"]
