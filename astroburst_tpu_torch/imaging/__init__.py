"""Stretching: the screen transfer function (STF), the star mask (kernel
K13) and the masked stretch. The batch calibration pipeline, the asinh
preview and the bicubic resize are the modules
``calibration_pipeline``, ``normalize`` and ``resample``."""

from astroburst_tpu_torch.imaging.masked_stretch import (
    MaskedStretchConfig, MaskedStretchResult, masked_stretch,
    masked_stretch_rgb_shared, masked_stretch_with_mask, synthesize_luminance)
from astroburst_tpu_torch.imaging.star_mask import (
    StarMaskConfig, StarMaskResult, generate_star_mask,
    generate_star_mask_from_detection)

__all__ = ["MaskedStretchConfig", "MaskedStretchResult", "StarMaskConfig",
           "StarMaskResult", "generate_star_mask",
           "generate_star_mask_from_detection", "masked_stretch",
           "masked_stretch_rgb_shared", "masked_stretch_with_mask",
           "synthesize_luminance"]
