"""Analysis: star detection (kernels K10 and K11)."""

from astroburst_tpu_torch.analysis.star_detection import (DetectedStar,
                                                          DetectionResult,
                                                          detect_stars,
                                                          estimate_background)

__all__ = ["DetectedStar", "DetectionResult", "detect_stars",
           "estimate_background"]
