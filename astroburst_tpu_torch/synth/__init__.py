"""Synthetic data generation (counterpart of astroburst_tpu/synth;
reference: src-tauri/src/core/synth/)."""

from astroburst_tpu_torch.synth.star_field import (FieldConfig, Star,
                                                   uniform_field,
                                                   king_cluster,
                                                   exponential_disk)
from astroburst_tpu_torch.synth.psf import (GaussianPsf, MoffatPsf, AiryPsf,
                                            render_stars)
from astroburst_tpu_torch.synth.noise import (NoiseParams, apply_noise,
                                              generate_flat_field,
                                              apply_flat_field)
from astroburst_tpu_torch.synth.pipeline import (SynthConfig, generate,
                                                 generate_stack,
                                                 save_catalog)

__all__ = ["FieldConfig", "Star", "uniform_field", "king_cluster",
           "exponential_disk", "GaussianPsf", "MoffatPsf", "AiryPsf",
           "render_stars", "NoiseParams", "apply_noise",
           "generate_flat_field", "apply_flat_field", "SynthConfig",
           "generate", "generate_stack", "save_catalog"]
