"""The align → stack → stretch pipeline (single device)."""

from astroburst_tpu_torch.parallel.pipeline import align_stack_stretch

__all__ = ["align_stack_stretch"]
