"""Compose: channel blending, white balance, LRGB, the RGB pipeline and
the per-channel drizzle (counterpart of astroburst_tpu/compose;
reference: src-tauri/src/core/compose/).
"""

from astroburst_tpu_torch.compose.channel_blend import blend_channels
from astroburst_tpu_torch.compose.lrgb import apply_lrgb, synthesize_luminance
from astroburst_tpu_torch.compose.white_balance import select_wb_reference

__all__ = ["blend_channels", "select_wb_reference", "apply_lrgb",
           "synthesize_luminance"]
