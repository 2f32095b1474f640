"""Metadata: narrowband filter discovery, palette suggestion, the blend
presets and the compose wizard's channel bins (counterpart of
astroburst_tpu/metadata; reference:
src-tauri/src/core/metadata/header_discovery.rs and
src/utils/wizard.ts).
"""

from astroburst_tpu_torch.metadata.header_discovery import (
    ChannelSuggestion, Confidence, FilterDetection, HubbleChannel,
    NarrowbandFilter, PaletteSuggestion, PaletteType, detect_filter,
    detect_from_filename, suggest_palette, suggest_palette_with_type)
from astroburst_tpu_torch.metadata.presets import BLEND_PRESETS, DEFAULT_BINS

__all__ = ["NarrowbandFilter", "HubbleChannel", "Confidence",
           "FilterDetection", "ChannelSuggestion", "PaletteSuggestion",
           "PaletteType", "detect_filter", "detect_from_filename",
           "suggest_palette", "suggest_palette_with_type", "BLEND_PRESETS",
           "DEFAULT_BINS"]
