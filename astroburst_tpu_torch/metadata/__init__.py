"""Metadata: narrowband filter discovery and palette suggestion
(counterpart of astroburst_tpu/metadata; reference:
src-tauri/src/core/metadata/header_discovery.rs). The blend presets
and the wizard's channel bins come with the compose commands.
"""

from astroburst_tpu_torch.metadata.header_discovery import (
    ChannelSuggestion, Confidence, FilterDetection, HubbleChannel,
    NarrowbandFilter, PaletteSuggestion, PaletteType, detect_filter,
    detect_from_filename, suggest_palette, suggest_palette_with_type)

__all__ = ["NarrowbandFilter", "HubbleChannel", "Confidence",
           "FilterDetection", "ChannelSuggestion", "PaletteSuggestion",
           "PaletteType", "detect_filter", "detect_from_filename",
           "suggest_palette", "suggest_palette_with_type"]
