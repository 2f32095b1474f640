"""Channel bins and blend presets (its own copy of
astroburst_tpu/metadata/presets.py).

Reference: src/utils/wizard.ts:71-134 — 7 default frequency bins with
wavelengths and the 6 blend presets (RGB, SHO, Hubble Legacy, HOO,
Dynamic HOO, Foraxx) with their weight matrices.
"""

DEFAULT_BINS = [
    {"id": "ha", "label": "Hα (656nm)", "short_label": "Hα",
     "wavelength": 656},
    {"id": "oiii", "label": "OIII (502nm)", "short_label": "OIII",
     "wavelength": 502},
    {"id": "sii", "label": "SII (673nm)", "short_label": "SII",
     "wavelength": 673},
    {"id": "r", "label": "Red", "short_label": "R", "wavelength": None},
    {"id": "g", "label": "Green", "short_label": "G", "wavelength": None},
    {"id": "b", "label": "Blue", "short_label": "B", "wavelength": None},
    {"id": "l", "label": "Luminance", "short_label": "L", "wavelength": None},
]

BLEND_PRESETS = {
    "rgb": {
        "label": "RGB",
        "desc": "Direct R→R G→G B→B",
        "weights": [
            {"channel_id": "r", "r": 1.0, "g": 0.0, "b": 0.0},
            {"channel_id": "g", "r": 0.0, "g": 1.0, "b": 0.0},
            {"channel_id": "b", "r": 0.0, "g": 0.0, "b": 1.0},
        ],
    },
    "sho": {
        "label": "SHO (Hubble)",
        "desc": "SII→R Hα→G OIII→B",
        "weights": [
            {"channel_id": "sii", "r": 1.0, "g": 0.0, "b": 0.0},
            {"channel_id": "ha", "r": 0.0, "g": 1.0, "b": 0.0},
            {"channel_id": "oiii", "r": 0.0, "g": 0.0, "b": 1.0},
        ],
    },
    "hubble_legacy": {
        "label": "Hubble Legacy",
        "desc": "Blended SHO with teal/yellow tones",
        "weights": [
            {"channel_id": "sii", "r": 0.7, "g": 0.3, "b": 0.0},
            {"channel_id": "ha", "r": 0.3, "g": 0.8, "b": 0.2},
            {"channel_id": "oiii", "r": 0.0, "g": 0.15, "b": 0.85},
        ],
    },
    "hoo": {
        "label": "HOO",
        "desc": "Hα→R OIII→G+B",
        "weights": [
            {"channel_id": "ha", "r": 1.0, "g": 0.0, "b": 0.0},
            {"channel_id": "oiii", "r": 0.0, "g": 0.5, "b": 0.5},
        ],
    },
    "dynamic_hoo": {
        "label": "Dynamic HOO",
        "desc": "Blended Hα/OIII with warm tones",
        "weights": [
            {"channel_id": "ha", "r": 0.9, "g": 0.4, "b": 0.0},
            {"channel_id": "oiii", "r": 0.1, "g": 0.6, "b": 1.0},
        ],
    },
    "foraxx": {
        "label": "Foraxx",
        "desc": "Popular narrowband blend",
        "weights": [
            {"channel_id": "sii", "r": 0.8, "g": 0.2, "b": 0.0},
            {"channel_id": "ha", "r": 0.2, "g": 0.7, "b": 0.1},
            {"channel_id": "oiii", "r": 0.0, "g": 0.1, "b": 0.9},
        ],
    },
}


def resolve_preset_weights(preset_id: str, bin_order: list) -> list:
    """Map a preset's channel_id weights onto channel indices for
    compose.blend_channels, wavelength-sorted assignment with
    positional fallback (wizard.ts:196-215 workflow resolution)."""
    preset = BLEND_PRESETS.get(preset_id)
    if preset is None:
        raise KeyError(f"unknown blend preset: {preset_id}")
    index_by_id = {b: i for i, b in enumerate(bin_order)}
    out = []
    for w in preset["weights"]:
        idx = index_by_id.get(w["channel_id"])
        if idx is None:
            continue
        out.append({"channel_idx": idx, "r_weight": w["r"],
                    "g_weight": w["g"], "b_weight": w["b"]})
    return out
