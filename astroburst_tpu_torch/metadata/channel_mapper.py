"""Automatic channel→RGB(L) slot assignment (its own copy of
astroburst_tpu/metadata/channel_mapper.py).

Reference behavior: src/components/compose/SmartChannelMapper.tsx —
JWST filter→wavelength table (:86-93), metadata auto-map (:109-134:
wavelength-sort; ≥3 files → longest→R / middle→G / shortest→B; exactly
2 → longer→R, shorter→B), filename-pattern fallback (:136-158), with
metadata taking precedence per slot. The reference runs this in the
frontend; here it is a headless helper feeding api.compose.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

JWST_FILTER_WAVELENGTH: Dict[str, int] = {
    "F070W": 700, "F090W": 900, "F115W": 1150, "F140M": 1400,
    "F150W": 1500, "F162M": 1620, "F164N": 1640, "F150W2": 1500,
    "F182M": 1820, "F187N": 1870, "F200W": 2000, "F210M": 2100,
    "F212N": 2120, "F250M": 2500, "F277W": 2770, "F300M": 3000,
    "F322W2": 3220, "F323N": 3230, "F335M": 3350, "F356W": 3560,
    "F360M": 3600, "F405N": 4050, "F410M": 4100, "F430M": 4300,
    "F444W": 4440, "F460M": 4600, "F466N": 4660, "F470N": 4700,
    "F480M": 4800,
}

_SLOT_PATTERNS = {
    "L": [r"[_-]l[._-]", r"luminance|lum|clear"],
    "R": [r"[_-]r[._-]", r"ha|h.?alpha|red", r"f444w|f410m|f356w"],
    "G": [r"[_-]g[._-]", r"oiii|o3|green", r"f200w|f277w"],
    "B": [r"[_-]b[._-]", r"sii|s2|blue", r"f115w|f090w|f150w"],
}


def filter_wavelength(filter_name: Optional[str]) -> Optional[int]:
    """Wavelength (nm×10 as in the table) for a JWST filter name."""
    if not filter_name:
        return None
    return JWST_FILTER_WAVELENGTH.get(filter_name.upper().strip())


def auto_map_by_metadata(
        files: Sequence[dict]) -> Dict[str, dict]:
    """Assign R/G/B by detected filter wavelength.

    `files` entries are dicts with at least `path` and optional
    `filter`. ≥3 wavelength-tagged files: longest→R, median→G,
    shortest→B; exactly 2: longer→R, shorter→B; otherwise {}.
    """
    tagged = [(f, filter_wavelength(f.get("filter"))) for f in files]
    tagged = sorted([(f, wl) for f, wl in tagged if wl is not None],
                    key=lambda x: x[1])
    if not tagged:
        return {}
    if len(tagged) >= 3:
        desc = list(reversed(tagged))
        return {"R": desc[0][0], "G": desc[len(desc) // 2][0],
                "B": desc[-1][0]}
    if len(tagged) == 2:
        return {"R": tagged[1][0], "B": tagged[0][0]}
    return {}


def auto_map_by_filename(
        files: Sequence[dict]) -> Dict[str, dict]:
    """Slot assignment from filename patterns, first match per slot in
    L, R, G, B order; a file is used at most once."""
    result: Dict[str, dict] = {}
    for slot in ("L", "R", "G", "B"):
        for f in files:
            if any(v is f for v in result.values()):
                continue
            name = f.get("name") or f.get("path") or ""
            if any(re.search(p, name, re.IGNORECASE)
                   for p in _SLOT_PATTERNS[slot]):
                result[slot] = f
                break
    return result


def auto_map_channels(files: Sequence[dict]) -> Dict[str, dict]:
    """Metadata mapping first, filename patterns fill remaining slots
    (SmartChannelMapper.tsx auto-assign button behavior)."""
    result = dict(auto_map_by_metadata(files))
    by_name = auto_map_by_filename(
        [f for f in files if not any(v is f for v in result.values())])
    for slot, f in by_name.items():
        result.setdefault(slot, f)
    return result
