"""Narrowband filter detection and palette suggestion (its own copy of
astroburst_tpu/metadata/header_discovery.py).

Reference: src-tauri/src/core/metadata/header_discovery.rs — filter
detection from FILTER-family keywords (regex Hα/[OIII]/[SII]),
instrument/any-FILT/BAND/LINE cards, wavelength keywords, filename
hints with confidence; palette mapping files → R/G/B for
SHO/HOO/HOS/NaturalColor/Custom with higher-confidence replacement.
"""

from __future__ import annotations

import enum
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from astroburst_tpu_torch.io.header import HduHeader


class NarrowbandFilter(str, enum.Enum):
    HA = "Hα (656nm)"
    OIII = "[OIII] (502nm)"
    SII = "[SII] (673nm)"
    UNKNOWN = "Unknown"


class HubbleChannel(str, enum.Enum):
    RED = "R"
    GREEN = "G"
    BLUE = "B"


class Confidence(enum.IntEnum):
    HIGH = 0
    MEDIUM = 1
    LOW = 2

    @property
    def label(self) -> str:
        return {0: "high", 1: "medium", 2: "low"}[int(self)]


# regexes mirror header_discovery.rs:88-104
_RE_HA = re.compile(r"(?i)(\bH[\-_]?(?:alpha|a)\b|656\s*(?:nm|\.?\d)|H_?α)")
_RE_OIII = re.compile(r"(?i)(\bO\s*III\b|\[?OIII\]?|502\s*(?:nm|\.?\d)|O3\b)")
_RE_SII = re.compile(r"(?i)(\bS\s*II\b|\[?SII\]?|673\s*(?:nm|\.?\d)|S2\b)")

_FILTER_MATCHERS: Tuple[Tuple[NarrowbandFilter, re.Pattern], ...] = (
    (NarrowbandFilter.HA, _RE_HA),
    (NarrowbandFilter.OIII, _RE_OIII),
    (NarrowbandFilter.SII, _RE_SII),
)

DISCOVERY_KEYWORDS = ("FILTER", "FILTER1", "FILTER2", "FILTER3",
                      "INSTRUME", "OBJECT", "IMAGETYP",
                      "FILT_ID", "FILTNAM", "FILTNAME")

FILENAME_PATTERNS: Tuple[Tuple[NarrowbandFilter, Tuple[str, ...]], ...] = (
    (NarrowbandFilter.HA, ("_HA", "_HALPHA", "-HA", "_H_ALPHA", "656")),
    (NarrowbandFilter.OIII, ("_OIII", "-OIII", "_O3", "-O3", "502")),
    (NarrowbandFilter.SII, ("_SII", "-SII", "_S2", "-S2", "673")),
)


class PaletteType(str, enum.Enum):
    SHO = "SHO"
    HOO = "HOO"
    HOS = "HOS"
    NATURAL_COLOR = "NaturalColor"
    CUSTOM = "Custom"

    @property
    def display_name(self) -> str:
        return {
            PaletteType.SHO: "SHO (Hubble Palette)",
            PaletteType.HOO: "HOO",
            PaletteType.HOS: "HOS",
            PaletteType.NATURAL_COLOR: "Natural Color",
            PaletteType.CUSTOM: "Custom",
        }[self]

    @staticmethod
    def from_str_loose(s: str) -> "PaletteType":
        t = (s or "").strip().upper().replace("_", "").replace(" ", "")
        return {
            "SHO": PaletteType.SHO, "HUBBLE": PaletteType.SHO,
            "HOO": PaletteType.HOO, "HOS": PaletteType.HOS,
            "NATURAL": PaletteType.NATURAL_COLOR,
            "NATURALCOLOR": PaletteType.NATURAL_COLOR,
            "CUSTOM": PaletteType.CUSTOM,
        }.get(t, PaletteType.SHO)


@dataclass
class FilterDetection:
    filter: NarrowbandFilter
    hubble_channel: HubbleChannel
    confidence: Confidence
    matched_keyword: str
    matched_value: str

    def to_dict(self) -> dict:
        return {
            "filter": self.filter.value,
            "hubble_channel": self.hubble_channel.value,
            "confidence": self.confidence.label,
            "matched_keyword": self.matched_keyword,
            "matched_value": self.matched_value,
        }


@dataclass
class ChannelSuggestion:
    file_path: str
    file_name: str
    detection: Optional[FilterDetection]

    def to_dict(self) -> dict:
        return {
            "file_path": self.file_path,
            "file_name": self.file_name,
            "detection": self.detection.to_dict() if self.detection else None,
        }


@dataclass
class PaletteSuggestion:
    r_file: Optional[ChannelSuggestion]
    g_file: Optional[ChannelSuggestion]
    b_file: Optional[ChannelSuggestion]
    unmapped: List[ChannelSuggestion]
    is_complete: bool
    palette_name: str

    def to_dict(self) -> dict:
        return {
            "r_file": self.r_file.to_dict() if self.r_file else None,
            "g_file": self.g_file.to_dict() if self.g_file else None,
            "b_file": self.b_file.to_dict() if self.b_file else None,
            "unmapped": [u.to_dict() for u in self.unmapped],
            "is_complete": self.is_complete,
            "palette_name": self.palette_name,
        }


def palette_channels(palette: PaletteType,
                     filt: NarrowbandFilter) -> List[HubbleChannel]:
    """header_discovery.rs:167-189."""
    if palette == PaletteType.SHO:
        return {NarrowbandFilter.SII: [HubbleChannel.RED],
                NarrowbandFilter.HA: [HubbleChannel.GREEN],
                NarrowbandFilter.OIII: [HubbleChannel.BLUE]}.get(filt, [])
    if palette in (PaletteType.HOO, PaletteType.NATURAL_COLOR):
        return {NarrowbandFilter.HA: [HubbleChannel.RED],
                NarrowbandFilter.OIII: [HubbleChannel.GREEN,
                                        HubbleChannel.BLUE]}.get(filt, [])
    if palette == PaletteType.HOS:
        return {NarrowbandFilter.HA: [HubbleChannel.RED],
                NarrowbandFilter.OIII: [HubbleChannel.GREEN],
                NarrowbandFilter.SII: [HubbleChannel.BLUE]}.get(filt, [])
    return []


def filter_to_hubble_channel(filt: NarrowbandFilter) -> HubbleChannel:
    return {NarrowbandFilter.SII: HubbleChannel.RED,
            NarrowbandFilter.HA: HubbleChannel.GREEN,
            NarrowbandFilter.OIII: HubbleChannel.BLUE}.get(
                filt, HubbleChannel.GREEN)


def _keyword_confidence(keyword: str) -> Confidence:
    k = keyword.upper()
    if k in ("FILTER", "FILTER1", "FILTER2", "FILTER3", "FILT_ID",
             "FILTNAM", "FILTNAME"):
        return Confidence.HIGH
    if k == "INSTRUME":
        return Confidence.MEDIUM
    return Confidence.LOW


def _match_value(value: str, keyword: str) -> Optional[FilterDetection]:
    conf = _keyword_confidence(keyword)
    for filt, rx in _FILTER_MATCHERS:
        if rx.search(value):
            return FilterDetection(filt, filter_to_hubble_channel(filt),
                                   conf, keyword, value)
    return None


def classify_wavelength_nm(nm: float) -> Optional[NarrowbandFilter]:
    """header_discovery.rs:258-272 (Angstrom auto-conversion >1000)."""
    if nm > 1000.0:
        nm = nm / 10.0
    if 649.0 <= nm <= 663.0:
        return NarrowbandFilter.HA
    if 495.0 <= nm <= 510.0:
        return NarrowbandFilter.OIII
    if 666.0 <= nm <= 680.0:
        return NarrowbandFilter.SII
    return None


def detect_filter(header: HduHeader) -> Optional[FilterDetection]:
    """header_discovery.rs:229-256 detection chain."""
    for keyword in DISCOVERY_KEYWORDS:
        value = header.get(keyword)
        if value is None:
            continue
        det = _match_value(value, keyword)
        if det is not None:
            return det
    for keyword, value in header.cards:
        ku = keyword.upper()
        if "FILT" in ku or "BAND" in ku or "LINE" in ku:
            det = _match_value(value, keyword)
            if det is not None:
                return det
    wavelength = (header.get_f64("WAVELEN") or header.get_f64("CRVAL3") or
                  header.get_f64("WAVELENG"))
    if wavelength is None:
        return None
    filt = classify_wavelength_nm(wavelength)
    if filt is None:
        return None
    return FilterDetection(filt, filter_to_hubble_channel(filt),
                           Confidence.MEDIUM, "WAVELEN",
                           f"{wavelength:.1f}nm")


def detect_from_filename(file_name: str) -> Optional[FilterDetection]:
    upper = file_name.upper()
    for filt, patterns in FILENAME_PATTERNS:
        for pat in patterns:
            if pat in upper:
                return FilterDetection(filt, filter_to_hubble_channel(filt),
                                       Confidence.LOW, "FILENAME", file_name)
    return None


def suggest_palette_with_type(files: Sequence[Tuple[str, HduHeader]],
                              palette: PaletteType) -> PaletteSuggestion:
    """header_discovery.rs:275-380 with higher-confidence replacement."""
    def suggestion_for(path, header):
        file_name = os.path.basename(path) or path
        det = detect_filter(header) or detect_from_filename(file_name)
        return ChannelSuggestion(path, file_name, det)

    if palette == PaletteType.CUSTOM:
        return PaletteSuggestion(
            None, None, None,
            [suggestion_for(p, h) for p, h in files], False,
            palette.display_name)

    slots: Dict[HubbleChannel, Optional[Tuple[Confidence,
                                              ChannelSuggestion]]] = {
        HubbleChannel.RED: None, HubbleChannel.GREEN: None,
        HubbleChannel.BLUE: None}
    unmapped: List[ChannelSuggestion] = []

    def try_assign(channel, conf, suggestion):
        cur = slots[channel]
        if cur is None or conf < cur[0]:
            if cur is not None:
                unmapped.append(cur[1])
            slots[channel] = (conf, suggestion)
            return True
        return False

    for path, header in files:
        sug = suggestion_for(path, header)
        det = sug.detection
        if det is None:
            unmapped.append(sug)
            continue
        channels = palette_channels(palette, det.filter)
        if not channels:
            unmapped.append(sug)
            continue
        assigned = False
        for ch in channels:
            if try_assign(ch, det.confidence, sug):
                assigned = True
        if not assigned:
            unmapped.append(sug)

    r = slots[HubbleChannel.RED]
    g = slots[HubbleChannel.GREEN]
    b = slots[HubbleChannel.BLUE]
    return PaletteSuggestion(
        r_file=r[1] if r else None,
        g_file=g[1] if g else None,
        b_file=b[1] if b else None,
        unmapped=unmapped,
        is_complete=all(s is not None for s in (r, g, b)),
        palette_name=palette.display_name)


def suggest_palette(files: Sequence[Tuple[str, HduHeader]]) -> PaletteSuggestion:
    return suggest_palette_with_type(files, PaletteType.SHO)
