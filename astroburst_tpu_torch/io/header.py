"""FITS header model (its own copy of astroburst_tpu/io/header.py;
reference: src-tauri/src/types/header.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from astroburst_tpu_torch.constants import BLOCK_SIZE

_MERGE_SKIP_KEYS = frozenset({"SIMPLE", "XTENSION", "EXTEND", "PCOUNT", "GCOUNT"})


def extract_header_value(raw: str) -> str:
    """Parse the value field of a FITS card: quoted strings keep inner
    content; otherwise strip an inline '/' comment (header.rs semantics)."""
    trimmed = raw.strip()
    if trimmed.startswith("'"):
        end = trimmed.find("'", 1)
        if end != -1:
            return trimmed[1:end].rstrip()
    slash = trimmed.find("/")
    if slash != -1:
        return trimmed[:slash].strip()
    return trimmed


class HduHeader:
    """Ordered card list + key index, like the reference's HduHeader."""

    __slots__ = ("cards", "index")

    def __init__(self, cards: Optional[List[Tuple[str, str]]] = None):
        self.cards: List[Tuple[str, str]] = list(cards) if cards else []
        self.index: Dict[str, str] = dict(self.cards)

    def get(self, key: str) -> Optional[str]:
        return self.index.get(key)

    def get_i64(self, key: str) -> Optional[int]:
        v = self.index.get(key)
        if v is None:
            return None
        try:
            return int(v.strip())
        except ValueError:
            try:
                return int(float(v.strip()))
            except ValueError:
                return None

    def get_f64(self, key: str) -> Optional[float]:
        v = self.index.get(key)
        if v is None:
            return None
        # FITS allows 'D' exponents in floats
        try:
            return float(v.strip().replace("D", "E").replace("d", "e"))
        except ValueError:
            return None

    def set(self, key: str, value: str) -> None:
        for i, (k, _) in enumerate(self.cards):
            if k == key:
                self.cards[i] = (key, value)
                break
        else:
            self.cards.append((key, value))
        self.index[key] = value

    def set_f64(self, key: str, value: float) -> None:
        self.set(key, f"{value:.14E}")

    def remove(self, key: str) -> None:
        self.cards = [(k, v) for k, v in self.cards if k != key]
        self.index.pop(key, None)

    def data_byte_count(self) -> int:
        naxis = self.get_i64("NAXIS") or 0
        if naxis == 0:
            return 0
        bitpix = self.get_i64("BITPIX") or 0
        bpp = abs(bitpix) // 8
        total = 1
        for i in range(1, naxis + 1):
            total *= self.get_i64(f"NAXIS{i}") or 1
        return total * bpp

    def padded_data_bytes(self) -> int:
        raw = self.data_byte_count()
        return ((raw + BLOCK_SIZE - 1) // BLOCK_SIZE) * BLOCK_SIZE

    def merge_with(self, extension: "HduHeader") -> "HduHeader":
        """Primary ⊕ extension merge: extension cards win; structural
        keys skipped (header.rs:67)."""
        merged = HduHeader()
        seen = set()
        for k, v in extension.cards:
            if k.upper() in _MERGE_SKIP_KEYS:
                continue
            merged.cards.append((k, v))
            merged.index[k] = v
            seen.add(k)
        for k, v in self.cards:
            if k.upper() in _MERGE_SKIP_KEYS or k in seen:
                continue
            merged.cards.append((k, v))
            if k not in merged.index:
                merged.index[k] = v
        return merged

    def copy(self) -> "HduHeader":
        return HduHeader(self.cards)

    def to_dict(self) -> dict:
        return {"cards": [list(c) for c in self.cards], "index": dict(self.index)}

    def __len__(self) -> int:
        return len(self.cards)

    def __contains__(self, key: str) -> bool:
        return key in self.index


@dataclass
class HduInfo:
    """Summary of one HDU (reader.rs HduInfo)."""

    index: int
    extname: Optional[str]
    extver: Optional[int]
    naxis: int
    naxis1: int
    naxis2: int
    naxis3: int
    bitpix: int
    has_data: bool
    header_start: int = 0
    data_start: int = 0

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "extname": self.extname,
            "extver": self.extver,
            "naxis": self.naxis,
            "naxis1": self.naxis1,
            "naxis2": self.naxis2,
            "naxis3": self.naxis3,
            "bitpix": self.bitpix,
            "has_data": self.has_data,
        }
