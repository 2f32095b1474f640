"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def rate(amounts, window_s: float) -> float:
    """All the work completed in the window over the window's length."""
    if window_s <= 0:
        raise ValueError(f"window of {window_s} s")
    return math.fsum(amounts) / window_s

