"""Stability-reference white balance (counterpart of
astroburst_tpu/compose/white_balance.py; reference:
src-tauri/src/core/compose/white_balance.rs).

The reference channel is the one with the lowest MAD/median (the most
stable); the factors are ref_median / channel_median. Host scalar math
over ImageStats, in f64.
"""

from __future__ import annotations

from typing import Tuple

from astroburst_tpu_torch.dtypes import ImageStats


def _stability(s: ImageStats) -> float:
    return s.mad / s.median if s.median > 1e-10 else float("inf")


def select_wb_reference(sr: ImageStats, sg: ImageStats,
                        sb: ImageStats) -> Tuple[float, float, float]:
    """(r_factor, g_factor, b_factor) (white_balance.rs:3-20)."""
    stab_r, stab_g, stab_b = _stability(sr), _stability(sg), _stability(sb)
    if stab_r <= stab_g and stab_r <= stab_b:
        m = max(sr.median, 1e-10)
        return (1.0, m / max(sg.median, 1e-10), m / max(sb.median, 1e-10))
    if stab_b <= stab_g:
        m = max(sb.median, 1e-10)
        return (m / max(sr.median, 1e-10), m / max(sg.median, 1e-10), 1.0)
    m = max(sg.median, 1e-10)
    return (m / max(sr.median, 1e-10), 1.0, m / max(sb.median, 1e-10))
