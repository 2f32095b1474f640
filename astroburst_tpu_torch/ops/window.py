"""Window functions (reference: src-tauri/src/math/window.rs; the port's
own copy of astroburst_tpu/ops/window.py:hann_periodic).

Generated on the host in f64 and returned as f32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def hann_periodic(n: int) -> np.ndarray:
    """0.5·(1 − cos(2πi/n)) (window.rs:3-18)."""
    if n == 0:
        return np.zeros(0, np.float32)
    if n == 1:
        return np.ones(1, np.float32)
    i = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)
