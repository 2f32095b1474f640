"""Output directory resolution (its own copy of the first half of
astroburst_tpu/runtime/output.py).

Reference: src-tauri/src/cmd/common.rs:273-313 (permission fallback to
the platform data dir under ``ASTROBURST_DATA_DIR``).
"""

from __future__ import annotations

import os
import tempfile


def default_output_dir() -> str:
    base = os.environ.get("ASTROBURST_DATA_DIR")
    if base:
        return os.path.join(base, "output")
    xdg = os.environ.get("XDG_DATA_HOME",
                         os.path.expanduser("~/.local/share"))
    return os.path.join(xdg, "astroburst", "output")


def resolve_output_dir(requested: str) -> str:
    """Use the requested dir if writable, else fall back to the data dir."""
    candidates = [requested] if requested else []
    candidates.append(default_output_dir())
    for cand in candidates:
        try:
            os.makedirs(cand, exist_ok=True)
            probe = tempfile.NamedTemporaryFile(dir=cand, delete=True)
            probe.close()
            return cand
        except OSError:
            continue
    raise OSError("no writable output directory available")
