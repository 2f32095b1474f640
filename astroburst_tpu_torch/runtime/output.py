"""Output directory resolution and size-capped LRU cleanup (its own copy
of astroburst_tpu/runtime/output.py).

Reference: src-tauri/src/cmd/common.rs:273-313 (permission fallback to
the platform data dir under ``ASTROBURST_DATA_DIR``) and
src-tauri/src/cmd/output.rs (enforce_output_lru with
DEFAULT_OUTPUT_MAX_BYTES).
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Tuple

from astroburst_tpu_torch.constants import DEFAULT_OUTPUT_MAX_BYTES


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


def _dir_files(directory: str) -> List[Tuple[str, float, int]]:
    out = []
    for root, _dirs, files in os.walk(directory):
        for name in files:
            p = os.path.join(root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((p, st.st_mtime, st.st_size))
    return out


def output_dir_info(directory: str) -> dict:
    files = _dir_files(directory)
    return {
        "output_dir": directory,
        "file_count": len(files),
        "total_size": sum(f[2] for f in files),
    }


def enforce_output_lru(directory: str,
                       max_bytes: int = DEFAULT_OUTPUT_MAX_BYTES) -> dict:
    """Delete oldest files until the directory fits max_bytes."""
    files = sorted(_dir_files(directory), key=lambda f: f[1])
    total = sum(f[2] for f in files)
    cleaned_bytes = 0
    cleaned_files = 0
    i = 0
    while total > max_bytes and i < len(files):
        path, _mtime, size = files[i]
        try:
            os.remove(path)
            total -= size
            cleaned_bytes += size
            cleaned_files += 1
        except OSError:
            pass
        i += 1
    return {"cleaned_bytes": cleaned_bytes, "cleaned_files": cleaned_files}


def cleanup_output(directory: str) -> dict:
    """Remove all files in the output dir."""
    files = _dir_files(directory)
    cleaned_bytes = 0
    cleaned_files = 0
    for path, _m, size in files:
        try:
            os.remove(path)
            cleaned_bytes += size
            cleaned_files += 1
        except OSError:
            pass
    return {"cleaned_bytes": cleaned_bytes, "cleaned_files": cleaned_files}
