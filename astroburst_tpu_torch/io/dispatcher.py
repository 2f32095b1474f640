"""Input resolution: directory → sorted list, ZIP → tempdir, single file
(its own copy of astroburst_tpu/io/dispatcher.py).

Reference: src-tauri/src/infra/fits/dispatcher.rs:28-60 (ZIP
transparency: a .zip input is extracted to a temp dir and its first
image used; a directory yields its sorted FITS/ASDF members).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import zipfile
from typing import List

from astroburst_tpu_torch.errors import InvalidInput

_FITS_EXTS = (".fits", ".fit", ".fts")
_ASDF_EXTS = (".asdf",)

_TEMPDIRS: List[str] = []


def _cleanup_tempdirs() -> None:
    for d in _TEMPDIRS:
        shutil.rmtree(d, ignore_errors=True)
    _TEMPDIRS.clear()


atexit.register(_cleanup_tempdirs)


def is_fits_path(path: str) -> bool:
    return path.lower().endswith(_FITS_EXTS)


def is_asdf_path(path: str) -> bool:
    return path.lower().endswith(_ASDF_EXTS)


def _extract_zip(path: str) -> str:
    tmp = tempfile.mkdtemp(prefix="astroburst_zip_")
    _TEMPDIRS.append(tmp)
    with zipfile.ZipFile(path) as zf:
        for member in zf.infolist():
            # guard against path traversal
            target = os.path.realpath(os.path.join(tmp, member.filename))
            if not target.startswith(os.path.realpath(tmp) + os.sep):
                continue
            if member.is_dir():
                os.makedirs(target, exist_ok=True)
            else:
                os.makedirs(os.path.dirname(target), exist_ok=True)
                with zf.open(member) as src, open(target, "wb") as dst:
                    shutil.copyfileobj(src, dst)
    return tmp


def _sorted_images_in_dir(directory: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(directory):
        for name in files:
            if is_fits_path(name) or is_asdf_path(name):
                out.append(os.path.join(root, name))
    out.sort()
    return out


def resolve_inputs(path: str) -> List[str]:
    """Resolve a path to a sorted list of image files."""
    if os.path.isdir(path):
        files = _sorted_images_in_dir(path)
        if not files:
            raise InvalidInput(f"No FITS/ASDF files found in directory {path}")
        return files
    if path.lower().endswith(".zip"):
        tmp = _extract_zip(path)
        files = _sorted_images_in_dir(tmp)
        if not files:
            raise InvalidInput(f"No FITS/ASDF files found in ZIP {path}")
        return files
    if not os.path.exists(path):
        raise InvalidInput(f"Input path does not exist: {path}")
    return [path]


def resolve_single_image(path: str) -> str:
    """Resolve to exactly one image file (dispatcher.rs:50)."""
    return resolve_inputs(path)[0]
