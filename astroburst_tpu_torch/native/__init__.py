"""The host FITS codec (C++/OpenMP, ``astro_io.cpp``): the port's
counterpart of astroburst_tpu/native.

Every FITS decode of the port (``io/fits_reader.decode_pixels``) and
every BITPIX 16 and -32 write (``io/fits_writer``) runs here. The
library is built with g++ at first use, never at import, into
``build/astroburst_tpu_torch/native-<hash>/libastro_io.so`` at the root
of the checkout (``build/`` is git-ignored). The hash covers the
source, the flags and the host's CPU (``-march=native`` builds code
that another CPU may not run). Concurrent builders each compile to a
name of their own and ``os.replace`` it into place. A failed build or
load raises with the compiler's log: nothing falls back to numpy.

Each call takes its OpenMP thread count (``threads``, default every
core this process may run on). The library links ``libgomp.so.1``; in
a process that has loaded torch first, the dynamic loader hands it
torch's copy of that runtime (``openmp_runtimes`` lists what is mapped).

    g++ -O3 -march=native -fopenmp -fPIC -shared -std=c++17
        -ffp-contract=off -o libastro_io.so astro_io.cpp
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from astroburst_tpu_torch.runtime import kernels as _kernels

SOURCE = Path(__file__).resolve().with_name("astro_io.cpp")
FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
         "-std=c++17", "-ffp-contract=off")
BUILD_TIMEOUT_S = 300

_BYTES_PER_PIXEL = {8: 1, 16: 2, 32: 4, -32: 4, -64: 8}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_D = ctypes.c_double

# C entry point → (restype, argtypes)
SIGNATURES = {
    # src, dst, n, bitpix, bscale, bzero, threads
    "astro_decode_pixels": (_I, (_P, _P, _I64, _I, _D, _D, _I)),
    # src, n, bitpix, bzero, bscale, fd, threads
    "astro_encode_be_to_fd": (_I, (_P, _I64, _I, _D, _D, _I, _I)),
    "astro_openmp_version": (_I, ()),
}


@dataclass(frozen=True)
class Codec:
    lib: ctypes.CDLL
    path: Path
    build_log: str        # the command and the compiler's output
    build_seconds: float  # 0.0 when the library was already built


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the FITS codec of "
                           "astroburst_tpu_torch cannot be built")
    return found


def cpu_model() -> str:
    """The first CPU's model name and feature flags from /proc/cpuinfo
    (what ``-march=native`` reads)."""
    keys = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if key in ("model name", "flags") and key not in keys:
                keys[key] = value.strip()
    return f"{keys.get('model name', '')}\n{keys.get('flags', '')}"


def build_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(cpu_model().encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return _kernels.BUILD_ROOT / f"native-{build_hash()}"


def _build() -> Tuple[Path, str, float]:
    out_dir = build_dir()
    lib_path = out_dir / "libastro_io.so"
    log_path = out_dir / "build.log"
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return lib_path, log, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".tmp.{os.getpid()}.{threading.get_ident()}"
    tmp = out_dir / f"{tag}.so"
    cmd = [compiler(), *FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ timed out after {BUILD_TIMEOUT_S} s:\n"
                           f"{' '.join(cmd)}\n{e.stdout or ''}"
                           f"{e.stderr or ''}") from e
    seconds = time.perf_counter() - t0
    log = f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the FITS codec did not build (g++ rc "
                           f"{res.returncode}):\n{log}")
    log_tmp = out_dir / f"{tag}.log"
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)
    os.replace(tmp, lib_path)
    return lib_path, log, seconds


_LOCK = threading.Lock()


@functools.cache
def _library() -> Codec:
    path, log, seconds = _build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"the FITS codec {path} did not load ({e}); "
                           f"its build:\n{log}") from e
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return Codec(lib, path, log, seconds)


def library() -> Codec:
    """Build (once per hash) and load the codec."""
    with _LOCK:   # one build per process, whichever thread comes first
        return _library()


def default_threads() -> int:
    """Every core this process may run on."""
    return len(os.sched_getaffinity(0))


def _threads(threads: Optional[int]) -> int:
    t = default_threads() if threads is None else int(threads)
    if t < 1:
        raise ValueError(f"threads must be >= 1, got {threads}")
    return t


def checked_target(out: np.ndarray, n: int) -> np.ndarray:
    """``out`` when it is a writable C-contiguous f32 array of ``n``
    elements, else ValueError."""
    if (out.dtype != np.float32 or not out.flags.c_contiguous
            or not out.flags.writeable or out.size != n):
        raise ValueError(f"decode target must be a writable C-contiguous "
                         f"f32 array of {n} elements")
    return out


def _source(data) -> np.ndarray:
    return np.ascontiguousarray(data, np.float32).reshape(-1)


def decode_pixels_native(raw, bitpix: int, bscale: float, bzero: float,
                         out: Optional[np.ndarray] = None,
                         threads: Optional[int] = None) -> np.ndarray:
    """Big-endian FITS data bytes (any bytes-like object, at any byte
    offset) decoded to f32, into ``out`` when it is given (a writable
    C-contiguous f32 array of as many elements as whole pixels in
    ``raw``). Returns ``out`` (a new 1-D array when it is None)."""
    bpp = _BYTES_PER_PIXEL.get(bitpix)
    if bpp is None:
        raise ValueError(f"Unsupported BITPIX {bitpix}")
    buf = np.frombuffer(raw, np.uint8)
    n = buf.size // bpp
    out = np.empty(n, np.float32) if out is None else checked_target(out, n)
    rc = library().lib.astro_decode_pixels(
        buf.ctypes.data, out.ctypes.data, n, bitpix, float(bscale),
        float(bzero), _threads(threads))
    if rc != 0:
        raise RuntimeError(f"astro_decode_pixels returned {rc}")
    return out


def encode_be_to_fd(data, fd: int, bitpix: int, bzero: float,
                    bscale: float, threads: Optional[int] = None) -> None:
    """Encode ``data`` at BITPIX 16 or -32 and write it to the open file
    descriptor ``fd`` in 4 MB chunks (the source crosses memory once);
    OSError when a write fails."""
    if bitpix not in (16, -32):
        raise ValueError(f"encode_be_to_fd: BITPIX 16 or -32, got {bitpix}")
    flat = _source(data)
    rc = library().lib.astro_encode_be_to_fd(
        flat.ctypes.data, flat.size, bitpix, float(bzero), float(bscale),
        fd, _threads(threads))
    if rc != 0:
        raise OSError(rc, os.strerror(rc))


def openmp_runtimes() -> list:
    """Paths of the OpenMP runtimes mapped into this process."""
    seen = []
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            name = os.path.basename(path)
            if name.startswith(("libgomp", "libiomp", "libomp")) \
                    and path not in seen:
                seen.append(path)
    return seen
