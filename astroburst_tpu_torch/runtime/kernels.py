"""Build, load and launch the hand-written CUDA kernels.

Every ``astroburst_tpu_torch/csrc/*.cu`` file is compiled with nvcc
into an object, one nvcc process per source, all started together; the
objects are linked into ONE shared library with a plain C interface,
loaded with ctypes. No source includes PyTorch's headers: a plain C
file builds in seconds, one that includes them in minutes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu  (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

The library lands in ``build/astroburst_tpu_torch/<hash>/`` at the
root of the checkout (``build/`` is git-ignored), keyed by a hash of
the sources and flags, and is built at first use — never at import,
since the CPU tests import every module on machines without nvcc.

Calling convention of every C entry point: pointers and the CUDA
stream are ``void*`` (``ctypes.c_void_p``; a Python int passed as a
plain int would be cut to 32 bits), sizes are ``int`` (``long long``
for an element count that may pass 2^31), and the return value is
``cudaGetLastError()`` right after the launch. ``launch`` raises when it
is not 0. Kernels run on PyTorch's current stream and
nothing here synchronises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "astroburst_tpu_torch"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry point → argtypes (restype is int: the cudaError_t code)
SIGNATURES = {
    # stack, dys, dxs, n, h, w, sigma_low, sigma_high, max_iter, cap, by,
    # y0, rows, out_off, grow0, gh, scratch, out, rejected, stream
    "abt_shift_clip": (_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P, _P, _P, _P),
    # stack, n, h, w, by, bx, ds_r, ds_c, scale, with_stats,
    # out, part_min, part_max, part_cnt, stream
    "abt_coarse_box": (_P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                       _P, _P, _P, _P, _P),
    # stack, y0s, x0s (int64), n_out, h, w, size_r, size_c, frame0, out,
    # stream
    "abt_gather_crops": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # cand_v, wys_t, wxs, n, taps_y, taps_x, h, w, cap, sigma_low,
    # sigma_high, iterations, scratch, img, wgt, rej, stream
    "abt_drizzle_finalize_fused": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                   _F, _I, _P, _P, _P, _P, _P),
    # cand_v, cand_w, m, h, w, cap, sigma_low, sigma_high, iterations,
    # scratch, img, wgt, rej, stream
    "abt_drizzle_finalize": (_P, _P, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P,
                             _P, _P),
    # stack, sy, sx, wys_t, wxs, n, taps, s, in_h, in_w, cap, sigma_low,
    # sigma_high, iterations, scratch, img, wgt, rej, stream
    "abt_drizzle_gather": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _F, _I, _P, _P, _P, _P, _P),
    # stack, iy, wys_t, ix, wxs, n, taps, in_h, in_w, h, w, cap,
    # sigma_low, sigma_high, iterations, scratch, img, wgt, rej, stream
    "abt_drizzle_gather_banded": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _I, _P, _P, _P, _P, _P),
    # xs, ys, radii, k, softness, h, w, out, stream
    "abt_star_mask": (_P, _P, _P, _I, _F, _I, _I, _P, _P),
    # plane, ty, tx, step, csize, threads, out, counts, stream
    "abt_tile_sort": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    # plane, ty, tx, step, chunk, n_chunks, scratch, out, counts, stream
    "abt_tile_sort_chunked": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # image, h, w, pys, pxs, k, n_valid, threshold, bg_med (the 0-d
    # tensors' own storage), out, stream
    "abt_window_stats": (_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P),
    # ref_ratios, ref_verts, t_ref, tgt_ratios, tgt_verts, t_tgt, tol,
    # grid, scratch, votes, stream
    "abt_triangle_vote": (_P, _P, _I, _P, _P, _I, _F, _I, _P, _P, _P),
    # packed, k, out_xy, out_n, stream
    "abt_dedupe_topk": (_P, _I, _P, _P, _P),
    # votes, min_votes, ris, tis, count, stream
    "abt_greedy_match": (_P, _I, _P, _P, _P, _P),
    # x, n, workspace, stream
    "abt_radix_count": (_P, _L, _P, _P),
    # x, n, ks (int64), workspace, out (f64), stream
    "abt_radix_select": (_P, _L, _P, _P, _P, _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_log: str        # nvcc/ptxas output (-Xptxas -v)
    build_seconds: float  # 0.0 when the library was already built


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels of astroburst_tpu_torch cannot be "
                           "built")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build() -> tuple[Path, str, float]:
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libastroburst_kernels.so"
    log_path = out_dir / "build.log"
    if lib_path.is_file() and log_path.is_file():
        return lib_path, log_path.read_text(), 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".tmp.{os.getpid()}"
    cu = [p for p in sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{tag}.{p.stem}.o" for p in cu]
    t0 = time.perf_counter()
    jobs = []
    for src, obj in zip(cu, objs):  # one nvcc per source, in parallel
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    tmp = out_dir / f"{tag}.so"
    if not failed:
        cmd = [nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"nvcc link failed (rc {res.returncode}):\n"
                          f"{' '.join(cmd)}\n{logs[-1]}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, log, seconds


@functools.cache
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    path, log, seconds = _build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.abt_error_string.argtypes = [ctypes.c_int]
    lib.abt_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, log, seconds)


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call C entry ``name``; raise on a non-zero cudaError_t."""
    lib = library().lib
    status = getattr(lib, name)(*args)
    if status != 0:
        msg = lib.abt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def ptr(t) -> int:
    """A tensor's data pointer, or 0 (NULL) for an absent buffer."""
    return 0 if t is None else t.data_ptr()


def require_cuda(t: torch.Tensor, name: str, ndim: int,
                 dtype: torch.dtype = torch.float32) -> None:
    """Validate a kernel input (of ``dtype``, f32 by default) before its
    pointer goes to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_PLAIN = False   # inside plain_versions()


@contextlib.contextmanager
def plain_versions():
    """Within this block every kernel wrapper runs its plain torch
    version, on a CUDA tensor too. Process-wide; blocks nest, and each
    restores the state it found, also on an exception."""
    global _PLAIN
    was, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = was


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); raise for any other device. Inside
    ``plain_versions()`` a CUDA tensor runs the plain version too: the
    switch exists for the tests and the card checks (chip_smoke.py),
    which hold each kernel to its plain version on the same inputs."""
    if t.is_cuda:
        return not _PLAIN
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
