"""Cube commands (counterpart of astroburst_tpu/api/cube.py; reference:
src-tauri/src/cmd/cube.rs).

``process_cube_cmd`` puts the whole cube on the device
(``io/prefetch.load_cube``) and takes its global stats and collapses
there; the lazy commands read frames from a memory map
(``cube/lazy.LazyCube``), kept open per path in a process-wide cache
under a lock. Previews are normalized and quantized to u8 on the
device (``_norm_u8``); the sampled frames are then fetched and
PNG-encoded on a pool of 4 threads, so the host encodes overlap.

Each command resolves ``device`` first (``cuda_device()`` when None,
which raises where there is no card), also the host-only
``get_cube_info`` and ``get_cube_spectrum``.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from typing import Dict, Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api.common import Timer
from astroburst_tpu_torch.cube import (GlobalCubeStats, LazyCube,
                                       build_wavelength_axis,
                                       classify_spectral_cube, collapse_mean,
                                       collapse_median, compute_global_stats,
                                       normalize_with_global)
from astroburst_tpu_torch.io.dispatcher import resolve_single_image
from astroburst_tpu_torch.io.png import save_gray_png
from astroburst_tpu_torch.io.prefetch import load_cube
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir

# open lazy cubes keyed by path (the reference holds them app-side)
_LAZY_LOCK = threading.Lock()
_LAZY_CUBES: Dict[str, LazyCube] = {}


def _get_lazy(path: str) -> LazyCube:
    resolved = resolve_single_image(path)
    with _LAZY_LOCK:
        cube = _LAZY_CUBES.get(resolved)
        if cube is None:
            cube = LazyCube(resolved)
            _LAZY_CUBES[resolved] = cube
        return cube


def _norm_u8(plane: torch.Tensor, g: GlobalCubeStats) -> torch.Tensor:
    """Global asinh normalize, then min/max scaled to u8 (truncating),
    on the plane's device."""
    norm = normalize_with_global(plane, g)
    mn = norm.min()
    rng = torch.clamp(norm.max() - mn, min=1e-10)
    return torch.clamp((norm - mn) * (255.0 / rng), 0, 255).to(torch.uint8)


def _save_norm_png(plane: torch.Tensor, g: GlobalCubeStats,
                   path: str) -> None:
    save_gray_png(_norm_u8(plane, g).cpu().numpy(), path)


def _save_pngs_pipelined(u8_frames, paths, workers: int = 4) -> None:
    """Fetch + PNG-encode u8 device frames on a thread pool: the
    encodes overlap (the reference renders sampled cube frames
    serially, cmd/cube.rs:15)."""
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(lambda u, p: save_gray_png(u.cpu().numpy(), p),
                            u8, path)
                for u8, path in zip(u8_frames, paths)]
        for f in futs:
            f.result()


def _collapsed_paths(path: str, out_dir: str):
    stem = os.path.splitext(os.path.basename(path))[0]
    return (stem, os.path.join(out_dir, f"{stem}_collapsed.png"),
            os.path.join(out_dir, f"{stem}_collapsed_median.png"))


def _save_frames(frames_of, depth: int, frame_step: Optional[int],
                 g: GlobalCubeStats, frames_dir: str) -> int:
    """The sampled frames (every max(depth // 16, 1)-th unless
    ``frame_step``) as frame_NNNN.png; returns their count."""
    os.makedirs(frames_dir, exist_ok=True)
    step = max(frame_step or max(depth // 16, 1), 1)
    zs = list(range(0, depth, step))
    u8s = [_norm_u8(frames_of(z), g) for z in zs]
    _save_pngs_pipelined(u8s, [os.path.join(frames_dir, f"frame_{i:04}.png")
                               for i in range(len(zs))])
    return len(zs)


def process_cube_cmd(path: str, output_dir: str = "",
                     frame_step: Optional[int] = None, *,
                     device: Optional[torch.device] = None) -> dict:
    """Eager cube: collapses, spectrum, sampled frames (cmd/cube.rs:15)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    header, cube = load_cube(resolve_single_image(path), device)
    depth, rows, cols = cube.shape

    g = compute_global_stats(cube)
    mean_img = collapse_mean(cube)
    median_img = collapse_median(cube)
    stem, collapsed_path, collapsed_median_path = _collapsed_paths(
        path, out_dir)
    _save_norm_png(mean_img, g, collapsed_path)
    _save_norm_png(median_img, g, collapsed_median_path)
    frames_dir = os.path.join(out_dir, f"{stem}_frames")
    count = _save_frames(lambda z: cube[z], depth, frame_step, g, frames_dir)

    spectrum = cube[:, rows // 2, cols // 2].cpu().tolist()
    classification = classify_spectral_cube(header, depth)
    return {
        C.RES_DIMENSIONS: [cols, rows, depth],
        "collapsed_path": collapsed_path,
        "collapsed_median_path": collapsed_median_path,
        "frames_dir": frames_dir,
        C.RES_FRAME_COUNT: count,
        "center_spectrum": spectrum,
        C.RES_WAVELENGTHS: build_wavelength_axis(header),
        C.RES_SPECTRAL_CLASSIFICATION: classification.to_dict(),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def process_cube_lazy_cmd(path: str, output_dir: str = "",
                          frame_step: Optional[int] = None, *,
                          device: Optional[torch.device] = None) -> dict:
    """Lazy mmap cube (cmd/cube.rs:27): a 2 GB cube opens without being
    read; the mean collapse streams it on the host, the median samples
    at most 256 frames on the device."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    cube = _get_lazy(path)
    g0 = cube.geometry
    mean_img = torch.from_numpy(cube.collapse_mean()).to(device)
    median_img = cube.collapse_median(device=device)
    g = compute_global_stats(mean_img)
    stem, collapsed_path, collapsed_median_path = _collapsed_paths(
        path, out_dir)
    _save_norm_png(mean_img, g, collapsed_path)
    _save_norm_png(median_img, g, collapsed_median_path)
    frames_dir = os.path.join(out_dir, f"{stem}_frames")
    count = _save_frames(
        lambda z: torch.from_numpy(cube.get_frame(z)).to(device),
        g0.naxis3, frame_step, g, frames_dir)

    spectrum = cube.spectrum(g0.naxis2 // 2, g0.naxis1 // 2)
    classification = classify_spectral_cube(cube.header, g0.naxis3)
    return {
        C.RES_DIMENSIONS: [g0.naxis1, g0.naxis2, g0.naxis3],
        "collapsed_path": collapsed_path,
        "collapsed_median_path": collapsed_median_path,
        "frames_dir": frames_dir,
        C.RES_FRAME_COUNT: count,
        "total_frames": g0.naxis3,
        "center_spectrum": [float(v) for v in spectrum],
        C.RES_WAVELENGTHS: build_wavelength_axis(cube.header),
        C.RES_SPECTRAL_CLASSIFICATION: classification.to_dict(),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def get_cube_info(path: str, *,
                  device: Optional[torch.device] = None) -> dict:
    """cmd/cube.rs:39 — geometry, classification and wavelengths from
    the header alone."""
    t0 = Timer()
    device_or_cuda(device)
    cube = _get_lazy(path)
    g = cube.geometry
    classification = classify_spectral_cube(cube.header, g.naxis3)
    return {
        C.RES_NAXIS1: g.naxis1,
        C.RES_NAXIS2: g.naxis2,
        C.RES_NAXIS3: g.naxis3,
        C.RES_BITPIX: g.bitpix,
        C.RES_SPECTRAL_CLASSIFICATION: classification.to_dict(),
        C.RES_WAVELENGTHS: build_wavelength_axis(cube.header),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def get_cube_frame(path: str, frame_index: int, output_dir: str = "", *,
                   device: Optional[torch.device] = None) -> dict:
    """cmd/cube.rs:63 — one frame, normalized by its own stats."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    cube = _get_lazy(path)
    frame = torch.from_numpy(cube.get_frame(frame_index)).to(device)
    g = compute_global_stats(frame)
    stem = os.path.splitext(os.path.basename(path))[0]
    png_path = os.path.join(out_dir, f"{stem}_frame_{frame_index:04}.png")
    _save_norm_png(frame, g, png_path)
    return {
        C.RES_FRAME_INDEX: frame_index,
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [cube.geometry.naxis1, cube.geometry.naxis2],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def get_cube_spectrum(path: str, x: int, y: int, *,
                      device: Optional[torch.device] = None) -> dict:
    """cmd/cube.rs:88 — one pixel's spectrum by strided reads."""
    t0 = Timer()
    device_or_cuda(device)
    cube = _get_lazy(path)
    spectrum = cube.spectrum(int(y), int(x))
    return {
        C.RES_X: x,
        C.RES_Y: y,
        C.RES_SPECTRUM: [float(v) for v in spectrum],
        C.RES_WAVELENGTHS: build_wavelength_axis(cube.header),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
