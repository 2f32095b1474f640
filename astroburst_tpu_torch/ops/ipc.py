"""Binary pixel protocol for raw previews (counterpart of
astroburst_tpu/ops/ipc.py).

Reference: src-tauri/src/infra/ipc.rs — 16-byte header
[w: u32, h: u32, min: f32, max: f32] little-endian, then raw f32
pixels; NaN/inf scrubbed to 0; nearest-neighbour downsample to a max
dimension (ipc.rs:105-147). The downsample, the scan and the scrub run
on the plane's device, and one fetch brings the plane and both
scalars to the host.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


def _index_map(src: int, dst: int, device) -> torch.Tensor:
    """floor(d · src/dst) for d < dst, at most src - 1. The product is
    taken in f32 on a tensor, as the JAX package takes it (an int32
    arange times a weakly typed Python float): in f64 the map picks
    another source row at one of 4096 rows of a 5655-row plane."""
    d = torch.arange(dst, dtype=torch.int32, device=device)
    return torch.clamp((d * (src / dst)).to(torch.int32), max=src - 1)


def nearest_downsample(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    """Nearest-neighbour downsample of [H, W] to fit max_dim: dst dims
    are round(src · max_dim / max(h, w)), source index floor(d · src /
    dst) (ipc.rs:105-147). Planes that fit are returned as they are."""
    h, w = x.shape
    if h <= max_dim and w <= max_dim:
        return x
    scale = max_dim / max(h, w)
    dst_h = max(int(round(h * scale)), 1)
    dst_w = max(int(round(w * scale)), 1)
    rows = _index_map(h, dst_h, x.device)
    cols = _index_map(w, dst_w, x.device)
    return x.index_select(0, rows).index_select(1, cols)


def _scrub_and_scan(x: torch.Tensor):
    """(x with non-finite pixels set to 0, min, max) of the finite
    pixels — padding zeros count, unlike ``validity_mask`` — with 0 for
    a plane that has none; the scalars as 0-d tensors on x's device."""
    finite = torch.isfinite(x)
    zero = torch.zeros_like(x)
    inf = torch.full_like(x, float("inf"))
    clean = torch.where(finite, x, zero)
    mn = torch.where(finite, x, inf).min()
    mx = torch.where(finite, x, -inf).max()
    mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    return clean, mn, mx


def encode_with_header_views(x: torch.Tensor, max_dim: int):
    """(header bytes, pixel memoryview) — the pixel payload is a
    zero-copy view of the fetched plane, mirroring the reference's
    clean-path byte reinterpret (infra/ipc.rs:63-73)."""
    small = nearest_downsample(x, max_dim)
    clean, mn, mx = _scrub_and_scan(small)
    host = torch.cat([clean.reshape(-1), mn[None], mx[None]]).cpu().numpy()
    arr = host[:-2].reshape(small.shape)
    return frame_preview_host(arr, float(host[-2]), float(host[-1]))


def frame_preview_host(arr: np.ndarray, mn: float, mx: float):
    """Host-side framing of an already-fetched little-endian f32 plane:
    16-byte header + zero-copy pixel view."""
    h, w = arr.shape
    header = struct.pack("<IIff", w, h, mn, mx)
    return header, memoryview(arr).cast("B")


def encode_with_header_downsampled(x: torch.Tensor,
                                   max_dim: int) -> bytearray:
    header, pixels = encode_with_header_views(x, max_dim)
    out = bytearray(len(header) + len(pixels))
    out[:16] = header
    out[16:] = pixels
    return out


def decode_binary_pixels(data: bytes):
    """Inverse of encode_with_header_downsampled (for tests/clients)."""
    w, h, mn, mx = struct.unpack("<IIff", data[:16])
    arr = np.frombuffer(data[16:], dtype="<f4").reshape(h, w)
    return arr, mn, mx
