"""Sharded 2-D FFT, RL deconvolution and power spectrum over a mesh
(counterpart of astroburst_tpu/parallel/fft.py; reference single-core
semantics: deconvolution.rs:141-213, analysis/fft.rs).

The distributed transpose form: a rows-sharded plane's row transform
(``torch.fft.fft`` over the last axis, cuFFT on the card) is local;
one ``all_to_all`` lays the spectrum out cols-sharded; the column
transform is then local too. The inverse retraces the path, so a round
trip costs exactly two all-to-alls. As in the JAX package these are
full complex transforms (the single-device functions use the rfft
half spectrum, whose pairing would span shards). The four-step matmul
engine of the JAX package (``ops/fft.py``) exists for the TPU and is
not ported. The results equal the single-device functions' to f32
rounding (ROADMAP C30: the RL's FFT size and the order of the passes
differ).
"""

from __future__ import annotations

import numpy as np
import torch

from astroburst_tpu_torch.dtypes import RLConfig
from astroburst_tpu_torch.ops.fft import next_fast_size, next_power_of_two
from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, as_sharded,
                                                on_shards, shard)

CONVERGENCE_THRESHOLD = 1e-6
EPSILON = 1e-6


def _to_cols(mesh: Mesh, parts, axes) -> list:
    """Rows-sharded complex [R/P, C] → cols-sharded [R, C/P]: the row
    transform, one all_to_all, the column transform (unnormalized, as
    ``torch.fft.fft2``)."""
    rows = on_shards(mesh, lambda i, z: torch.fft.fft(z, dim=-1), parts)
    cols = mesh.all_to_all(rows, axes[0], split_dim=1, concat_dim=0)
    return on_shards(mesh, lambda i, z: torch.fft.fft(z, dim=-2), cols)


def _to_rows(mesh: Mesh, parts, axes) -> list:
    """The inverse path: cols-sharded [R, C/P] → rows-sharded [R/P, C]
    (the inverse column transform, all_to_all, the inverse row
    transform; 1/R and 1/C as ``torch.fft.ifft2`` scales)."""
    cols = on_shards(mesh, lambda i, z: torch.fft.ifft(z, dim=-2), parts)
    rows = mesh.all_to_all(cols, axes[0], split_dim=0, concat_dim=1)
    return on_shards(mesh, lambda i, z: torch.fft.ifft(z, dim=-1), rows)


def _one_axis(mesh: Mesh, axis_name):
    axes = mesh.axes(axis_name)
    if len(axes) != 1:
        raise ValueError("the sharded FFT transposes over one mesh axis")
    return axes


def _complex_rows(mesh: Mesh, xr, xi, axes) -> list:
    return on_shards(mesh, lambda i, a, b: torch.complex(a, b),
                     as_sharded(mesh, xr, 0, axes).parts,
                     as_sharded(mesh, xi, 0, axes).parts)


def _split(mesh: Mesh, parts, dim: int, axes, length: int):
    re = Sharded(mesh, [z.real.contiguous() for z in parts], dim, axes,
                 length)
    im = Sharded(mesh, [z.imag.contiguous() for z in parts], dim, axes,
                 length)
    return re, im


def sharded_fft2(mesh: Mesh, xr, xi, axis_name="rows"):
    """Forward 2-D FFT of a rows-sharded plane (``xr`` + i·``xi``,
    tensors or Sharded rows); returns the spectrum's real and imaginary
    parts cols-sharded (Sharded, dim 1), unnormalized as
    ``torch.fft.fft2``."""
    axes = _one_axis(mesh, axis_name)
    n_sh = mesh.extent(axes)
    if isinstance(xr, Sharded):
        r, c = xr.length, xr.parts[0].shape[1]
    else:
        r, c = xr.shape
    if r % n_sh or c % n_sh:
        raise ValueError(f"plane {r}x{c} not divisible by the {n_sh}-way "
                         f"'{axes[0]}' axis")
    z = _to_cols(mesh, _complex_rows(mesh, xr, xi, axes), axes)
    return _split(mesh, z, 1, axes, c)


def sharded_ifft2(mesh: Mesh, xr: Sharded, xi: Sharded, axis_name="rows"):
    """Inverse of ``sharded_fft2``: the cols-sharded spectrum in, the
    rows-sharded plane out (Sharded, dim 0), scaled by 1/(R·C)."""
    axes = _one_axis(mesh, axis_name)
    z = on_shards(mesh, lambda i, a, b: torch.complex(a, b), xr.parts,
                  xi.parts)
    rows = _to_rows(mesh, z, axes)
    return _split(mesh, rows, 0, axes, xr.parts[0].shape[0])


def _fft_size(m: int, n_sh: int) -> int:
    """The smallest 2·3·5·7-smooth size >= m that n_sh divides."""
    k = next_fast_size(m)
    while k % n_sh:
        k = next_fast_size(k + 1)
    return k


def _crop_rows(mesh: Mesh, parts, axes, local: int, length: int,
               cols: int) -> list:
    """Each shard's rows of [0, length) and columns [0, cols)."""
    def crop(i, p):
        g0 = mesh.index(i, axes) * local
        return p[:max(0, min(local, length - g0)), :cols]
    return on_shards(mesh, crop, parts)


def sharded_deconvolve(mesh: Mesh, image, psf, config: RLConfig = RLConfig(),
                       axis_name="rows"):
    """Richardson-Lucy (``analysis/deconvolution.rl_loop``'s iteration:
    Tikhonov 1/(1+λ), the clamp at 0, the bidirectional deringing, the
    stop once the RMS change is below 1e-6 after at least 3 iterations)
    with every FFT sharded over ``axis_name``. The state lives
    rows-sharded on the zero-padded plane (the pad stays zero); each of
    the two convolutions an iteration runs rows → cols → rows, two
    all-to-alls. The PSF spectrum is built on every shard (it is small
    before the transform) and each keeps its column block. Returns
    (estimate: Sharded rows, iterations_run, convergence)."""
    axes = _one_axis(mesh, axis_name)
    n_sh = mesh.extent(axes)
    img = image.to(torch.float32)
    rows, cols = img.shape
    psf_np = np.asarray(psf, np.float32)
    fr = _fft_size(rows + psf_np.shape[0] - 1, n_sh)
    fc = _fft_size(cols + psf_np.shape[1] - 1, n_sh)
    f32 = np.float32
    lam = f32(config.regularization)
    inv_reg = float(f32(1.0) / (f32(1.0) + lam)) if lam > 0 else 1.0
    thr = f32(config.dering_threshold)
    pad = torch.nn.functional.pad(img, (0, fc - cols, 0, fr - rows))
    lim = shard(mesh, pad, 0, axes).parts
    local = fr // n_sh
    psf_t = torch.as_tensor(psf_np)

    def spectrum(i, _):
        dev = mesh.device(i)
        buf = torch.zeros((fr, fc), dtype=torch.float32, device=dev)
        pr, pc = psf_np.shape
        buf[:pr, :pc] = psf_t.to(dev)
        buf = torch.roll(buf, (-(pr // 2), -(pc // 2)), dims=(0, 1))
        b = mesh.index(i, axes) * (fc // n_sh)
        return torch.fft.fft2(buf)[:, b:b + fc // n_sh].contiguous()

    spec = on_shards(mesh, spectrum, lim)
    conj = on_shards(mesh, lambda i, k: torch.conj(k), spec)

    def convolve(x, kernel):
        z = _to_cols(mesh, on_shards(
            mesh, lambda i, v: v.to(torch.complex64), x), axes)
        z = on_shards(mesh, lambda i, a, k: a * k, z, kernel)
        return on_shards(mesh, lambda i, v: v.real, _to_rows(mesh, z, axes))

    def update(i, e, c, v):
        new = torch.clamp(e * c * inv_reg, min=0.0)
        if config.dering:
            upper = v * float(f32(1.0) + thr)
            lower = torch.clamp(v * float(f32(1.0) - thr), min=0.0)
            new = torch.minimum(torch.maximum(new, lower), upper)
        return new

    def state(i, fill, dtype):
        return torch.full((), fill, dtype=dtype, device=mesh.device(i))

    # the stop flag, the iteration count and the convergence stay on the
    # device, one 0-d tensor a shard, as in rl_loop
    active = [state(i, True, torch.bool) for i in range(mesh.size)]
    iters = [state(i, 0, torch.int32) for i in range(mesh.size)]
    conv = [state(i, float(np.finfo(np.float32).max), torch.float32)
            for i in range(mesh.size)]
    estimate = lim
    for it in range(config.iterations):
        convolved = convolve(estimate, spec)
        ratio = on_shards(mesh, lambda i, v, c: v / (c + EPSILON), lim,
                          convolved)
        new_est = on_shards(mesh, update, estimate, convolve(ratio, conj),
                            lim)
        sq = mesh.psum(on_shards(mesh, lambda i, a, b: (
            (a - b) ** 2).sum(), new_est, estimate), axes)
        delta = on_shards(mesh, lambda i, s: torch.sqrt(s / (rows * cols)),
                          sq)
        estimate = on_shards(mesh, lambda i, a, n, e: torch.where(a, n, e),
                             active, new_est, estimate)
        iters = on_shards(mesh, lambda i, a, t: torch.where(
            a, torch.full_like(t, it + 1), t), active, iters)
        conv = on_shards(mesh, lambda i, a, d, c: torch.where(a, d, c),
                         active, delta, conv)
        if it + 1 >= 3:
            active = on_shards(mesh, lambda i, a, d: a & ~(
                d < CONVERGENCE_THRESHOLD), active, delta)
    iters_run, convergence = torch.stack([
        iters[0].to(torch.float64), conv[0].to(torch.float64)]).tolist()
    out = _crop_rows(mesh, estimate, axes, local, rows, cols)
    return Sharded(mesh, out, 0, axes, rows), int(iters_run), \
        float(convergence)


def sharded_power_spectrum(mesh: Mesh, data, apply_window: bool = True,
                           axis_name="rows") -> Sharded:
    """The shifted log1p power spectrum (``analysis/fft._spectrum``:
    NaN → 0, symmetric Hann, power-of-two pad, log1p |X|, fftshift) with
    the FFT sharded over ``axis_name``: the windowed, padded plane is
    placed in row blocks, transformed to column blocks (one
    all_to_all), the magnitude taken there, its rows rolled by S/2
    (local), laid back out in row blocks (one all_to_all) and its
    columns rolled by S/2. Returns the [S, S] spectrum rows-sharded; the
    caller downsamples for display."""
    from astroburst_tpu_torch.ops.window import hann_symmetric

    axes = _one_axis(mesh, axis_name)
    n_sh = mesh.extent(axes)
    data = data.to(torch.float32)
    rows, cols = data.shape
    size = next_power_of_two(max(rows, cols))
    if size % n_sh:
        raise ValueError(f"'{axes[0]}' axis size {n_sh} must divide the "
                         f"FFT size {size}")
    vals = torch.where(torch.isfinite(data), data, 0.0)
    if apply_window:
        wy = torch.from_numpy(hann_symmetric(rows)).to(data.device)
        wx = torch.from_numpy(hann_symmetric(cols)).to(data.device)
        vals = vals * wy[:, None] * wx[None, :]
    buf = torch.nn.functional.pad(vals, (0, size - cols, 0, size - rows))
    parts = on_shards(mesh, lambda i, v: v.to(torch.complex64),
                      shard(mesh, buf, 0, axes).parts)
    z = _to_cols(mesh, parts, axes)
    mag = on_shards(mesh, lambda i, v: torch.roll(torch.log1p(torch.sqrt(
        v.real * v.real + v.imag * v.imag)), size // 2, dims=0), z)
    out = mesh.all_to_all(mag, axes[0], split_dim=0, concat_dim=1)
    out = on_shards(mesh, lambda i, v: torch.roll(v, size // 2, dims=1),
                    out)
    return Sharded(mesh, out, 0, axes, size)
