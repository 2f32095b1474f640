"""Processing commands (counterpart of astroburst_tpu/api/processing.py;
reference: src-tauri/src/cmd/processing/).

Ported: ``resample_fits_cmd`` (the bicubic resize with its WCS rescale),
``extract_background_cmd`` (``imaging.background``),
``wavelet_denoise_cmd`` (``imaging.wavelet``), the stretch commands
``apply_arcsinh_stretch_cmd``, ``masked_stretch_cmd`` (kernels K10, K11
and K13), ``arcsinh_stretch_composite_cmd`` and
``masked_stretch_composite_cmd``, and the tone command
``apply_tone_composite_cmd`` (STF → levels → curves → SCNR), and
``deconvolve_rl_cmd`` (``analysis.deconvolution``: Richardson-Lucy on
``torch.fft``; with ``use_estimated_psf`` the PSF is estimated from the
image's stars, through kernels K10 and K11).

Each command resolves ``device`` first (``cuda_device()`` when None,
which raises where there is no card). The composite commands read the
KEY planes held for that device; planes held for another device count
as missing (``CacheMiss``).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.api import helpers
from astroburst_tpu_torch.api.common import (MAX_PREVIEW_DIM, Timer,
                                             load_cached, png_path_for)
from astroburst_tpu_torch.analysis.deconvolution import (
    generate_gaussian_psf, richardson_lucy)
from astroburst_tpu_torch.dtypes import RLConfig, StfParams
from astroburst_tpu_torch.imaging.background import (BackgroundConfig,
                                                     extract_background)
from astroburst_tpu_torch.imaging.curves import (LevelsParams, SplineCurve,
                                                 apply_curve_rgb,
                                                 apply_levels_rgb,
                                                 is_identity_curve)
from astroburst_tpu_torch.imaging.masked_stretch import (
    MaskedStretchConfig, masked_stretch, masked_stretch_rgb_shared)
from astroburst_tpu_torch.imaging.resample import resample_with_wcs
from astroburst_tpu_torch.imaging.scnr import apply_scnr
from astroburst_tpu_torch.imaging.stf import apply_stf_f32, auto_stf
from astroburst_tpu_torch.imaging.stretch import (arcsinh_stretch_rgb,
                                                  arcsinh_stretch_with_stats)
from astroburst_tpu_torch.imaging.wavelet import (WaveletConfig,
                                                  wavelet_denoise)
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.ops.stats import compute_image_stats
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.runtime.device import device_or_cuda
from astroburst_tpu_torch.runtime.output import resolve_output_dir
from astroburst_tpu_torch.runtime.progress import ProgressHandle


def _auto_preview(image: torch.Tensor, path: str) -> None:
    stats = compute_image_stats(image)
    helpers.save_stf_preview_png(image, auto_stf(stats), stats, path,
                                 MAX_PREVIEW_DIM)


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _write_fits(path: str, image: torch.Tensor, header) -> None:
    write_fits_mono(path, image.cpu().numpy(), header)


def resample_fits_cmd(path: str, output_dir: str, target_width: int,
                      target_height: int, *,
                      device: Optional[torch.device] = None) -> dict:
    """Bicubic resize + WCS rescale (cmd/processing/resample.rs:12)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    result = resample_with_wcs(entry.image, entry.header or HduHeader(),
                               target_height, target_width)
    header = entry.header.copy() if entry.header else None
    if header is not None:
        for k, v in result.header_updates:
            if k not in ("NAXIS1", "NAXIS2"):
                header.set_f64(k, v)
    fits_path = os.path.join(out_dir, f"{_stem(path)}_{C.RESAMPLED}.fits")
    _write_fits(fits_path, result.image, header)
    png_path = png_path_for(path, out_dir, C.RESAMPLED)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ORIGINAL_DIMENSIONS: list(result.original_dims[::-1]),
        C.RES_DIMENSIONS: [target_width, target_height],
        C.RES_WCS_UPDATES: dict(result.header_updates),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def deconvolve_rl_cmd(path: str, output_dir: str,
                      iterations: Optional[int] = None,
                      psf_sigma: Optional[float] = None,
                      kernel_size: Optional[int] = None,
                      regularization: Optional[float] = None,
                      dering: Optional[bool] = None,
                      dering_threshold: Optional[float] = None,
                      use_estimated_psf: Optional[bool] = None,
                      fast_precision: Optional[bool] = None, *,
                      device: Optional[torch.device] = None) -> dict:
    """RL with progress events (cmd/processing/deconvolution.rs:15).
    ``fast_precision`` is the JAX package's TPU extension; it is
    accepted and changes nothing here (true f32 either way:
    ``analysis.deconvolution``)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    config = RLConfig(
        iterations=iterations if iterations is not None else 20,
        psf_sigma=psf_sigma if psf_sigma is not None else 2.0,
        regularization=regularization or 0.0,
        dering=dering if dering is not None else True,
        dering_threshold=(dering_threshold if dering_threshold is not None
                          else 0.1),
        fast_precision=bool(fast_precision))
    if use_estimated_psf:
        from astroburst_tpu_torch.imaging.psf_estimation import (
            estimate_psf, psf_to_kernel)
        psf = psf_to_kernel(estimate_psf(entry.image))
    else:
        size = kernel_size if kernel_size is not None else 15
        psf = generate_gaussian_psf(size, config.psf_sigma)
    progress = ProgressHandle(C.EVENT_DECONV_PROGRESS,
                              total=config.iterations)
    result = richardson_lucy(entry.image, psf, config, progress)
    fits_path = os.path.join(out_dir, f"{_stem(path)}_{C.SUFFIX_DECONV}.fits")
    _write_fits(fits_path, result.image, entry.header)
    png_path = png_path_for(path, out_dir, C.SUFFIX_DECONV)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ITERATIONS_RUN: result.iterations_run,
        C.RES_CONVERGENCE: result.convergence,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def extract_background_cmd(path: str, output_dir: str,
                           grid_size: Optional[int] = None,
                           poly_degree: Optional[int] = None,
                           sigma_clip: Optional[float] = None,
                           iterations: Optional[int] = None,
                           mode: Optional[str] = None, *,
                           device: Optional[torch.device] = None) -> dict:
    """Polynomial background fit and removal
    (cmd/processing/background.rs:18)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    config = BackgroundConfig(
        grid_size=grid_size if grid_size is not None else 8,
        poly_degree=poly_degree if poly_degree is not None else 3,
        sigma_clip=sigma_clip if sigma_clip is not None else 2.5,
        iterations=iterations if iterations is not None else 3,
        mode=mode or "subtract")
    progress = ProgressHandle(C.PROGRESS_EVENT, total=C.PROGRESS_STEPS)
    result = extract_background(entry.image, config, progress)
    corrected_fits = os.path.join(out_dir,
                                  f"{_stem(path)}_{C.DEFAULT_STEM}.fits")
    _write_fits(corrected_fits, result.corrected, entry.header)
    corrected_png = png_path_for(path, out_dir, C.DEFAULT_STEM)
    _auto_preview(result.corrected, corrected_png)
    model_png = png_path_for(path, out_dir, "bg_model")
    _auto_preview(result.model, model_png)
    return {
        C.RES_CORRECTED_FITS: corrected_fits,
        C.RES_CORRECTED_PNG: corrected_png,
        C.RES_MODEL_PNG: model_png,
        C.RES_SAMPLE_COUNT: result.sample_count,
        C.RES_RMS_RESIDUAL: result.rms_residual,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def wavelet_denoise_cmd(path: str, output_dir: str,
                        num_scales: Optional[int] = None,
                        thresholds: Optional[Sequence[float]] = None,
                        linear_denoise: Optional[bool] = None, *,
                        device: Optional[torch.device] = None) -> dict:
    """À trous wavelet denoise (cmd/processing/wavelet.rs:13)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    config = WaveletConfig(
        num_scales=num_scales if num_scales is not None else 5,
        thresholds=tuple(thresholds) if thresholds else
        (3.0, 2.5, 2.0, 1.5, 1.0),
        linear_denoise=linear_denoise if linear_denoise is not None else True)
    progress = ProgressHandle(C.EVENT_WAVELET_PROGRESS)
    result = wavelet_denoise(entry.image, config, progress)
    fits_path = os.path.join(out_dir, f"{_stem(path)}_denoised.fits")
    _write_fits(fits_path, result.denoised, entry.header)
    png_path = png_path_for(path, out_dir, "denoised")
    _auto_preview(result.denoised, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_SCALES_PROCESSED: result.scales_processed,
        C.RES_NOISE_ESTIMATE: result.noise_estimate,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def apply_arcsinh_stretch_cmd(path: str, output_dir: str, factor: float,
                              gamma: Optional[float] = None, *,
                              device: Optional[torch.device] = None) -> dict:
    """Arcsinh stretch over the cached stats' range
    (cmd/processing/stretch.rs:15)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    clamped = min(max(float(factor), 1.0), 500.0)
    stretched = arcsinh_stretch_with_stats(
        entry.image, entry.stats.min, entry.stats.max, clamped,
        gamma if gamma is not None else 1.0)
    fits_path = os.path.join(out_dir, f"{_stem(path)}_arcsinh.fits")
    _write_fits(fits_path, stretched, entry.header)
    png_path = png_path_for(path, out_dir, "arcsinh")
    _auto_preview(stretched, png_path)
    h, w = stretched.shape
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_STRETCH_FACTOR: clamped,
        C.RES_DIMENSIONS: [w, h],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def _masked_stretch_config(iterations, target_background, mask_growth,
                           mask_softness, protection_amount,
                           luminance_protect) -> MaskedStretchConfig:
    return MaskedStretchConfig(
        iterations=iterations if iterations is not None else 10,
        target_background=(target_background if target_background is not None
                           else 0.25),
        mask_growth=mask_growth if mask_growth is not None else 2.5,
        mask_softness=mask_softness if mask_softness is not None else 4.0,
        protection_amount=(protection_amount if protection_amount is not None
                           else 0.85),
        luminance_protect=(luminance_protect if luminance_protect is not None
                           else True))


def masked_stretch_cmd(path: str, output_dir: str,
                       iterations: Optional[int] = None,
                       target_background: Optional[float] = None,
                       mask_growth: Optional[float] = None,
                       mask_softness: Optional[float] = None,
                       protection_amount: Optional[float] = None,
                       luminance_protect: Optional[bool] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """Star-masked iterative stretch (cmd/processing/stretch.rs:46):
    detection (K10, K11), the star mask (K13) and the MTF loop."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path, device)
    config = _masked_stretch_config(iterations, target_background,
                                    mask_growth, mask_softness,
                                    protection_amount, luminance_protect)
    result = masked_stretch(entry.image, config)
    fits_path = os.path.join(
        out_dir, f"{_stem(path)}_{C.SUFFIX_MASKED_STRETCH}.fits")
    _write_fits(fits_path, result.image, entry.header)
    png_path = png_path_for(path, out_dir, C.SUFFIX_MASKED_STRETCH)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ITERATIONS_RUN: result.iterations_run,
        C.RES_FINAL_BACKGROUND: result.final_background,
        C.RES_STARS_MASKED: result.stars_masked,
        C.RES_MASK_COVERAGE: result.mask_coverage,
        C.RES_CONVERGED: result.converged,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def arcsinh_stretch_composite_cmd(output_dir: str, factor: float, *,
                                  device: Optional[torch.device] = None
                                  ) -> dict:
    """Composite arcsinh over one range shared by the three channels
    (cmd/processing/stretch.rs:94)."""
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    er, eg, eb = helpers.load_composite_rgb(device)
    clamped = min(max(float(factor), 1.0), 500.0)
    t0 = Timer()
    r, g, b = arcsinh_stretch_rgb(er.image, eg.image, eb.image, clamped)
    png_path = os.path.join(out_dir,
                            f"composite_arcsinh_{int(time.time()*1000)}.png")
    helpers.render_rgb_preview(r, g, b, png_path, MAX_PREVIEW_DIM)
    h, w = r.shape
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_STRETCH_FACTOR: clamped,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
        C.RES_DIMENSIONS: [w, h],
    }


def masked_stretch_composite_cmd(output_dir: str,
                                 iterations: Optional[int] = None,
                                 target_background: Optional[float] = None,
                                 mask_growth: Optional[float] = None,
                                 mask_softness: Optional[float] = None,
                                 protection_amount: Optional[float] = None,
                                 luminance_protect: Optional[bool] = None,
                                 shared_mask: Optional[bool] = None, *,
                                 device: Optional[torch.device] = None
                                 ) -> dict:
    """Masked stretch of the composite (cmd/processing/stretch.rs): one
    star mask per channel, or with ``shared_mask`` one mask from the
    luminance for all three; every detected star is masked (ROADMAP
    C49)."""
    with trace.span("api.masked_stretch_composite"):
        t0 = Timer()
        device = device_or_cuda(device)
        out_dir = resolve_output_dir(output_dir)
        er, eg, eb = helpers.load_composite_rgb(device)
        config = _masked_stretch_config(iterations, target_background,
                                        mask_growth, mask_softness,
                                        protection_amount, luminance_protect)

        def ch_json(res):
            return {C.RES_ITERATIONS_RUN: res.iterations_run,
                    C.RES_FINAL_BACKGROUND: res.final_background,
                    C.RES_CONVERGED: res.converged}

        if shared_mask:
            result = masked_stretch_rgb_shared(er.image, eg.image, eb.image,
                                               config)
            r_img = result["r"].image
            g_img = result["g"].image
            b_img = result["b"].image
            per_channel = {c: ch_json(result[c]) for c in "rgb"}
            stars = result["shared_stars_masked"]
            coverage = result["shared_mask_coverage"]
            mask_mode = "shared_luminance"
        else:
            rr = masked_stretch(er.image, config)
            gg = masked_stretch(eg.image, config)
            bb = masked_stretch(eb.image, config)
            r_img, g_img, b_img = rr.image, gg.image, bb.image
            per_channel = {"r": ch_json(rr), "g": ch_json(gg),
                           "b": ch_json(bb)}
            stars = rr.stars_masked + gg.stars_masked + bb.stars_masked
            coverage = (rr.mask_coverage + gg.mask_coverage +
                        bb.mask_coverage) / 3.0
            mask_mode = "per_channel"

        png_path = os.path.join(
            out_dir, f"composite_masked_{int(time.time()*1000)}.png")
        with trace.span("stretch.masked.preview"):
            helpers.render_rgb_preview(r_img, g_img, b_img, png_path,
                                       MAX_PREVIEW_DIM)
        return {
            C.RES_PNG_PATH: png_path,
            C.RES_STARS_MASKED: stars,
            C.RES_MASK_COVERAGE: coverage,
            "mask_mode": mask_mode,
            C.CHANNELS: per_channel,
            C.RES_ELAPSED_MS: t0.elapsed_ms(),
        }


def _levels_of(d: Optional[dict]) -> LevelsParams:
    if not d:
        return LevelsParams()
    return LevelsParams(black=float(d.get("black", 0.0)),
                        gamma=float(d.get("gamma", 1.0)),
                        white=float(d.get("white", 1.0)))


def _points_of(d: Optional[dict]) -> list:
    if not d:
        return []
    return [tuple(p) for p in d.get("points", [])]


def apply_tone_composite_cmd(output_dir: str,
                             stf_r: Optional[Sequence[float]] = None,
                             stf_g: Optional[Sequence[float]] = None,
                             stf_b: Optional[Sequence[float]] = None,
                             linked_stf: Optional[bool] = None,
                             levels_r: Optional[dict] = None,
                             levels_g: Optional[dict] = None,
                             levels_b: Optional[dict] = None,
                             curves_r: Optional[dict] = None,
                             curves_g: Optional[dict] = None,
                             curves_b: Optional[dict] = None,
                             scnr: Optional[dict] = None, *,
                             device: Optional[torch.device] = None) -> dict:
    """KEY → STF → levels → curves → optional SCNR → preview,
    non-destructive (cmd/processing/curves.rs:58)."""
    t0 = Timer()
    device = device_or_cuda(device)
    out_dir = resolve_output_dir(output_dir)
    src_r, src_g, src_b = helpers.load_composite_rgb(device)
    rows, cols = src_r.image.shape

    if linked_stf:
        p, combined = helpers.compute_linked_stf_with_stats(
            src_r.stats, src_g.stats, src_b.stats)
        auto_params = (p, p, p)
        norms = (combined, combined, combined)
    else:
        auto_params = (auto_stf(src_r.stats), auto_stf(src_g.stats),
                       auto_stf(src_b.stats))
        norms = (src_r.stats, src_g.stats, src_b.stats)

    def stf_of(arr, auto_p):
        if arr is None:
            return auto_p
        return StfParams(shadow=arr[0], midtone=arr[1], highlight=arr[2])

    params = [stf_of(stf_r, auto_params[0]), stf_of(stf_g, auto_params[1]),
              stf_of(stf_b, auto_params[2])]
    planes = [apply_stf_f32(e.image, p, n) for e, p, n in
              zip((src_r, src_g, src_b), params, norms)]

    lv = [_levels_of(levels_r), _levels_of(levels_g), _levels_of(levels_b)]
    levels_applied = not all(l.is_identity() for l in lv)
    if levels_applied:
        planes = list(apply_levels_rgb(*planes, *lv))

    curve_pts = [_points_of(curves_r), _points_of(curves_g),
                 _points_of(curves_b)]
    curves_applied = not all(is_identity_curve(p) for p in curve_pts)
    if curves_applied:
        curves = [SplineCurve(p if p else [(0.0, 0.0), (1.0, 1.0)])
                  for p in curve_pts]
        planes = list(apply_curve_rgb(*planes, *curves))

    scnr_applied = False
    if scnr is not None:
        cfg = helpers.parse_scnr_config(True, scnr.get("method"),
                                        scnr.get("amount"),
                                        scnr.get("preserveLuminance"))
        planes = list(apply_scnr(*planes, cfg))
        scnr_applied = True

    png_path = os.path.join(out_dir,
                            f"composite_tone_{int(time.time()*1000)}.png")
    helpers.render_rgb_preview(planes[0], planes[1], planes[2], png_path,
                               MAX_PREVIEW_DIM)
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_COMPOSITE_DIMS: [cols, rows],
        C.RES_STF_APPLIED: True,
        C.RES_LEVELS_APPLIED: levels_applied,
        C.RES_CURVES_APPLIED: curves_applied,
        C.RES_SCNR_APPLIED: scnr_applied,
        C.RES_STF: params[0].to_dict(),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
