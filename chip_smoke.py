#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (astroburst_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase-4i [SIDE ...]   # phase 4i alone, once
                                                  # per composite side
    python3 chip_smoke.py --phase-4j [SIDE ...]   # phase 4j alone, once
                                                  # per side of the
                                                  # wizard's colour commands
    python3 chip_smoke.py --phase-4k [SIDE ...]   # phase 4k alone, once
                                                  # per side of the RGB
                                                  # tile pyramid

Phases, each of which fails loudly (nothing is caught; any failure
exits non-zero, and so does a machine without a CUDA device):

1. device: card name and count, torch/CUDA/nvcc versions, the card's
   name and power limit from nvidia-smi; TF32 must be off;
2. build: nvcc builds every kernel of ``astroburst_tpu_torch/csrc`` for
   sm_90a, one process per source, all started together; registers,
   shared memory and spills of each kernel and the build seconds are
   printed, and a kernel that spills, or a register instance of K3, K7/K8
   or K9, or K2, K11, K12 or K13, with a stack frame, fails the run;
3. kernels: each CUDA kernel against its plain torch version on the
   card, at the shapes of the main paths. K1-K3 on the bench workload
   (16 frames of 5655 x 2206 f32), K2 also on ``crop_cases`` (widths
   2206, 2205 and 2048, crop widths 512, 509 and 1, x0 at every residue
   mod 4, frame0 0 and 1 and the view of frames 1.., origins past every
   side), K3 also at zero offsets against
   sigma_clip_core (the clip-only TPU kernel's function), at
   24 x 2048^2 with offsets up to +-200, at 1, 48 and 100 frames with
   NaN/inf pixels, in every instance (``tie_stack`` stacks, quantised so
   that ties are many, with +-0.0 and NaN/inf pixels, at 1 to 32 frames:
   the register instances; 48 and 100: shared memory) and past 128
   frames (150 and 300 frames of 1024^2: the global scratch, over bands
   of rows), K1 also on NaN/inf frames. K7 and K8 (the drizzle finalize)
   on one 1024-row band of the drizzle bench (10 x 4096^2 f32 → 8192^2:
   40 candidates x 1024 x 8192), and at 10, 30, 60, 128 and 150 frames
   with NaN/inf pixels, and in every instance (FINALIZE_INSTANCES on
   ``tie_stack`` stacks: registers at depth 4 to 32 in steps of 4,
   shared memory at 40 and 200, the global scratch at 300), K7 also on
   drizzle_stack's own band of 64 rows (40 x 64 x 8192), and K9 (the
   parity drizzle: candidates gathered in the kernel) on the full output
   of the drizzle bench (10 x 4096^2 → 8192^2, the register instance),
   in each of the same instances, and at 20 x 1024^2 → 2048^2 (shared
   memory). K10 (tile sort)
   on tiles the fields do not reach (all equal, all invalid, one valid
   value, +-inf rows, values at exactly 1e-7, ties) at steps 16, 64, 90,
   125, 128, 129, 200 and 256 (every plan of the cluster radix route)
   and 363 (the chunked route), on a 4096^2 star field (256 tiles of
   256^2), on a 5655 x 2206 field (23 x 9 tiles, NaN padding), both with
   NaN/inf pixels, and at 1000^2 (step 125); K11 (window statistics) on the
   4096^2 field of ~3000 stars with NaN patches at 1024 peaks, on the
   5655 x 2206 field and on ``window_cases`` (a spiral past 20 rounds,
   NaN, below-threshold, at-threshold and +-inf centres, a ring exactly
   at the threshold, an all-above window, corners and edges, a component
   past the window's border, dead slots); K2 and K11 each also timed as
   the wrapper, the launch alone and the profiler's device time; K13 (the
   star mask, one launch that culls its own stars) on the star records
   the masked stretch paints on that field (4096 peaks), on 4096
   synthetic slots and on ``star_mask_cases`` (exact .5 positions, stars
   up to 200 px off the plane, radius + softness past the half-window,
   600 stars in one tile, a single slot, a 2093 x 2125 plane); K12
   (triangle vote over the r0 window) at the full triangle count of 60
   stars and on ``vote_cases`` (ratios at r -/+ 0.02 and one ulp either
   side, tied r0, every r0 equal — the all-pairs worst case, timed —
   +inf padding shuffled in with NaN ratios, vertex ids outside [0, 64),
   1 and 3 live triangles, a ref list with no live row);
4. main paths, each with every kernel launch counter reset just before
   and read just after: (a) ``align_stack_stretch`` on the bench
   workload and ``stack_images`` on 24 frames of 2048^2 (shifts up to
   +-200), offsets against the generator's shifts; ``stack_images`` on
   150 frames of 1024^2 (shifts up to +-100; K3's scratch instance, past
   128 frames), counted on its own; (b) calibrate →
   drizzle → stretch: masters from 16 bias, 16 dark and 16 flat frames,
   10 calibrated lights of 4096^2 (a star field with sub-pixel dithers
   in +-2 px, rendered analytically), ``drizzle_stack`` with the
   default config (scale 2, pixfrac 0.7, square, 5 iterations: the
   exact route), stats, auto-STF and u8; offsets against the dithers;
   (c) star detection → affine alignment → warp: ``detect_stars`` on the
   4096^2 field of ~3000 stars (BASELINE.md:13) and on a 5655 x 2206
   field of 200 stars (BASELINE.md:26), isolated bright stars within
   0.3 px of the generator; ``align_channel_affine`` + ``warp_image`` at
   5655 x 2206 with 90 stars against the target of the JAX package's
   affine bench (rotation 0.4 deg, shift (3.2, -2.1), noise 1.5, rendered
   here on the card) and at 4096^2 with 80 stars (BASELINE.md:17), the
   rotation recovered within 0.1 deg; ``drizzle_stack`` by the AFFINE
   method on 4 dithered 1024^2 star fields, offsets within 0.15 px;
   (d) star mask → masked stretch: ``masked_stretch`` on the 4096^2
   field fixed x10 (convergence_threshold 0) and at the default
   threshold, ``masked_stretch_rgb_shared`` on three channels made from
   it: stars masked, output in [0, 1], background within 0.02 of 0.25;
   (e) ``drizzle_exact_parity`` on the calibrated lights of (b) with
   the offsets ``drizzle_stack`` found, and on the drizzle bench stack,
   against ``_drizzle_kernel_exact`` at one band (no band offset).
   (f) the ``stack`` command (``astroburst_tpu_torch.api.stack``): the
   bench frames written as 16 FITS files (BITPIX -32, the port's
   writer) and the 150 frames of 1024^2 as 150 more; the command cold
   (empty image cache), warm (every frame cached), on the directory
   path, and on the 150 files (past 128 frames and the cache's 32
   entries): RES_* keys, offsets equal to the generator's shifts,
   ``stacked.fits`` read back bit-equal to ``stack_images`` on the
   in-memory frames on the card, the rejected count equal, and
   ``stacked.png`` (4096 x 1598 at the bench size, decoded with zlib)
   equal to ``apply_stf_u8(nearest_downsample(image, 4096))`` with the
   command's stats; then the stages timed: the decode of one frame
   (and into pinned memory with the copy to the card),
   ``load_cached_many`` over the 16 files, ``stack_images``,
   ``compute_image_stats``, the image fetch, ``write_fits_mono``, the
   preview PNG, and the command cold and warm, with Mpx/s from warm.
   (g) open and inspect (``open_inspect_path``): the 4096^2 detection
   field, one bench frame, an RGB FITS of 3 x 4096^2, a BITPIX 16 file
   with BSCALE/BZERO, a two-HDU MEF with a SCI extension and an ASDF
   file, written under build/; ``process_fits``, ``process_fits_full``,
   ``get_raw_pixels_preview``, ``apply_stf_render`` and
   ``compute_histogram`` cold and warm, then the header, extension,
   filter and output-dir commands: RES_* keys, stats equal to
   ``compute_image_stats`` on the in-memory tensor, every PNG (decoded
   with zlib) equal to ``apply_stf_u8(nearest_downsample(...))`` on the
   card, histogram counts equal to an int64 numpy count over the same
   f32 edges, summing to the valid count, the raw preview equal to the
   scrubbed 2048 downsample, the six composite keys (ORIG and KEY one
   tensor), the cards written; the ASDF file read where PyYAML is
   installed, else the ModuleNotFoundError naming it; this slice
   launches no kernel (every count 0). Timed: the decode, stats,
   histogram, STF u8, fetch and PNG stages (and the RGB file's decode,
   u8 planes with their fetch, and RGB PNG), each command cold and warm,
   and the STF slider path (2048^2 downsample + u8 STF of a 4096^2
   plane, p50 over 60 calls), each beside the reference's own figure.
   (h) calibrate → pipeline / drizzle → export
   (``calibrate_export_path``): 4b's raw frames (16 bias, 16 dark, 16
   flat, 10 lights of 4096^2) and its 10 calibrated lights written as
   FITS under build/, with a 4096^2 plane carrying CD WCS cards and the
   bench frame carrying CDELT ones; each command cold (empty image
   cache) and warm: ``calibrate`` on light 0 (``_calibrated.fits``
   bit-equal to 4b's ``calibrate``, its PNG equal to the card's STF
   u8), ``run_pipeline_cmd`` on three channels of the 10 lights
   (``master_*.fits`` and ``pipeline_rgb.fits`` bit-equal to
   ``run_batch_pipeline`` on the card, each ``preview_b64`` equal to
   the 1024 downsample of the u8 STF; no kernel), ``drizzle_stack_cmd``
   on the 10 calibrated files (``drizzled.fits`` bit-equal to 4b's
   ``drizzle_stack``; K1, K2 and K7 launched), ``resample_fits_cmd``
   4096^2 → 2048^2 and 5655 x 2206 → 8192 x 3196 (within 1e-5 of the
   plane's largest magnitude of a numpy tap oracle, ``wcs_updates``
   exact), ``export_fits`` of ``drizzled.fits`` at BITPIX -32 (bit-equal)
   and 16 (half a quantum + 2 ulp) with the STF on and off,
   ``export_png`` mono at 8 and 16 bits (equal to the linear map) and
   RGB on ``pipeline_rgb.fits`` (equal to the linked STF on the card),
   ``export_fits_rgb`` from 4096^2 + 4096^2 + 2048^2 files (the resample
   route) and from the composite cache, ``export_rgb_png`` (16 bits,
   ``RGB_PNG_HW``^2 planes) and ``export_zip_bundle`` of the exports;
   the counters are read after calibrate + pipeline (all 0), after the
   drizzle command and after the exports (all 0).
   (i) stretch, tone, denoise and detection (``tone_detect_path``):
   the 4096^2 field in [0, 1) of (d) as a FITS file, 10 star fields of
   4096^2 (the scene of (c) at seeds 0-9) as FITS files and a 3 x
   ``COMP_HW``^2 composite made from the field's corner as (d) makes its
   channels, in the image cache (a 3 x 4096^2 one from the whole field
   for ``detect_stars_composite``); ``masked_stretch_cmd`` (FITS bit-equal
   to ``masked_stretch`` on the card; K10, K11, K13),
   ``masked_stretch_composite_cmd`` per channel and shared (equal to
   the module calls; K13), ``detect_stars``, ``detect_stars_composite``,
   ``estimate_psf_cmd`` and ``analyze_subframes_cmd`` (star lists equal
   to ``detect_stars`` on the same plane, ``detect_stars`` within 1e-3 px
   of its plain version and 0.3 px of the generator; K10, K11),
   ``wavelet_denoise_cmd`` and ``extract_background_cmd`` (subtract,
   divide) against the same functions on the CPU (noise estimate and
   medians bit-equal, images within 1e-5 of the plane's largest
   magnitude; no kernel), ``apply_arcsinh_stretch_cmd`` (gamma 1, 2.2),
   ``arcsinh_stretch_composite_cmd`` and ``apply_tone_composite_cmd``
   (defaults; linked STF, levels, a curve and SCNR) against the CPU
   (PNGs decoded, within one level; no kernel); the file commands cold
   and warm, the composite ones after a warm-up call, counters reset
   and read around each command, and each module call timed alone.
   (j) compose (``compose_path``): the 4096^2 field of (c) as R, with G
   and B rendered from its star list moved by sub-pixel shifts (and G
   rotated by 0.4 deg for the affine method), an L plane and four
   narrowband planes, written as FITS under build/; ``compose_rgb_cmd``
   at 3 x 4096^2 by phase correlation (K1, K2), by the affine method
   (K10, K11, K12) and with L; ``align_channels_cmd``,
   ``crop_channels_cmd`` and ``export_aligned_channels_cmd`` at 3 x
   4096^2; the wizard's colour commands (blend, auto WB, WB + SCNR,
   reset, restretch, update, clear) at 3 x ``COMP_HW``^2;
   ``process_drizzle_rgb`` and ``drizzle_rgb`` (3 x 4 frames of 1024^2
   → 2048^2: K1, K2, K7): offsets within 0.1 px of the generator's, the
   rotation within 0.1 deg, cache planes and FITS bit-equal to the
   module calls on the card, every PNG equal to the u8 of the card's
   planes, the modules against their plain path; each command cold and
   warm, counters reset and read around each, the alignment module
   calls timed alone.
   (k) FFT, deconvolution, cubes, tiles and synth (``cube_synth_path``):
   ``generate_synth_stack_cmd`` at the UI's defaults (5 x 2048^2) and at
   16 x 4096^2 with 3000 stars, then the ``stack`` command on those 16
   files (K1, K2, K3); ``generate_synth_cmd`` for each PSF and field
   type; ``deconvolve_rl_cmd`` on 4c's 4096^2 field, 20 iterations,
   with a Gaussian PSF and the estimated one (K10, K11);
   ``compute_fft_spectrum`` at 4096^2 and on a bench frame (8192^2
   FFT); a 2 GiB spectral cube (2048 x 512^2): ``get_cube_info``,
   ``process_cube_lazy_cmd``, ``get_cube_frame``, ``get_cube_spectrum``
   and ``process_cube_cmd`` on the card, with the peak device memory;
   ``generate_tiles`` at 4096^2 and ``generate_tiles_rgb`` on a
   composite filled by ``compose_rgb_cmd`` (K1, K2): synth files
   byte-identical between two calls, the commands' files equal to the
   module calls on the card, the card against the CPU (RL on a 512^2
   crop, the spectra, the cube stats on 64 channels, one tile level);
   each command cold and warm, counters reset and read around each.
   Then every entry point again through the plain versions on the card,
   compared with the kernel path, and both paths timed with CUDA events
   (``stack_images`` at 150 frames; ``drizzle_stack`` as is, band 64,
   and ``_drizzle_kernel_exact`` at
   band 1024, as the JAX package's drizzle bench ran it, and at one
   band; detection, alignment and the masked stretch with their host
   fetches);
5. report: one JSON line of per-kernel results (launches on the main
   paths, error against the plain version, kernel / plain / bound /
   library times), the card's name and power limit, and the final
   ``{"ok": true, "device": ...}`` line.

Tolerances. K1 box means: rtol 1e-5 (f32 sums in another order);
K1 min/max/count and K2 crops: exact. K3 and the combined planes: at
most max(3, 1e-5 * frames * pixels) pixels differ by more than 5e-3,
and the rejected counts by at most as many — borderline clip decisions
flip on the last ulp when the tap sums contract to FMA in another
order, and each of a pixel's values can be the one that flips. (The
JAX package's own bound, tests/test_onepass_kernel.py:36-40, is 3
pixels of 6 x 130 x 170 pixel-frames, 2.3e-5; here it is 1e-5 of the
pixel-frames.) K7, K8 and the drizzle image: bit-equal image and
rejected map (the kernel keeps the plain version's order of every sum
and cannot contract), weight map within rtol 1e-6. Offsets: within
0.1 px of the generator's integer shifts, 0.15 px of the drizzle
dithers, and 0.05 px between the kernel and plain paths. STF
parameters: within 1e-4. K10: sorted tiles and counts bit-equal. K11
and detection: the valid set identical; cy, cx, flux, fwhm, peak, npix
and snr within rel 1e-4, eccentricity within abs 0.01 (the JAX
package's bound between its two forms: f32 sums in another order),
recomputed in f64 from each side's second moments in the
well-conditioned form (``check_packed``).
K12: votes equal. Affine: the same method and inlier count on both
paths, transform parameters within 1e-3. K13: bit-equal. K9: as K7.
The parity drizzle against the one-band exact route: bit-equal, and
within the JAX package's tolerances (tests/test_reference_impl.py:
295-299: image atol 2e-4 / rtol 1e-6, weights atol 1e-5, rejected
equal). The masked stretch,
kernel path against plain path: the same stars, iterations and
convergence, coverage within 1e-5 and image within 1e-3 (the paths'
detections differ at f32 rounding; see ``masked_stretch_path``).

Bounds: the larger of the bytes a kernel must move (each input read
once, each output written once) over 3.35 TB/s and the f32 operations
counted for it over 67 TFLOP/s (the published peaks of one H100 SXM
at 700 W). K7 stops each pixel's walk at its cap-th present push, so
its bound counts the candidate values and weight products that this
run's data makes it read (``finalize_work``); K12's counts the pairs
inside the exact r0 window of this run's lists (``vote_bound``), with
the all-pairs figure beside it. Library times: one PyTorch call computing
the same function where there is one (K1: avg_pool2d for the box
means; K2: one advanced-index gather; K10 and its chunked route: one
torch.sort over the masked tiles), timed here and used nowhere in the
port.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

N_FRAMES, H, W = 16, 5655, 2206          # bench.py:43-44
BIG_N, BIG_HW, BIG_SHIFT = 24, 2048, 200  # stack_images workload
MANY_N, MANY_HW, MANY_SHIFT = 150, 1024, 100  # past K3's 128 frames
SCRATCH_FRAMES, SCRATCH_HW = (150, 300), 1024   # K3's scratch instance
DRZ_N, DRZ_HW, DRZ_BAND = 10, 4096, 1024  # bench_ops.py:366-397
DRZ_BAND64 = 64                          # drizzle_stack's own band
DRZ_SEED = 10
DET_HW, DET_STARS = 4096, 3000         # BASELINE.md:13
AFF_STARS_5K, AFF_STARS_4K = 90, 80    # bench_ops.py:299, BASELINE.md:17
DRA_N, DRA_HW = 4, 1024                # drizzle by the AFFINE method
MS_PEAKS = 4096                        # masked_stretch.py:206
MS_SCALE = 4000.0   # the star field / 4000: background 0.025, peaks < 0.8
FLIP_ATOL = 5e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_shifts(n: int, h: int, w: int, seed: int = 3) -> np.ndarray:
    """The integer shifts bench.make_frames(n, h, w, seed) applies,
    replayed from the same generator draws."""
    rng = np.random.default_rng(seed)
    rng.normal(120.0, 6.0, (h, w))
    rng.random(300)
    rng.random(300)
    rng.random(300)
    shifts = rng.integers(-12, 12, size=(n, 2))
    shifts[0] = 0
    return shifts


def wide_shift_frames(n: int, hw: int, max_shift: int, seed: int = 11):
    """n star-field frames of hw x hw, frame k = base rolled by
    shifts[k] (|shift| <= max_shift, frame 0 unshifted) plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.normal(100.0, 5.0, (hw, hw)).astype(np.float32)
    yy = np.arange(hw, dtype=np.float32)[:, None]
    xx = np.arange(hw, dtype=np.float32)[None, :]
    for sy, sx, amp in zip(rng.uniform(20, hw - 20, 400),
                           rng.uniform(20, hw - 20, 400),
                           rng.uniform(300, 2300, 400)):
        y0, x0 = int(sy) - 8, int(sx) - 8
        base[y0:y0 + 16, x0:x0 + 16] += (amp * np.exp(
            -((yy[y0:y0 + 16] - sy) ** 2 + (xx[:, x0:x0 + 16] - sx) ** 2)
            / 5.0)).astype(np.float32)
    shifts = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
    shifts[0] = 0
    frames = [np.roll(base, tuple(s), axis=(0, 1))
              + rng.normal(0, 2.0, (hw, hw)).astype(np.float32)
              for s in shifts]
    return frames, shifts


def make_frames(n, h, w, seed=3):
    """The bench workload of the JAX package's bench.py:make_frames
    (a star field, frame k rolled by integer shifts, plus noise): a copy,
    so this script imports nothing of that package;
    tests/test_torch_ops.py holds the two equal."""
    rng = np.random.default_rng(seed)
    base = rng.normal(120.0, 6.0, (h, w)).astype(np.float32)
    ys = rng.random(300) * (h - 40) + 20
    xs = rng.random(300) * (w - 40) + 20
    amps = 300.0 + rng.random(300) * 2000.0
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for sy, sx, amp in zip(ys, xs, amps):
        y0, y1 = max(int(sy) - 8, 0), min(int(sy) + 8, h)
        x0, x1 = max(int(sx) - 8, 0), min(int(sx) + 8, w)
        base[y0:y1, x0:x1] += (
            amp * np.exp(-((yy[y0:y1] - sy) ** 2 + (xx[:, x0:x1] - sx) ** 2)
                         / 5.0)).astype(np.float32)
    frames = []
    shifts = rng.integers(-12, 12, size=(n, 2))
    shifts[0] = 0
    for i in range(n):
        f = np.roll(base, tuple(shifts[i]), axis=(0, 1))
        f = f + rng.normal(0, 2.0, (h, w)).astype(np.float32)
        frames.append(f.astype(np.float32))
    return np.stack(frames)


def render_stars(h, w, ys, xs, amps, dy, dx, sigma, device, radius=7,
                 halo=0.0):
    """[h, w] f32 sum of Gaussian stars (peak amps, centres (ys + dy,
    xs + dx)), each evaluated analytically on a (2·radius + 1)^2
    window; ``halo`` adds a wing of that fraction of the peak with 5x
    the width (bench_ops.py:_star_field's halos)."""
    import torch
    r = torch.arange(-radius, radius + 1, device=device)
    cy = torch.as_tensor(ys + dy, dtype=torch.float64, device=device)
    cx = torch.as_tensor(xs + dx, dtype=torch.float64, device=device)
    iy = torch.round(cy).long()[:, None, None] + r[None, :, None]
    ix = torch.round(cx).long()[:, None, None] + r[None, None, :]
    d2 = (iy - cy[:, None, None]) ** 2 + (ix - cx[:, None, None]) ** 2
    s2 = 2.0 * sigma * sigma
    val = torch.as_tensor(amps, dtype=torch.float64, device=device)[
        :, None, None] * (torch.exp(-d2 / s2)
                          + halo * torch.exp(-d2 / (25.0 * s2)))
    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    img = torch.zeros(h * w, dtype=torch.float64, device=device)
    img.index_put_(((iy * w + ix)[ok],), val[ok], accumulate=True)
    return img.reshape(h, w).float()


def star_scene(h, w, n_stars, seed, device, amp=(300.0, 3000.0),
               sigma=1.5, noise=5.0):
    """A star field on the card: background 100 + noise, n_stars
    Gaussian stars at uniform positions and peak amplitudes. Returns
    (plane [h, w] f32, ys, xs, amps) with the generator's centres."""
    import torch
    rng = np.random.default_rng(seed)
    ys = rng.uniform(8, h - 8, n_stars)
    xs = rng.uniform(8, w - 8, n_stars)
    amps = rng.uniform(*amp, n_stars)
    g = torch.Generator(device=device).manual_seed(seed)
    img = 100.0 + noise * torch.randn((h, w), generator=g, device=device)
    return img + render_stars(h, w, ys, xs, amps, 0.0, 0.0, sigma,
                              device), ys, xs, amps


def detection_fields(dev):
    """The two detection fields, each (plane, ys, xs, amps, NaN patches):
    4096^2 with 3000 stars (BASELINE.md:13), three NaN patches, a +inf
    run and a -inf pixel; 5655 x 2206 with 200 stars (BASELINE.md:26), a
    NaN patch and a +inf run."""
    field, f_ys, f_xs, f_amps = star_scene(DET_HW, DET_HW, DET_STARS, 21,
                                           dev)
    dead = [(r, r + 40, c, c + 60) for r, c in (
        (DET_HW // 7, DET_HW // 5), (DET_HW // 2, 3 * DET_HW // 4),
        (6 * DET_HW // 7, DET_HW // 20))]     # NaN patches
    for y0, y1, x0, x1 in dead:
        field[y0:y1, x0:x1] = float("nan")
    field[3 * DET_HW // 10, 100:140] = float("inf")
    field[77, 3 * DET_HW // 4] = float("-inf")
    field5, g5_ys, g5_xs, g5_amps = star_scene(H, W, 200, 22, dev)
    dead5 = [(H // 2, H // 2 + 30, W // 2, W // 2 + 40)]
    for y0, y1, x0, x1 in dead5:
        field5[y0:y1, x0:x1] = float("nan")
    field5[10, :50] = float("inf")
    return (field, f_ys, f_xs, f_amps, dead), (field5, g5_ys, g5_xs,
                                               g5_amps, dead5)


def affine_scene(h, w, n_stars, seed, device):
    """The JAX package's affine bench pair (bench_ops.py:299-320),
    rendered here on the card: a star field with halos (amp 5000 · (0.1
    + Pareto(2) ≤ 9), FWHM 3), and the target sampled from it at the
    nearest pixel (truncation) of a 0.4 deg rotation about the centre
    plus a (3.2, -2.1) shift, with N(0, 1.5) noise."""
    import torch
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    base = 100.0 + 5.0 * torch.randn((h, w), generator=g, device=device)
    ys = rng.random(n_stars) * (h - 40) + 20
    xs = rng.random(n_stars) * (w - 40) + 20
    amps = 5000.0 * (0.1 + rng.pareto(2.0, n_stars).clip(max=9.0))
    base = base + render_stars(h, w, ys, xs, amps, 0.0, 0.0, 3.0 / 2.3548,
                               device, radius=14, halo=0.06)
    th = math.radians(0.4)
    ct, st = math.cos(th), math.sin(th)
    cy, cx = h / 2.0, w / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    sx = ct * (xx - cx) - st * (yy - cy) + cx + 3.2
    sy = st * (xx - cx) + ct * (yy - cy) + cy - 2.1
    xi = torch.clamp(sx.to(torch.int64), 0, w - 1)
    yi = torch.clamp(sy.to(torch.int64), 0, h - 1)
    target = base[yi, xi] + 1.5 * torch.randn((h, w), generator=g,
                                              device=device)
    return base, target


def isolated_bright(ys, xs, amps, h, w, min_amp, sep=15.0, margin=25.0,
                    dead=()):
    """Indices of generated stars with peak >= min_amp, no other star
    within ``sep`` px, ``margin`` px inside the plane and outside the
    ``dead`` rectangles (y0, y1, x0, x1) grown by the margin."""
    d2 = (ys[:, None] - ys[None, :]) ** 2 + (xs[:, None] - xs[None, :]) ** 2
    np.fill_diagonal(d2, np.inf)
    keep = (amps >= min_amp) & (d2.min(axis=1) > sep * sep)
    keep &= (ys > margin) & (ys < h - margin) & (xs > margin) & \
        (xs < w - margin)
    for y0, y1, x0, x1 in dead:
        keep &= ~((ys > y0 - margin) & (ys < y1 + margin)
                  & (xs > x0 - margin) & (xs < x1 + margin))
    return np.flatnonzero(keep)


def check_positions(what, det, ys, xs, idx, tol=0.3):
    """Every generated star of ``idx`` has a detection within ``tol``
    px; returns the largest distance."""
    sy = np.array([s.y for s in det.stars])
    sx = np.array([s.x for s in det.stars])
    dist = np.sqrt(((ys[idx, None] - sy[None, :]) ** 2
                    + (xs[idx, None] - sx[None, :]) ** 2).min(axis=1))
    log(f"  {what}: {len(det.stars)} stars; {len(idx)} isolated bright "
        f"generated stars, farthest detection {float(dist.max()):.4f} px")
    if len(idx) < 10 or float(dist.max()) > tol:
        raise AssertionError(f"{what}: isolated bright stars off by up to "
                             f"{float(dist.max())} px (n={len(idx)})")
    return float(dist.max())


def ecc64(stats9):
    """Eccentricity sqrt(1 - l2/l1) of [K, 9] window rows, in f64 with
    the eigenvalue gap in the well-conditioned form
    sqrt(((sxx - syy)/2)^2 + sxy^2). The f32 form of the detection,
    sqrt(trace^2/4 - det), cancels: one ulp in a moment moves a round
    star's ecc by a few 0.01 there."""
    import torch
    sxx, syy, sxy = stats9[:, 5:8].double().unbind(1)
    half = (sxx + syy) / 2
    disc = torch.sqrt(((sxx - syy) / 2) ** 2 + sxy ** 2)
    l1 = half + disc
    l2 = torch.clamp(half - disc, min=0.0)
    return torch.where(l1 > 1e-15, torch.sqrt(torch.clamp(
        (l1 - l2) / l1.clamp(min=1e-300), 0.0, 1.0)), 0.0)


def check_packed(what, got, ref, got9, ref9) -> float:
    """Packed detection records (kernel vs plain) and the window rows
    they were made from: the valid set identical; cy, cx, flux, fwhm,
    peak, npix, snr within rel 1e-4; the eccentricity (``ecc64`` of each
    side's rows) within abs 0.01. Returns the largest relative error."""
    import torch
    if not torch.equal(got[8], ref[8]):
        raise AssertionError(f"{what}: valid sets differ")
    v = ref[8] > 0.5
    worst = 0.0
    for i in (0, 1, 2, 3, 5, 6, 7):
        rel = (got[i] - ref[i]).abs() / ref[i].abs().clamp(min=1e-6)
        worst = max(worst, float(torch.where(v, rel, 0.0).max()))
    d_ecc = float(torch.where(v.cpu(), (ecc64(got9) - ecc64(ref9)).abs().cpu(),
                              0.0).max())
    log(f"  {what}: {int(v.sum())} valid, max rel err {worst:.3e}, ecc "
        f"(f64 from the moments) max|d| {d_ecc:.3e}")
    if worst >= 1e-4 or d_ecc >= 0.01:
        raise AssertionError(f"{what}: beyond rel 1e-4 / ecc 0.01")
    return worst


def calibration_scene(n, hw, seed, device, n_cal=16):
    """Synthetic raw bias, dark and flat stacks (n_cal frames each) and n
    raw light frames of hw x hw: lights = bias + dark + flat * (sky +
    stars moved by sub-pixel dithers in +-2 px) + noise. Returns (bias,
    darks, flats, lights, dithers [n, 2] as (dy, dx), frame 0 at 0)."""
    import torch
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device).manual_seed(seed)

    def noise(shape, sigma):
        return torch.randn(shape, generator=g, device=device) * sigma

    yy = torch.linspace(-1, 1, hw, device=device)[:, None]
    xx = torch.linspace(-1, 1, hw, device=device)[None, :]
    bias_true = 500.0 + 2.0 * torch.sin(yy * 40.0) + 0.0 * xx
    dark_true = 20.0 + torch.zeros(hw, hw, device=device)
    hot = torch.as_tensor(rng.integers(0, hw * hw, 2000), device=device)
    dark_true.view(-1)[hot] += 800.0
    flat_true = 1.0 - 0.3 * (yy * yy + xx * xx)
    bias = torch.stack([bias_true + noise((hw, hw), 1.5)
                        for _ in range(n_cal)])
    darks = torch.stack([bias_true + dark_true + noise((hw, hw), 1.5)
                         for _ in range(n_cal)])
    flats = torch.stack([bias_true + dark_true + 20000.0 * flat_true
                         + noise((hw, hw), 50.0) for _ in range(n_cal)])
    n_stars = max(64, hw * hw // 6000)
    ys = rng.uniform(10, hw - 10, n_stars)
    xs = rng.uniform(10, hw - 10, n_stars)
    amps = rng.uniform(200.0, 4000.0, n_stars)
    dith = rng.uniform(-2.0, 2.0, (n, 2))
    dith[0] = 0.0
    lights = torch.stack([
        bias_true + dark_true + flat_true * (
            300.0 + render_stars(hw, hw, ys, xs, amps, dy, dx, 1.6, device))
        + noise((hw, hw), 5.0) for dy, dx in dith])
    return bias, darks, flats, lights, dith


def flip_bound(n_frames: int, npix: int) -> int:
    return max(3, int(1e-5 * n_frames * npix))


def check_flips(what: str, n_frames: int, got, ref, got_rej, ref_rej):
    """K3-style comparison of planes combined from ``n_frames``
    frames; returns (max_abs_err, flips)."""
    import torch
    d = (got - ref).abs()
    both_nan = torch.isnan(got) & torch.isnan(ref)
    d = torch.where(both_nan, torch.zeros_like(d), d)
    if torch.isnan(d).any():
        raise AssertionError(f"{what}: NaN where the reference is finite")
    flips = int((d > FLIP_ATOL).sum())
    bound = flip_bound(n_frames, got.numel())
    drej = abs(int(got_rej) - int(ref_rej))
    log(f"  {what}: max|d|={float(d.max()):.3e} flips={flips} "
        f"(bound {bound}) rejected {int(got_rej)} vs {int(ref_rej)}")
    if flips > bound or drej > bound:
        raise AssertionError(f"{what}: {flips} flips / rejected off by "
                             f"{drej}, bound {bound}")
    return float(d.max()), flips


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls between CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernel_name(sym: str) -> str:
    """The ``*_kernel`` identifier inside a mangled symbol."""
    m = re.search(r"[a-z][a-z_]*_kernel", sym)
    return m.group(0) if m else sym


def ptxas_summary(build_log: str):
    """[(kernel, registers, smem bytes, stack bytes, spill st, spill ld)]
    from nvcc -Xptxas -v output; every entry must target sm_90a."""
    rows = []
    blocks = re.split(r"Compiling entry function ", build_log)[1:]
    for b in blocks:
        m = re.match(r"'([^']+)' for '(\w+)'", b)
        if m is None:
            continue
        sym, arch = m.groups()
        if arch != "sm_90a":
            raise AssertionError(f"{sym} compiled for {arch}, not sm_90a")
        name = _kernel_name(sym)
        tmpl = re.findall(r"L([ib])(\d+)E", sym)
        if tmpl:
            name += "<" + ",".join(v if t == "i" else ("fused", "plain")[
                v == "0"] for t, v in tmpl) + ">"
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", b)
        regs = re.search(r"Used (\d+) registers", b)
        smem = re.search(r"(\d+) bytes smem", b)
        rows.append((name, int(regs.group(1)),
                     int(smem.group(1)) if smem else 0,
                     int(stack.group(1)), int(stack.group(2)),
                     int(stack.group(3))))
    return rows


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for the work on one H100 —
    the larger of the bytes over the HBM rate and the f32 operations
    over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_finalize(what: str, got, ref) -> dict:
    """K7/K8 against the plain version: image and rejected map
    bit-equal, the weight map within rtol 1e-6."""
    import torch
    d_img = float((got[0] - ref[0]).abs().max())
    d_wgt = float((got[1] - ref[1]).abs().max())
    log(f"  {what}: image max|d|={d_img:.3e}, weights max|d|="
        f"{d_wgt:.3e}, rejected {int(got[2].sum())} vs "
        f"{int(ref[2].sum())}")
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])):
        raise AssertionError(f"{what}: image or rejected map not "
                             f"bit-equal to the plain version")
    if not torch.allclose(got[1], ref[1], rtol=1e-6, atol=0.0):
        raise AssertionError(f"{what}: weight map beyond rtol 1e-6")
    return {"max_abs_err": d_img, "weights_max_abs_err": d_wgt}


def vote_cases(rng, t: int) -> dict:
    """Adversarial triangle lists of ``t`` rows for K12 against its plain
    version: name → (ref_ratios [t, 2] f32, ref_verts [t, 3] i32,
    tgt_ratios, tgt_verts). Live rows come first and +inf padding fills
    each list to ``t`` rows, unless a case says otherwise."""
    tol = np.float32(0.02)
    inf = np.float32(np.inf)

    def ids(n, lo=0, hi=64):
        return rng.integers(lo, hi, (n, 3)).astype(np.int32)

    def pad(r, v=None):
        r = np.asarray(r, np.float32).reshape(-1, 2)
        v = ids(len(r)) if v is None else v
        return (np.concatenate([r, np.full((t - len(r), 2), inf)]),
                np.concatenate([v, ids(t - len(r))]))

    def uniform(n, lo=1.0, hi=3.0):
        return rng.uniform(lo, hi, (n, 2)).astype(np.float32)

    cases = {}
    # ratios at r -/+ tol and one f32 ulp either side, in both ratios, at
    # three scales of r (near 0 the difference r - t rounds)
    n = t // 8
    r = np.concatenate([uniform(n - 2 * (n // 3)),
                        uniform(n // 3, -0.05, 0.05),
                        uniform(n // 3, 1e5, 1e6)])
    edges = []
    for s in (np.float32(-1.0), np.float32(1.0)):
        e = r + s * tol
        edges += [e, np.nextafter(e, inf), np.nextafter(e, -inf)]
    tgt = np.concatenate(
        [np.stack([edges[k][:, 0], edges[(k + 1) % 6][:, 1]], 1)
         for k in range(6)] + [np.stack([edges[4][:, 0], r[:, 1]], 1)])
    cases["window_edges"] = (*pad(r), *pad(tgt[rng.permutation(len(tgt))]))
    # many tied r0 values, 0.02 apart in decimal
    m = t // 2
    ties = np.float32([1.25, 1.5, 1.52, 1.54, 2.0])

    def tied(k):
        return np.stack([rng.choice(ties, k),
                         rng.uniform(1.5, 2.5, k).astype(np.float32)], 1)
    cases["tied_r0"] = (*pad(tied(m)), *pad(tied(m)))

    # every r0 equal: the windows are the whole lists (all pairs)
    def flat(k):
        return np.stack([np.full(k, 1.7, np.float32),
                         rng.uniform(1.0, 4.0, k).astype(np.float32)], 1)
    cases["all_equal_r0"] = (*pad(flat(t)), *pad(flat(t)))

    # the padding shuffled into the middle, NaN in either ratio, -inf
    def holed():
        x = np.concatenate([uniform(m), np.full((t - m, 2), inf)])
        x[rng.random(t) < 0.05, 0] = np.nan
        x[rng.random(t) < 0.05, 1] = np.nan
        x[rng.random(t) < 0.02, rng.integers(0, 2)] = -inf
        return x[rng.permutation(t)], ids(t)
    cases["inf_nan_shuffled"] = (*holed(), *holed())
    # vertex ids outside [0, 64)
    k = t // 3
    cases["ids_outside"] = (*pad(uniform(k), ids(k, -8, 72)),
                            *pad(uniform(k), ids(k, -8, 72)))
    # one and three live triangles, near one another
    near = np.float32([[1.6, 2.1], [1.61, 2.09], [1.62, 2.2]])
    cases["one_live"] = (*pad(near[:1]),
                         *pad(np.concatenate([near, uniform(k)])))
    cases["three_live"] = (*pad(near), *pad(near[::-1].copy()))
    # a ref list with no live row (+inf and NaN rows only)
    dead = np.full((t, 2), inf)
    dead[::3, 1] = np.nan
    cases["no_live_ref"] = (dead, ids(t), *pad(uniform(k)))
    return cases


def star_mask_cases(rng, h: int, w: int, k: int) -> dict:
    """Adversarial star records for K13 against its plain version (softness
    4): name → (xs, ys, radii [K] f32, h, w); ``k`` slots, 10 % of them
    with radius 0, unless a case says otherwise."""
    def rec(xs, ys, radii, hh=h, ww=w):
        radii = np.asarray(radii, np.float32).copy()
        radii[rng.random(len(radii)) < 0.1] = 0.0
        return (np.asarray(xs, np.float32), np.asarray(ys, np.float32),
                radii, hh, ww)

    cases = {
        # exact .5 positions: half-to-even anchors
        "half_positions": rec(rng.integers(-60, w + 60, k) + 0.5,
                              rng.integers(-60, h + 60, k) + 0.5,
                              rng.uniform(0.5, 20, k)),
        # every star up to 200 px off the plane
        "off_plane_200": rec(
            np.where(rng.random(k) < 0.5, -rng.uniform(0, 200, k),
                     w + rng.uniform(0, 200, k)),
            rng.uniform(-200, h + 200, k), rng.uniform(1, 120, k)),
        # radius + softness past the 48-pixel half-window
        "reach_past_window": rec(rng.uniform(-30, w + 30, k),
                                 rng.uniform(-30, h + 30, k),
                                 rng.uniform(45, 150, k)),
        # 600 stars in one 128^2 tile: several chunks of 256 records
        "dense_cluster": rec(rng.uniform(128, 256, 600),
                             rng.uniform(0, 128, 600),
                             rng.uniform(0.5, 6, 600)),
        "single_slot": rec([w * 0.3], [h * 0.6], [7.5]),
    }
    oh, ow = h // 2 + 45, w // 2 + 77   # not multiples of 128
    cases["odd_plane"] = rec(rng.uniform(-60, ow + 60, k),
                             rng.uniform(-60, oh + 60, k),
                             rng.uniform(0, 40, k), oh, ow)
    cases["single_slot"][2][0] = 7.5    # never drawn as a zero radius
    return cases


def check_star_mask(field, max_peaks: int) -> dict:
    """K13 against its plain version, bit-equal: on the star records the
    masked stretch paints on ``field`` (detection at ``max_peaks``,
    device dedupe, FWHM filter, radius FWHM·2.5, softness 4), on 4096
    synthetic slots (up to 200 px off the plane, 10 % zero radii, radii
    up to 40) and on ``star_mask_cases``. Returns the report entry."""
    import torch
    from astroburst_tpu_torch.analysis import star_detection as SD
    from astroburst_tpu_torch.imaging.masked_stretch import (
        MaskedStretchConfig, _mask_config, _paint_records)
    from astroburst_tpu_torch.imaging.star_mask_kernel import (
        HALF, paint_mask, paint_mask_plain)
    from astroburst_tpu_torch.runtime import kernels as K
    h, w = field.shape
    dev = field.device
    packed = SD._detect(field, SD._tile_size(h, w), 5.0, max_peaks)
    xs, ys, radii, n = _paint_records(packed,
                                      _mask_config(MaskedStretchConfig()))
    srng = np.random.default_rng(26)
    k = 4096
    syn = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        srng.uniform(-200, w + 200, k), srng.uniform(-200, h + 200, k),
        np.where(srng.random(k) < 0.1, 0.0, srng.uniform(0, 40, k))))
    sets = {"detection": (xs, ys, radii, h, w),
            "synthetic": (*syn, h, w)}
    for tag, (cx, cy, cr, ch, cw) in star_mask_cases(srng, h, w, k).items():
        sets[tag] = (*(torch.as_tensor(a, device=dev) for a in (cx, cy, cr)),
                     ch, cw)
    for tag, (*rec, ch, cw) in sets.items():
        got = paint_mask(*rec, 4.0, ch, cw)
        ref = paint_mask_plain(*rec, 4.0, ch, cw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K13 differs from the plain version on "
                                 f"the {tag} stars")
        log(f"[K13] paint_mask {ch}x{cw}, {tag}: {int((rec[2] > 0).sum())} "
            f"painted of {rec[0].numel()} slots, bit-equal, coverage "
            f"{float((got > 0.01).float().mean()):.4f}")
    # the launch alone, without the wrapper's checks and allocation
    plane = torch.empty((h, w), device=dev)

    def launch_alone():
        K.launch("abt_star_mask", xs.data_ptr(), ys.data_ptr(),
                 radii.data_ptr(), xs.numel(), 4.0, h, w, plane.data_ptr(),
                 K.stream_handle(plane))

    entry = {"max_abs_err": 0.0, "stars": int(n), "slots": xs.numel(),
             "cases": list(sets),
             "ms": cuda_ms(lambda: paint_mask(xs, ys, radii, 4.0, h, w), 20),
             "ms_launch_alone": cuda_ms(launch_alone, 20),
             "plain_ms": cuda_ms(lambda: paint_mask_plain(xs, ys, radii,
                                                          4.0, h, w), 3),
             "ms_synthetic_4096": cuda_ms(lambda: paint_mask(*syn, 4.0, h, w),
                                          20),
             "library_ms": None}
    # bytes: the three star rows and the plane; operations: ~14 per pixel
    # of each painted window inside the plane
    y0 = torch.clamp(torch.round(ys), 0, h)
    x0 = torch.clamp(torch.round(xs), 0, w)
    rows = torch.clamp(y0 + HALF, max=h) - torch.clamp(y0 - HALF, min=0)
    cols = torch.clamp(x0 + HALF, max=w) - torch.clamp(x0 - HALF, min=0)
    cover = float(torch.where(radii > 0, rows * cols, 0.0).sum())
    entry.update(zip(("bound_ms", "bound_by"), bound(
        4 * h * w + 12 * xs.numel(), 14 * cover)))
    return entry


def device_ms(fn, reps: int, kernel: str, cold: bool = False) -> float:
    """Mean device time, in ms, of the CUDA kernels whose name holds
    ``kernel`` (one a call of ``fn``), from torch.profiler over ``reps``
    calls after one warm-up call. ``cold``: 128 MB are written between
    calls, so the kernel finds its inputs out of the 50 MB L2, as a
    caller that has just streamed a larger plane does. The profiler at
    times drops spans of a window (one of 20, or all); the window is
    then taken again, up to three times, and the mean is over the spans
    it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if cold:
        flush = torch.empty(32 * 2 ** 20, device="cuda")
        call = fn

        def fn():
            flush.zero_()
            call()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if reps // 2 <= len(spans) <= reps:
            return sum(spans) / len(spans) / 1e3
    raise AssertionError(f"{kernel}: {len(spans)} device spans in {reps} "
                         f"calls")


def window_cases(rng, h: int = 200, w: int = 260) -> dict:
    """Adversarial windows for K11 against its plain version: name →
    (plane [h, w] f32, pys, pxs [K] i32, threshold, bg_med, n_valid).
    Background 100 with noise 2, threshold 150, bg_med 100."""
    thr, bg = np.float32(150.0), np.float32(100.0)
    cy, cx = h // 2, w // 2
    yy, xx = np.mgrid[0:h, 0:w]

    def plane():
        return rng.normal(100.0, 2.0, (h, w)).astype(np.float32)

    def star(p, y, x, amp=400.0, sigma=2.0):
        p += (amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                           / (2 * sigma ** 2))).astype(np.float32)
        return p

    def peaks(*yx):
        return (np.int32([y for y, _ in yx]), np.int32([x for _, x in yx]))

    cases = {}
    # a square spiral ridge from the centre, arms 2 px apart: the path to
    # the window's edge is ~200 steps, so 20 rounds stop inside it
    p = plane()
    y, x, step, d = cy, cx, 2, 0
    p[y, x] = 300.0
    inside = True
    while inside:
        for _ in range(2):
            dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[d % 4]
            for _ in range(step):
                y, x = y + dy, x + dx
                if abs(y - cy) > 20 or abs(x - cx) > 20:
                    inside = False
                    break
                p[y, x] = 200.0
            d += 1
        step += 2
    cases["spiral"] = (p, *peaks((cy, cx)), thr, bg, 1)
    # centres that are NaN, below the threshold, exactly at it, +-inf
    p = plane()
    for y, x in ((40, 50), (40, 130), (40, 210), (150, 50), (150, 130)):
        star(p, y, x)
    p[40, 50] = np.nan
    p[40, 130] = 120.0                   # below; its neighbours are above
    p[40, 210] = thr                     # exactly at the threshold
    p[150, 50] = np.inf
    p[150, 131] = -np.inf                # inside the blob, next to the peak
    p[151, 129] = np.inf
    cases["centre_nan_below_at_inf"] = (
        p, *peaks((40, 50), (40, 130), (40, 210), (150, 50), (150, 130)),
        thr, bg, 5)
    # a ring exactly at the threshold cuts a bright core from an outer ring
    p = plane()
    r = np.maximum(np.abs(yy - cy), np.abs(xx - cx))
    p[r <= 1] = 300.0
    p[r == 2] = thr
    p[(r >= 3) & (r <= 5)] = 200.0
    cases["ring_at_threshold"] = (p, *peaks((cy, cx)), thr, bg, 1)
    # every pixel above the threshold (1681 members), and a window that
    # hangs over the plane's corner
    p = plane() + 100.0
    cases["all_above"] = (p, *peaks((cy, cx), (5, w - 3)), thr, bg, 2)
    # peaks at the corners and on each edge
    edge = ((0, 0), (h - 1, w - 1), (0, w // 2), (h - 1, w // 3),
            (h // 2, 0), (h // 3, w - 1))
    p = plane()
    for y, x in edge:
        star(p, y, x, sigma=3.0)
    cases["corners_and_edges"] = (p, *peaks(*edge), thr, bg, len(edge))
    # a component that reaches past the window's border
    p = plane()
    p[(yy - cy) ** 2 + (xx - cx - 12) ** 2 <= 18 ** 2] = 250.0
    p[(np.abs(yy - cy + 15) <= 1) & (xx < cx)] = 250.0   # a long bar
    cases["past_the_border"] = (p, *peaks((cy, cx)), thr, bg, 1)
    # a star field: 16 slots, 11 live (dead rows are zero), and none live
    p = plane()
    ys = rng.integers(0, h, 16)
    xs = rng.integers(0, w, 16)
    for y, x in zip(ys, xs):
        star(p, y, x, amp=float(rng.uniform(100, 900)),
             sigma=float(rng.uniform(1.0, 3.0)))
    cases["field_dead_tail"] = (p, ys.astype(np.int32), xs.astype(np.int32),
                                thr, bg, 11)
    cases["no_live_peak"] = (p, ys.astype(np.int32), xs.astype(np.int32),
                             thr, bg, 0)
    return cases


def check_window_stats(field, field5) -> dict:
    """K11 against its plain version on the peaks of the two detection
    fields (4096^2 with NaN patches, 5655 x 2206), each through
    ``check_packed`` as well, and on ``window_cases``: npix equal, the
    rest within rtol 1e-4 / atol 1e-3. Times the wrapper, the launch
    alone and the kernel's device time on the 4096^2 field. Returns the
    report entry."""
    import torch
    from astroburst_tpu_torch.analysis import star_detection as SD
    from astroburst_tpu_torch.analysis.window_kernel import (
        window_stats, window_stats_plain)
    from astroburst_tpu_torch.runtime import kernels as K
    dev = field.device

    def held(what, got, ref):
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0], ref[:, 0]) or \
                not torch.allclose(got, ref, rtol=1e-4, atol=1e-3):
            raise AssertionError(f"K11 differs from the plain version on "
                                 f"{what}")
        return float((got - ref).abs().max())

    sets = {}
    errs, rels = [], []
    for tag, img in (("field_4096", field), ("field_5655x2206", field5)):
        h, w = img.shape
        bg_med, bg_sig = SD._background(img, SD._tile_size(h, w))
        thr = bg_med + 5.0 * bg_sig
        pys, pxs, _, n_valid = SD._peaks(img, thr, SD.MAX_PEAKS)
        sets[tag] = (img, pys, pxs, thr, bg_med, n_valid)
        got = window_stats(*sets[tag])
        ref = window_stats_plain(*sets[tag])
        errs.append(held(tag, got, ref))
        tile = SD._tile_size(h, w)
        rels.append(check_packed(
            f"[K11] window_stats {h}x{w}, {int(n_valid)} live of "
            f"{SD.MAX_PEAKS} peaks",
            SD._detect(img, tile, 5.0, SD.MAX_PEAKS),
            SD._detect(img, tile, 5.0, SD.MAX_PEAKS, plain=True), got, ref))
    for tag, (p, pys, pxs, thr, bg, nv) in window_cases(
            np.random.default_rng(27)).items():
        wargs = (torch.as_tensor(p, device=dev),
                 *(torch.as_tensor(a, device=dev) for a in (pys, pxs)),
                 *(torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in (thr, bg)),
                 torch.tensor(nv, dtype=torch.int32, device=dev))
        got = window_stats(*wargs)
        ref = window_stats_plain(*wargs)
        errs.append(held(tag, got, ref))
        log(f"[K11] window_stats {tag}: npix equal "
            f"{got[:, 0].int().tolist()[:8]}, max|d| {errs[-1]:.3e}")
    wargs = sets["field_4096"]
    img, pys, pxs, thr, bg_med, n_valid = wargs
    h, w = img.shape
    k = pys.shape[0]
    out = torch.empty((k, 9), device=dev)

    def launch_alone():   # the C entry on preallocated buffers
        K.launch("abt_window_stats", img.data_ptr(), h, w, pys.data_ptr(),
                 pxs.data_ptr(), k, n_valid.data_ptr(), thr.data_ptr(),
                 bg_med.data_ptr(), out.data_ptr(), K.stream_handle(img))

    nv = int(n_valid)
    ref = window_stats_plain(*wargs)
    entry = {"max_abs_err": max(errs), "max_rel_err_packed": max(rels),
             "live_peaks": nv,
             "cases": list(sets) + list(window_cases(
                 np.random.default_rng(27))),
             "ms": cuda_ms(lambda: window_stats(*wargs), 50),
             "ms_launch_alone": cuda_ms(launch_alone, 50),
             "device_ms": device_ms(launch_alone, 20, "window_stats_kernel"),
             "device_ms_cold": device_ms(launch_alone, 20,
                                         "window_stats_kernel", cold=True),
             "plain_ms": cuda_ms(lambda: window_stats_plain(*wargs), 5),
             "library_ms": None}
    # bytes: each live window's pixels once, the centres and the [K, 9]
    # rows; operations: two per window pixel for the threshold mask, the
    # fill on 64-bit row masks (~17 per row and round, 20 rounds at
    # most) and ~15 per member pixel for the moments
    k11_ops = nv * (41 * 41 * 2 + 20 * 41 * 17) + 15 * float(ref[:nv, 0].sum())
    entry.update(zip(("bound_ms", "bound_by"), bound(
        4 * nv * 41 * 41 + 4 * (2 + 9) * k, k11_ops)))
    log(f"[K11] {h}x{w}, {nv} live peaks: wrapper {entry['ms']:.4f} ms, "
        f"launch alone {entry['ms_launch_alone']:.4f} ms, device "
        f"{entry['device_ms']:.4f} ms, {entry['device_ms_cold']:.4f} from a "
        f"cold L2 (bound {entry['bound_ms']:.4f})")
    return entry


def crop_cases(rng, h: int = 560, size_r: int = 512) -> dict:
    """Crop sets for K2 against its plain version: name → (stack [N, h,
    w] f32, y0s, x0s [n] i64, size_r, size_c, frame0). Widths 2206,
    2205 and 2048, crop widths 512, 509 and 1, x0 at every residue mod 4
    (rounded to 128 as the refine origins are, and off it), frame0 0 and
    1 (with frame0 1 the frames 1.. of an odd-sized plane start 8 B off
    a 16-byte boundary); then origins past every side of the plane
    (clamped)."""
    cases = {}
    for w in (2206, 2205, 2048):
        for size_c in (512, 509, 1):
            for frame0 in (0, 1):
                n = 8
                stack = rng.normal(0, 1, (n + frame0, h, w)).astype(
                    np.float32)
                x0s = rng.integers(0, (w - size_c) // 128 + 1, n) * 128 + \
                    np.arange(n) % 4
                x0s = np.minimum(x0s, w - size_c)
                x0s[0] = w - size_c          # against the right edge
                y0s = rng.integers(0, h - size_r + 1, n)
                cases[f"w{w}_c{size_c}_f{frame0}"] = (
                    stack, y0s.astype(np.int64), x0s.astype(np.int64),
                    size_r, size_c, frame0)
    stack = rng.normal(0, 1, (6, h, 2206)).astype(np.float32)
    cases["clamped"] = (stack, np.int64([-7, h + 100, 3, -1, h, 0]),
                        np.int64([5000, -3, -128, 2206, 1, 1697]),
                        size_r, 509, 0)
    return cases


def check_crops(stack, y0s, x0s) -> dict:
    """K2 against its plain version, bit-equal: the bench crops (frames
    1.. of ``stack`` at the refine origins ``y0s``, ``x0s``, 512^2, as
    phase_correlate_stack takes them) and ``crop_cases``. Times the
    wrapper, the launch alone, the kernel's device time, the plain
    version and one advanced-index gather on the bench crops. Returns
    the report entry."""
    import torch
    from astroburst_tpu_torch.ops.crop_kernel import (gather_crops,
                                                      gather_crops_plain)
    from astroburst_tpu_torch.runtime import kernels as K
    dev = stack.device
    n, h, w = stack.shape
    c1 = gather_crops(stack, y0s, x0s, 512, 512, frame0=1)
    c2 = gather_crops_plain(stack, y0s, x0s, 512, 512, frame0=1)
    torch.cuda.synchronize()
    if not torch.equal(c1, c2):
        raise AssertionError("K2 crops differ from the plain version")
    log(f"[K2] gather_crops {n - 1} x 512^2 at origins "
        f"{list(zip(y0s.tolist(), x0s.tolist()))[:3]}...: bit-equal")
    cases = crop_cases(np.random.default_rng(28))
    for tag, (s, cy0, cx0, size_r, size_c, frame0) in cases.items():
        st = torch.as_tensor(s, device=dev)
        yo, xo = (torch.as_tensor(a, device=dev) for a in (cy0, cx0))
        for view in ((st, frame0),) + (((st[1:], 0),) if frame0 else ()):
            got = gather_crops(view[0], yo, xo, size_r, size_c, view[1])
            ref = gather_crops_plain(view[0], yo, xo, size_r, size_c,
                                     view[1])
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K2 differs from the plain version "
                                     f"on {tag}")
        log(f"[K2] gather_crops {tag}: {len(cy0)} x {size_r}x{size_c}, "
            f"x0 mod 4 {sorted(set((cx0 % 4).tolist()))}: bit-equal"
            + (" (also on the view frames 1..)" if frame0 else ""))
    n_out = n - 1
    out = torch.empty((n_out, 512, 512), device=dev)

    def launch_alone():   # the C entry on preallocated buffers
        K.launch("abt_gather_crops", stack.data_ptr(), y0s.data_ptr(),
                 x0s.data_ptr(), n_out, h, w, 512, 512, 1, out.data_ptr(),
                 K.stream_handle(stack))

    fr_i = torch.arange(1, n, device=dev)[:, None, None]
    row_i = (y0s[:, None] + torch.arange(512, device=dev))[:, :, None]
    col_i = (x0s[:, None] + torch.arange(512, device=dev))[:, None, :]
    entry = {"max_abs_err": 0.0, "cases": ["bench"] + list(cases),
             "ms": cuda_ms(lambda: gather_crops(stack, y0s, x0s, 512, 512,
                                                frame0=1), 50),
             "ms_launch_alone": cuda_ms(launch_alone, 50),
             "device_ms": device_ms(launch_alone, 20, "gather_crops_kernel"),
             "device_ms_cold": device_ms(launch_alone, 20,
                                         "gather_crops_kernel", cold=True),
             "plain_ms": cuda_ms(lambda: gather_crops_plain(
                 stack, y0s, x0s, 512, 512, frame0=1), 20),
             "library_ms": cuda_ms(lambda: stack[fr_i, row_i, col_i], 50),
             "library": "one advanced-index gather"}
    entry.update(zip(("bound_ms", "bound_by"), bound(
        2 * 4 * n_out * 512 * 512, 0)))
    log(f"[K2] {n_out} x 512^2: wrapper {entry['ms']:.4f} ms, launch alone "
        f"{entry['ms_launch_alone']:.4f} ms, device "
        f"{entry['device_ms']:.4f} ms, {entry['device_ms_cold']:.4f} from "
        f"a cold L2 (bound {entry['bound_ms']:.4f})")
    return entry


def window_pairs(ref_ratios, tgt_ratios, tol: float = 0.02) -> int:
    """The pairs of live triangles (both ratios finite) inside the exact
    r0 window |r0 - t0| <= tol: the work K12 needs for these inputs."""
    import torch
    r = ref_ratios[torch.isfinite(ref_ratios).all(dim=1), 0]
    t = tgt_ratios[torch.isfinite(tgt_ratios).all(dim=1), 0]
    return sum(int((torch.abs(r[c:c + 2048, None] - t[None, :]) <= tol).sum())
               for c in range(0, r.numel(), 2048))


def vote_bound(vargs) -> tuple:
    """K12's bound on its inputs: the larger of the input bytes, one read
    and one write of each list for the sort and the table, over the HBM
    rate, and 6 operations (two differences, two abs, two compares) per
    pair inside the exact r0 window over the f32 peak; and the all-pairs
    figure (6 operations for every pair) beside it."""
    nbytes = sum(a.numel() * 4 for a in vargs) * 3 + 4 * 64 * 64
    pairs = window_pairs(vargs[0], vargs[2])
    return (*bound(nbytes, 6 * pairs), pairs,
            bound(nbytes, 6 * vargs[0].shape[0] * vargs[2].shape[0])[0])


def check_vote(dev) -> dict:
    """K12 against its plain version, equal: at the full triangle count of
    60 stars (a rotated, shifted and jittered copy as the target, padded
    to TRI_CAP) and on ``vote_cases`` at TRI_CAP rows; times the call,
    its C entry alone (the counting sort and the vote, without the
    wrapper's checks and allocations) and the all-pairs worst case
    (every r0 equal). Returns the report entry."""
    import torch
    from astroburst_tpu_torch.alignment import affine as AF
    from astroburst_tpu_torch.alignment import vote_kernel as VK
    from astroburst_tpu_torch.runtime import kernels as K
    vrng = np.random.default_rng(23)
    stars_r = vrng.random((60, 2)) * 4000
    rot = np.array([[math.cos(0.007), -math.sin(0.007)],
                    [math.sin(0.007), math.cos(0.007)]])
    stars_t = stars_r @ rot.T + np.array([3.2, -2.1]) + vrng.normal(
        0, 0.05, (60, 2))
    (rv, rr), (tv, tr) = (AF.build_triangles(x) for x in (stars_r, stars_t))
    sets = {"stars_60": (*AF._pad_tris(rv, rr)[::-1],
                         *AF._pad_tris(tv, tr)[::-1])}
    sets.update(vote_cases(vrng, AF.TRI_CAP))
    sets = {tag: [torch.from_numpy(a).to(dev) for a in arrs]
            for tag, arrs in sets.items()}
    for tag, vargs in sets.items():
        got = VK.vote(*vargs)
        ref = VK.vote_plain(*vargs)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K12 votes differ from the plain version "
                                 f"on {tag}")
        log(f"[K12] vote {tag}, {vargs[0].shape[0]} x {vargs[2].shape[0]} "
            f"rows: equal, {int(got.sum())} votes, diagonal "
            f"{int(got.diagonal().sum())}")
    vargs = sets["stars_60"]
    t_ref, t_tgt = vargs[0].shape[0], vargs[2].shape[0]
    votes = torch.empty((64, 64), dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * (t_ref + t_tgt) + 2 * (VK._BUCKETS + 2),
                          dtype=torch.int32, device=dev)

    def launch_alone():   # the counting sort and the vote, no allocation
        K.launch("abt_triangle_vote", vargs[0].data_ptr(),
                 vargs[1].data_ptr(), t_ref, vargs[2].data_ptr(),
                 vargs[3].data_ptr(), t_tgt, VK.TRIANGLE_TOLERANCE,
                 VK._GRID, scratch.data_ptr(), votes.data_ptr(),
                 K.stream_handle(votes))

    # the pairs the plan's windows hold (its plain form, on the host)
    rrows, rst = VK._bucket_rows(vargs[0].cpu(), vargs[1].cpu())
    _, tst = VK._bucket_rows(vargs[2].cpu(), vargs[3].cpu())
    lo, hi = VK._vote_plan(rrows, rst, tst)
    refs = torch.clamp(int(rst[VK._BUCKETS]) - torch.arange(lo.shape[0])
                       * VK._BLOCK, 0, VK._BLOCK)
    planned = int(((hi - lo).clamp(min=0) * refs).sum())
    flat = sets["all_equal_r0"]
    entry = {"max_abs_err": 0.0, "triangles": [len(rr), len(tr)],
             "cases": list(sets), "planned_pairs": planned,
             "ms": cuda_ms(lambda: VK.vote(*vargs), 20),
             "ms_launch_alone": cuda_ms(launch_alone, 20),
             "plain_ms": cuda_ms(lambda: VK.vote_plain(*vargs), 3),
             "ms_all_equal_r0": cuda_ms(lambda: VK.vote(*flat), 10),
             "plain_ms_all_equal_r0": cuda_ms(lambda: VK.vote_plain(*flat),
                                              3),
             "library_ms": None}
    (entry["bound_ms"], entry["bound_by"], entry["window_pairs"],
     entry["bound_all_pairs_ms"]) = vote_bound(vargs)
    (entry["bound_ms_all_equal_r0"], _, entry["window_pairs_all_equal_r0"],
     _) = vote_bound(flat)
    log(f"[K12] {entry['window_pairs']} pairs in the exact r0 window of "
        f"{len(rr) * len(tr)}; the plan's windows hold {planned}")
    return entry


def parity_args(stack, d_ys, d_xs, pixfrac: float, iterations: int = 5):
    """K9's arguments for the exact square drizzle of ``stack`` at scale
    2: the plan's shifts and weights (stacking/drizzle.py:_plan_parity)
    on the stack's device, taps, cap = 2n, sigma 3/3."""
    from astroburst_tpu_torch.dtypes import DrizzleKernel
    from astroburst_tpu_torch.stacking.drizzle import _plan_parity
    n, h, w = stack.shape
    plan = _plan_parity(h, w, d_ys, d_xs, 2.0, pixfrac, DrizzleKernel.SQUARE,
                        2 * h, 2 * w)
    if plan is None:
        raise AssertionError("the parity plan refused the drizzle bench")
    return (stack, *(plan[k].to(stack.device) for k in (
        "s_row", "s_col", "wys_t", "wxs")), plan["taps"], max(2 * n, 4),
        3.0, 3.0, iterations)


# (frames, instance) of the finalize kernels K7/K8 and K9 at depth 2n (2 x 2
# taps, cap 2n): registers at CAP 4 to 32, shared memory, global scratch
FINALIZE_INSTANCES = tuple((n, f"registers, CAP {2 * n}")
                           for n in range(2, 17, 2)) \
    + ((20, "shared memory, 32 x 8"), (100, "shared memory, 32 x 2"),
       (150, "global scratch"))


def tie_stack(n: int, rng, h: int = 40, w: int = 72) -> np.ndarray:
    """[n, h, w] values quantised to 4 (ties in every window), with
    +-0.0, NaN, +inf in half the frames of one pixel, -inf and a
    5000 outlier."""
    e = np.round(rng.normal(100, 8, (n, h, w)) / 4.0).astype(np.float32) * 4
    e[rng.random(e.shape) < 0.03] = 0.0
    e[rng.random(e.shape) < 0.03] = -0.0
    e[rng.random(e.shape) < 0.02] = np.nan
    e[: n // 2, 5, 9] = np.inf
    e[1 % n, 20, 30] = -np.inf
    e[2 % n, 10, 10] = 5000.0
    return e


def check_shift_clip_instances(rng, dev) -> dict:
    """K3 in every instance of its plan against its plain version, under
    ``check_flips``: the register instances on ``tie_stack`` stacks of
    300 x 400 at 1 to 32 frames (every CAP), with integer, quarter-pixel
    and zero offsets up to +-30; the scratch instance (past 128 frames,
    over bands of rows) at 150 and 300 frames of 1024^2 with NaN/inf
    pixels, timed. Returns the scratch instance's report entries."""
    import torch
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        _clip_plan, shift_clip_onepass, shift_clip_onepass_plain)
    caps = set()
    for n in range(1, 33):
        e = torch.as_tensor(tie_stack(n, rng, 300, 400), device=dev)
        eo = np.round(rng.uniform(-30, 30, (2, n)) * 4) / 4
        eo[:, 0] = 0.0
        eo[:, n // 3] = 0.0
        eo[:, n // 2] = np.round(eo[:, n // 2])
        edys, edxs = (torch.as_tensor(o, dtype=torch.float32, device=dev)
                      for o in eo)
        got = shift_clip_onepass(e, edys, edxs, 2.5, 3.0, 5)
        ref = shift_clip_onepass_plain(e, edys, edxs, 2.5, 3.0, 5)
        torch.cuda.synchronize()
        plan = _clip_plan(n, 300, 400)
        caps.add(plan.cap)
        check_flips(f"[K3] shift_clip {n}x300x400 ties, +-0, NaN/inf, "
                    f"{plan.instance} CAP {plan.cap}", n, got[0], ref[0],
                    got[1], ref[1])
    if sorted(caps) != list(range(4, 33, 4)):
        raise AssertionError(f"register instances not all reached: {caps}")
    entry = {}
    gen = torch.Generator(device=dev).manual_seed(32)
    hw = SCRATCH_HW
    for n in SCRATCH_FRAMES:
        e = torch.randn((n, hw, hw), generator=gen, device=dev) * 5.0 + 100.0
        e[torch.rand(e.shape, generator=gen, device=dev) < 0.01] = \
            float("nan")
        e[: n // 2, 11, 13] = float("inf")
        e[:, 7, 9] = float("nan")
        eo = rng.uniform(-30, 30, (2, n)).astype(np.float32)
        eo[:, 0] = 0.0
        edys, edxs = (torch.as_tensor(o, device=dev) for o in eo)
        plan = _clip_plan(n, hw, hw)
        if plan.instance != "scratch":
            raise AssertionError(f"{n} frames: {plan}")
        before = shift_clip_onepass.launches
        got = shift_clip_onepass(e, edys, edxs, 2.5, 3.0, 5)
        bands = shift_clip_onepass.launches - before
        ref = shift_clip_onepass_plain(e, edys, edxs, 2.5, 3.0, 5)
        torch.cuda.synchronize()
        err, flips = check_flips(
            f"[K3] shift_clip {n}x{hw}x{hw} +-30, NaN/inf, scratch "
            f"instance in {bands} bands of {plan.band_rows} rows", n,
            got[0], ref[0], got[1], ref[1])
        del got, ref
        npx = hw * hw
        entry.update({
            f"max_abs_err_{n}_frames": err, f"flips_{n}_frames": flips,
            f"ms_{n}_frames": cuda_ms(lambda: shift_clip_onepass(
                e, edys, edxs, 2.5, 3.0, 5), 3),
            f"plain_ms_{n}_frames": cuda_ms(lambda: shift_clip_onepass_plain(
                e, edys, edxs, 2.5, 3.0, 5), 1),
            f"bound_ms_{n}_frames": bound(4 * n * npx + 8 * npx,
                                          88 * n * npx)[0]})
        del e
    return entry


def finalize_work(cand, wys, wxs, n: int, taps: int, cap: int):
    """(bytes, f32 operations) that K7 needs on these candidates: each
    pixel walks its pushes in order until its cap-th present one (weight
    > 1e-12 and a finite value), forming w = wy·wx and adding it to the
    weight map for each push walked, and reading the value of each
    walked push whose weight passed; plus both weight tables and three
    output planes."""
    import torch
    from astroburst_tpu_torch.stacking.drizzle import _outer
    m, h, w = cand.shape
    wt = _outer(wys.reshape(n, taps, h), wxs.reshape(n, taps, w))
    passed = wt > 1e-12
    del wt
    present = (passed & torch.isfinite(cand)).to(torch.int32)
    before = torch.cumsum(present, 0, dtype=torch.int32) - present
    walked = before < cap
    del present, before
    values = int((walked & passed).sum())
    pushes = int(walked.sum())
    return (4 * (values + wys.numel() + wxs.numel()) + 12 * h * w,
            2 * pushes)


def check_drizzle_gather(dstack, dd_ys, dd_xs, rng) -> dict:
    """K9 against its plain version: at the drizzle bench (the full
    output of 10 x 4096^2 → 8192^2, pixfrac 0.7: depth 20, the register
    instance of CAP 20) and, on ``tie_stack`` stacks of 40 x 72 → 80 x
    144, in every instance (FINALIZE_INSTANCES: depth 2n at 2 x 2 taps, cap
    2n: registers at CAP 4 to 32, shared memory, the global scratch);
    image and rejected map bit-equal, weights within rtol 1e-6.
    Timed at the bench, at 150 frames (scratch) and at 20 frames of
    1024^2 → 2048^2 (the shared instance). Returns the report entry."""
    import torch
    from astroburst_tpu_torch.stacking.drizzle_gather_kernel import (
        drizzle_gather_finalize, drizzle_gather_finalize_plain)
    args = parity_args(dstack, dd_ys, dd_xs, 0.7)
    got = drizzle_gather_finalize(*args)
    ref = drizzle_gather_finalize_plain(*args)
    torch.cuda.synchronize()
    n, h, w = dstack.shape
    entry = check_finalize(f"[K9] drizzle_gather_finalize {n}x{h}x{w} -> "
                           f"{tuple(got[0].shape)}", got, ref)
    out_px = got[0].numel()
    m = n * args[5] ** 2
    del got, ref
    entry.update({
        "ms": cuda_ms(lambda: drizzle_gather_finalize(*args), 5),
        "plain_ms": cuda_ms(lambda: drizzle_gather_finalize_plain(*args), 1),
        "library_ms": None, "shape": [n, h, w], "candidates": m})
    # bytes: the stack, the shifts and weight tables, three output
    # planes; operations: w = wy·wx per candidate and the weight sum
    entry.update(zip(("bound_ms", "bound_by"), bound(
        4 * (dstack.numel() + args[3].numel() + args[4].numel()
             + 2 * args[1].numel()) + 12 * out_px, 2 * m * out_px)))
    for n, inst in FINALIZE_INSTANCES:
        es = torch.as_tensor(tie_stack(n, rng), device=dstack.device)
        ed = rng.uniform(-2, 2, (2, n)).astype(np.float32)
        args = parity_args(es, ed[0], ed[1], 1.0)[:-3] + (2.5, 3.0, 5)
        check_finalize(f"[K9] {n}x40x72 -> (80, 144), depth {2 * n}, "
                       f"{inst}; ties, +-0, NaN/inf",
                       drizzle_gather_finalize(*args),
                       drizzle_gather_finalize_plain(*args))
    entry.update({
        "ms_150_frames": cuda_ms(lambda: drizzle_gather_finalize(*args), 10),
        "plain_ms_150_frames": cuda_ms(
            lambda: drizzle_gather_finalize_plain(*args), 3)})
    gen = torch.Generator(device=dstack.device).manual_seed(28)
    es = torch.randn((20, 1024, 1024), generator=gen,
                     device=dstack.device) * 8.0 + 100.0
    ed = rng.uniform(-2, 2, (2, 20)).astype(np.float32)
    args = parity_args(es, ed[0], ed[1], 0.7)
    got = drizzle_gather_finalize(*args)
    ref = drizzle_gather_finalize_plain(*args)
    torch.cuda.synchronize()
    check_finalize("[K9] 20x1024x1024 -> (2048, 2048), depth 40, shared "
                   "memory", got, ref)
    del got, ref
    entry["ms_shared_20x1024"] = cuda_ms(
        lambda: drizzle_gather_finalize(*args), 5)
    return entry


K10_STEPS = (16, 64, 90, 125, 128, 129, 200, 256)   # every radix plan
K10_CHUNKED_STEP = 363          # past 8 x 8192 keys: the chunked route


def k10_plane(step: int, rng) -> np.ndarray:
    """A [2·step, 3·step] plane of six tiles the star fields do not
    reach: gamma values with NaN, a +inf row and a -inf row; all equal;
    all invalid (NaN, 0, -inf, exactly 1e-7); a single valid value;
    +-inf rows between values at exactly 1e-7 and one ulp above; and
    values quantised to 8 (ties everywhere)."""
    x = rng.gamma(2.0, 50.0, (2 * step, 3 * step)).astype(np.float32)
    tiles = [x[r * step:(r + 1) * step, c * step:(c + 1) * step]
             for r in range(2) for c in range(3)]
    t = tiles[0]
    t[rng.random(t.shape) < 0.05] = np.nan
    t[0, :] = np.inf
    t[step // 2, :] = -np.inf
    tiles[1][:] = 123.25
    t = tiles[2]
    t[:] = np.nan
    t[::3, :] = 0.0
    t[1::3, ::2] = -np.inf
    t[2::3, ::5] = np.float32(1e-7)
    t = tiles[3]
    t[:] = np.nan
    t[step // 3, step // 2] = 7.0
    t = tiles[4]
    t[rng.random(t.shape) < 0.2] = np.float32(1e-7)
    t[rng.random(t.shape) < 0.1] = np.nextafter(np.float32(1e-7),
                                                np.float32(1))
    t[::7, :] = np.inf
    t[3::7, :] = -np.inf
    t = tiles[5]
    t[:] = np.round(t / 8.0) * 8.0
    return x


def check_tile_sort(field, field5, rng) -> tuple:
    """K10 against its plain version, sorted tiles and counts bit-equal:
    the radix route at every step of K10_STEPS on a ``k10_plane`` (every
    tile plan: 1 block of 256 or 512 threads, clusters of 2, 4 and 8)
    and on the main path's planes — the 4096^2 field (256 tiles of
    256^2), the 5655 x 2206 field padded to 5888 x 2304 (207 tiles) and
    1000^2 at step 125 — and the chunked route at step
    K10_CHUNKED_STEP. Returns the report entries of both routes."""
    import torch
    from astroburst_tpu_torch.analysis.tile_sort_kernel import (
        _tile_plan, sort_tiles, sort_tiles_chunked, sort_tiles_plain)
    from astroburst_tpu_torch.ops.masking import validity_mask
    dev = field.device

    def padded_of(plane, step):
        rows, cols = plane.shape
        ty, tx = -(-rows // step), -(-cols // step)
        return torch.nn.functional.pad(
            plane, (0, tx * step - cols, 0, ty * step - rows),
            value=float("nan")).contiguous()

    def masked_tiles(padded, step):
        ty, tx = padded.shape[0] // step, padded.shape[1] // step
        return torch.where(validity_mask(padded), padded, float(
            "inf")).reshape(ty, step, tx, step).permute(0, 2, 1, 3).reshape(
            ty * tx, step * step)

    def check(what, padded, step):
        got = sort_tiles(padded, step)
        ref = sort_tiles_plain(padded, step)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"K10 differs from the plain version: "
                                 f"{what}, step {step}")
        plan = _tile_plan(step * step)
        log(f"[K10] sort_tiles {what} step {step} "
            f"({padded.numel() // step ** 2} tiles, "
            f"{'cluster x threads ' + str(plan) if plan else 'chunked'}): "
            f"bit-equal, {int(ref[1].sum())} valid of {padded.numel()}")

    for step in K10_STEPS + (K10_CHUNKED_STEP,):
        check("adversarial tiles", torch.as_tensor(k10_plane(step, rng),
                                                   device=dev), step)
    cases = {"4096x4096_step256": (padded_of(field, 256), 256),
             "5888x2304_step256": (padded_of(field5, 256), 256),
             "1000x1000_step125": (padded_of(field[:1000, :1000], 125), 125)}
    for tag, (padded, step) in cases.items():
        check(tag, padded, step)
    entry = {"max_abs_err": 0.0, "library": "torch.sort over the masked "
             "tiles", "steps_checked": list(K10_STEPS)}
    for i, (tag, (padded, step)) in enumerate(cases.items()):
        masked = masked_tiles(padded, step)
        times = {"ms": cuda_ms(lambda: sort_tiles(padded, step), 20),
                 "library_ms": cuda_ms(lambda: torch.sort(masked, dim=1), 20),
                 "plain_ms": cuda_ms(lambda: sort_tiles_plain(padded, step),
                                     5)}
        # bytes: the plane once, the sorted tiles and the counts once
        times["bound_ms"], times["bound_by"] = bound(
            4 * 2 * padded.numel() + 4 * padded.numel() // step ** 2, 0)
        if i == 0:
            entry.update(times, shape=list(padded.shape), step=step)
        else:
            entry.update({f"{k}_{tag}": v for k, v in times.items()
                          if k != "bound_by"})
        del masked
    step = K10_CHUNKED_STEP
    padded = torch.as_tensor(k10_plane(step, rng), device=dev)
    masked = masked_tiles(padded, step)
    chunked = {"max_abs_err": 0.0, "shape": list(padded.shape), "step": step,
               "ms": cuda_ms(lambda: sort_tiles(padded, step), 10),
               "plain_ms": cuda_ms(lambda: sort_tiles_plain(padded, step), 5),
               "library_ms": cuda_ms(lambda: torch.sort(masked, dim=1), 10),
               "library": "torch.sort over the masked tiles",
               "on_main_path": False}
    chunked.update(zip(("bound_ms", "bound_by"), bound(
        4 * 2 * padded.numel() + 4 * 6, 0)))
    if sort_tiles_chunked.launches < 1:
        raise AssertionError("the chunked route never ran")
    return entry, chunked


def masked_stretch_path(field, counters):
    """Path (d): ``masked_stretch`` on ``field`` fixed x10
    (convergence_threshold 0, the JAX bench's configuration) and at the
    default threshold, and ``masked_stretch_rgb_shared`` on three
    channels made from it; kernel launches counted over exactly these
    calls. ``field`` is the star field scaled into [0, 1): the reference
    stretches normalized data, and its luminance protection compares the
    image itself with the 0.85 ceiling, so raw counts (~100) would mark
    every pixel a star and leave no background to measure. Then the same calls through the plain versions: the same
    stars, iterations and convergence, coverage within 1e-5, images
    within 1e-3. The two paths' detections differ at f32 rounding (K11's
    sums in another order: centroids up to 2.4e-4 px apart at 4096^2),
    and the soft edges move with them, by up to ~1e-4 at softness 4; K13
    itself is bit-equal on the same records (phase 3). Returns
    (launches, times, max image difference, max coverage
    difference)."""
    import torch
    from astroburst_tpu_torch.imaging.masked_stretch import (
        MaskedStretchConfig, masked_stretch, masked_stretch_rgb_shared)
    fixed = MaskedStretchConfig(convergence_threshold=0.0)
    conv = MaskedStretchConfig()
    g = torch.Generator(device=field.device).manual_seed(27)
    rgb = (field, 0.8 * field + 5e-4 * torch.randn(
        field.shape, generator=g, device=field.device), 1.2 * field - 4e-3)

    def run(plain=False):
        out = {"x10": masked_stretch(field, fixed, plain=plain),
               "converged": masked_stretch(field, conv, plain=plain)}
        rgb_res = masked_stretch_rgb_shared(*rgb, conv, plain=plain)
        for c in "rgb":
            out[f"rgb_{c}"] = rgb_res[c]
        return out

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    res = run()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in masked_stretch (x10, converged) + "
        f"masked_stretch_rgb_shared: {launches}")
    for name in ("paint_mask", "sort_tiles", "window_stats"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never ran: {launches}")
    for tag, r in res.items():
        lo, hi = float(r.image.min()), float(r.image.max())
        log(f"[path] masked_stretch {tag}: {r.stars_masked} stars, "
            f"coverage {r.mask_coverage:.4f}, {r.iterations_run} "
            f"iterations, converged {r.converged}, background "
            f"{r.final_background:.6f}, image in [{lo:.3g}, {hi:.3g}]")
        if r.stars_masked < 1 or lo < 0.0 or hi > 1.0 or \
                abs(r.final_background - 0.25) > 0.02 or \
                r.image.shape != field.shape:
            raise AssertionError(f"masked_stretch {tag}: {r}")
    if res["x10"].iterations_run != 10 or res["x10"].converged:
        raise AssertionError("the fixed x10 run stopped early")
    ref = run(plain=True)
    torch.cuda.synchronize()
    d_img = d_cov = 0.0
    for tag, r in res.items():
        p = ref[tag]
        d = float((r.image - p.image).abs().max())
        d_img = max(d_img, d)
        d_cov = max(d_cov, abs(r.mask_coverage - p.mask_coverage))
        if (r.stars_masked, r.iterations_run, r.converged) != \
                (p.stars_masked, p.iterations_run, p.converged) or \
                d_cov > 1e-5 or d > 1e-3:
            raise AssertionError(f"masked_stretch {tag}: kernel {r} vs "
                                 f"plain {p}")
    log(f"[path] masked_stretch kernel vs plain: same stars, iterations "
        f"and convergence; image max|d| {d_img:.3e}, coverage max|d| "
        f"{d_cov:.3e}")
    times = {}
    for name, fn, reps in (
            ("masked_stretch_x10", lambda p: masked_stretch(
                field, fixed, plain=p), 5),
            ("masked_stretch_converged", lambda p: masked_stretch(
                field, conv, plain=p), 5),
            ("masked_stretch_rgb_shared", lambda p: masked_stretch_rgb_shared(
                *rgb, conv, plain=p), 3)):
        times[name] = (cuda_ms(lambda: fn(False), reps),
                       cuda_ms(lambda: fn(True), max(1, reps - 2)))
    return launches, times, d_img, d_cov


def check_parity_drizzle(what, got, want) -> dict:
    """``drizzle_exact_parity`` against ``_drizzle_kernel_exact`` at one
    band: image atol 2e-4 / rtol 1e-6, weights atol 1e-5, rejected count
    equal (tests/test_reference_impl.py:295-299)."""
    import torch
    if got is None:
        raise AssertionError(f"{what}: the parity plan refused")
    d_img = float((got[0] - want[0]).abs().max())
    d_wgt = float((got[1] - want[1]).abs().max())
    bit = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  {what}: image max|d|={d_img:.3e}, weights max|d|={d_wgt:.3e}, "
        f"rejected {int(got[2])} vs {int(want[2])}; bit-equal {bit}")
    if not (torch.allclose(got[0], want[0], rtol=1e-6, atol=2e-4)
            and torch.allclose(got[1], want[1], rtol=0.0, atol=1e-5)
            and int(got[2]) == int(want[2])):
        raise AssertionError(f"{what}: beyond the JAX test's tolerances")
    if not bit:
        raise AssertionError(f"{what}: not bit-equal to the one-band route")
    return {"max_abs_err": d_img, "weights_max_abs_err": d_wgt,
            "bit_equal": bit}


STACK_CMD_KEYS = {"fits_path", "png_path", "dimensions", "frame_count",
                  "rejected_pixels", "offsets", "stats", "elapsed_ms"}


def decode_png(path_or_bytes) -> np.ndarray:
    """The pixels ([H, W] gray or [H, W, 3] RGB; u8, or u16 at bit depth
    16) of a PNG file or of its bytes, whose scanlines all use filter 0
    (the port's writer), decoded with zlib alone."""
    import struct
    import zlib
    blob = path_or_bytes
    if not isinstance(blob, bytes):
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(blob):
        n, = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b"") + blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if depth not in (8, 16) or colour not in (0, 2):
        raise AssertionError(f"PNG bit depth {depth}, colour {colour}")
    chans = 3 if colour == 2 else 1
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                         np.uint8).reshape(h, w * chans * depth // 8 + 1)
    if rows[:, 0].any():
        raise AssertionError("a PNG scanline filter other than 0")
    px = rows[:, 1:].copy().view(">u2" if depth == 16 else np.uint8)
    return px.reshape((h, w) if chans == 1 else (h, w, 3))


def write_fits_frames(directory, frames) -> list:
    """Each [H, W] tensor of ``frames`` as frame_###.fits (BITPIX -32,
    through the port's writer); the paths as resolve_inputs lists them."""
    import os
    from astroburst_tpu_torch.io import write_fits_mono
    from astroburst_tpu_torch.io.header import HduHeader
    os.makedirs(directory)
    paths = []
    for k, f in enumerate(frames):
        paths.append(os.path.join(directory, f"frame_{k:03d}.fits"))
        write_fits_mono(paths[-1], f.cpu().numpy(), HduHeader(
            [("OBJECT", "'chip_smoke'"), ("FRAME", str(k))]))
    return paths


def check_stack_command(what, res, want_shape, want_offsets, ref, dev):
    """One response of ``api.stack`` against the generator's shifts and
    ``stack_images`` on the in-memory frames (``ref``): RES_* keys,
    offsets equal, ``stacked.fits`` read back bit-equal, the rejected
    count equal, the PNG equal to the STF'd downsample with the
    command's own stats (from the cache entry it left). Returns the
    image on the card."""
    import torch
    from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
    from astroburst_tpu_torch.io import extract_image
    from astroburst_tpu_torch.ops.ipc import nearest_downsample
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    if set(res) != STACK_CMD_KEYS:
        raise AssertionError(f"{what}: keys {sorted(res)}")
    h, w = want_shape
    if res["dimensions"] != [w, h] or res["frame_count"] != len(
            want_offsets):
        raise AssertionError(f"{what}: dimensions {res['dimensions']}, "
                             f"{res['frame_count']} frames")
    if res["offsets"] != [list(map(int, o)) for o in want_offsets]:
        raise AssertionError(f"{what}: offsets {res['offsets']} != "
                             f"{want_offsets.tolist()}")
    img = extract_image(res["fits_path"]).image
    if not np.array_equal(img, ref.image.cpu().numpy(), equal_nan=True):
        raise AssertionError(f"{what}: stacked.fits differs from "
                             f"stack_images on the in-memory frames")
    if res["rejected_pixels"] != ref.rejected_pixels:
        raise AssertionError(f"{what}: rejected {res['rejected_pixels']} "
                             f"!= {ref.rejected_pixels}")
    entry = GLOBAL_IMAGE_CACHE.get(res["fits_path"], dev)
    if entry is None or entry.stats is None:
        raise AssertionError(f"{what}: the result is not cached")
    stats = entry.stats
    if any(res["stats"][k] != getattr(stats, k) for k in res["stats"]):
        raise AssertionError(f"{what}: RES_STATS {res['stats']} != {stats}")
    img_dev = torch.from_numpy(img).to(dev)
    want_png = apply_stf_u8(nearest_downsample(img_dev, 4096),
                            auto_stf(stats), stats).cpu().numpy()
    png = decode_png(res["png_path"])
    if png.shape != want_png.shape or not np.array_equal(png, want_png):
        raise AssertionError(f"{what}: stacked.png {png.shape} differs "
                             f"from the STF'd downsample {want_png.shape}")
    log(f"[path] {what}: {res['frame_count']} frames, offsets equal the "
        f"generator's, stacked.fits bit-equal to stack_images, rejected "
        f"{res['rejected_pixels']}, stacked.png {png.shape[0]}x"
        f"{png.shape[1]} equal to the STF'd downsample; "
        f"{res['elapsed_ms']} ms")
    return img_dev


def stack_command_path(stack, shifts, many_list, many_shifts, counters,
                       smi):
    """Phase 4f: the ``stack`` command end to end. The bench frames and
    the 150 frames of 1024^2 go to FITS files (port's writer, BITPIX
    -32) under build/; ``api.stack`` runs cold (empty image cache),
    warm (every frame cached), on the directory path, and on the 150
    files (past 128 frames and the cache's 32 entries), each checked by
    ``check_stack_command``. The kernel counters are reset just before
    the first call and read just after the last; the references and
    the stage times come after. Returns (launches, stage times in ms)."""
    import os
    import shutil
    import tempfile
    import torch
    from astroburst_tpu_torch import api
    from astroburst_tpu_torch.api.common import load_cached_many
    from astroburst_tpu_torch.api.stacking import _save_preview
    from astroburst_tpu_torch.io import extract_image, write_fits_mono
    from astroburst_tpu_torch.io.prefetch import DeviceLoader
    from astroburst_tpu_torch.ops.stats import compute_image_stats
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    from astroburst_tpu_torch.stacking.combine import stack_images
    dev = stack.device
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="stack_command_", dir=build)
    try:
        t0 = time.perf_counter()
        bench_dir = os.path.join(root, "bench")
        bench_paths = write_fits_frames(bench_dir, stack)
        many_paths = write_fits_frames(os.path.join(root, "many"),
                                       many_list)
        nbytes = sum(os.path.getsize(p) for p in bench_paths + many_paths)
        log(f"[data] {len(bench_paths)} + {len(many_paths)} FITS files, "
            f"{nbytes / 1e6:.1f} MB (written in "
            f"{time.perf_counter() - t0:.1f} s)")
        ref = stack_images(list(stack))
        ref_many = stack_images(many_list)

        GLOBAL_IMAGE_CACHE.clear()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        cold = api.stack(bench_paths, os.path.join(root, "out_cold"))
        cold_ms = (time.perf_counter() - t0) * 1e3
        nb = len(bench_paths)
        check_stack_command(f"stack({nb} files) cold", cold, stack.shape[1:],
                            shifts, ref, dev)
        t0 = time.perf_counter()
        warm = api.stack(bench_paths, os.path.join(root, "out_warm"))
        warm_ms = (time.perf_counter() - t0) * 1e3
        img = check_stack_command(f"stack({nb} files) warm", warm,
                                  stack.shape[1:], shifts, ref, dev)
        by_dir = api.stack([bench_dir], os.path.join(root, "out_dir"))
        check_stack_command("stack(directory)", by_dir, stack.shape[1:],
                            shifts, ref, dev)
        many = api.stack(many_paths, os.path.join(root, "out_many"))
        check_stack_command(f"stack({len(many_paths)} files)", many,
                            many_list[0].shape, many_shifts, ref_many, dev)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        log(f"[path] kernel launches in the stack command (cold, warm, "
            f"directory, {len(many_paths)} files): {launches}")
        for name in ("shift_clip", "coarse_box", "gather_crops"):
            if launches[name] < 1:
                raise AssertionError(f"{name} never ran: {launches}")
        if len(GLOBAL_IMAGE_CACHE.keys()) != 32:
            raise AssertionError("the image cache does not hold 32 entries")

        # stage times (host clocks around work that ends in a
        # synchronize; device stages also with CUDA events)
        times = {"command_cold_ms": cold_ms, "command_warm_ms": warm_ms}
        t0 = time.perf_counter()
        extract_image(bench_paths[0])
        times["decode_one_frame_ms"] = (time.perf_counter() - t0) * 1e3
        load = DeviceLoader(dev)
        load(bench_paths[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load(bench_paths[0])
        torch.cuda.synchronize()
        times["decode_pinned_h2d_one_frame_ms"] = \
            (time.perf_counter() - t0) * 1e3
        loads = []
        for _ in range(2):
            GLOBAL_IMAGE_CACHE.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entries = load_cached_many(bench_paths, device=dev)
            torch.cuda.synchronize()
            loads.append((time.perf_counter() - t0) * 1e3)
        times[f"load_cached_many_{nb}_ms"] = loads
        frames = [e.image for e in entries]
        times["stack_images_ms"] = cuda_ms(lambda: stack_images(frames), 3)
        times["compute_image_stats_ms"] = cuda_ms(
            lambda: compute_image_stats(img), 5)
        stats = compute_image_stats(img)
        out = os.path.join(root, "stage.fits")
        t0 = time.perf_counter()
        host = img.cpu().numpy()
        times["fetch_image_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        write_fits_mono(out, host, entries[0].header)
        times["write_fits_mono_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _save_preview(img, os.path.join(root, "stage.png"), stats)
        times["preview_png_ms"] = (time.perf_counter() - t0) * 1e3
        warm_more = []
        for k in range(2):
            t0 = time.perf_counter()
            api.stack(bench_paths, os.path.join(root, f"out_w{k}"))
            warm_more.append((time.perf_counter() - t0) * 1e3)
        times["command_warm_again_ms"] = warm_more
        mpx = stack.numel() / 1e6
        times["command_warm_mpx_per_s"] = mpx / warm_ms * 1e3
        log(f"[time] {smi}: stack command {tuple(stack.shape)} from FITS: "
            f"cold {cold_ms:.3f} ms, warm {warm_ms:.3f} ms "
            f"({mpx / warm_ms * 1e3:.1f} Mpx/s), warm again "
            f"{', '.join(f'{t:.3f}' for t in warm_more)} ms")
        log(f"[time] {smi}: stack command stages: " + json.dumps(times))
        GLOBAL_IMAGE_CACHE.clear()
        return launches, times
    finally:
        shutil.rmtree(root)


# --- phase 4g: open and inspect -------------------------------------------

# the reference's own figures on its own hardware (BASELINE.md)
REF_PROCESS_FITS_MS = 120.0   # single FITS processing 4096^2, Ryzen 9 7950X
REF_HIST_STF_MS = 35.0        # histogram + auto-STF 4096^2, Ryzen 9 7950X
REF_STF_RENDER_MS = 8.0       # WebGPU STF render 4096^2, a consumer GPU
STF_SLIDER_CALLS = 60


def fits_hdu(plane, cards=(), primary=True, bitpix=-32, bscale=1.0,
             bzero=0.0) -> bytes:
    """One HDU's bytes, written here and not by the port's writer: a
    primary (SIMPLE) or IMAGE-extension header with ``cards``, then
    ``plane`` as big-endian f32, or (BITPIX 16) as the i16 values it
    holds under BSCALE/BZERO; ``plane`` None writes NAXIS 0."""
    def card(key, value):
        return f"{key:<8}= {value:>20}".ljust(80).encode()
    head = [card("SIMPLE", "T") if primary else card("XTENSION",
                                                     "'IMAGE   '"),
            card("BITPIX", str(bitpix))]
    if plane is None:
        head.append(card("NAXIS", "0"))
    else:
        h, w = plane.shape
        head += [card("NAXIS", "2"), card("NAXIS1", str(w)),
                 card("NAXIS2", str(h))]
        if bitpix == 16:
            head += [card("BSCALE", repr(bscale)), card("BZERO", repr(bzero))]
    head += [card(k, v) for k, v in cards]
    blob = b"".join(head) + b"END".ljust(80)
    blob += b" " * (-len(blob) % 2880)
    if plane is None:
        return blob
    payload = np.ascontiguousarray(
        plane, ">i2" if bitpix == 16 else ">f4").tobytes()
    return blob + payload + b"\0" * (-len(payload) % 2880)


def asdf_bytes(plane) -> bytes:
    """An ASDF file of one big-endian f32 plane in one uncompressed block
    (the layout astroburst_tpu_torch/io/asdf.py reads)."""
    import struct
    h, w = plane.shape
    data = np.ascontiguousarray(plane, ">f4").tobytes()
    tree = ("#ASDF 1.0.0\n#ASDF_STANDARD 1.5.0\n%YAML 1.1\n"
            "--- !core/asdf-1.1.0\n"
            "data: !core/ndarray-1.0.0\n  source: 0\n  datatype: float32\n"
            f"  byteorder: big\n  shape: [{h}, {w}]\n"
            "meta:\n  instrument: {name: NIRCAM}\n...\n").encode()
    header = (struct.pack(">I", 0) + b"\0" * 4 + struct.pack(">Q", len(data))
              + struct.pack(">Q", len(data)) + struct.pack(">Q", len(data))
              + b"\0" * 16)
    return tree + b"\xd3BLK" + struct.pack(">H", len(header)) + header + data


def histogram_oracle(sorted_valid: np.ndarray, dmin: float, dmax: float,
                     bins: int) -> np.ndarray:
    """int64 counts of e_j <= v < e_{j+1} over the f32 edges dmin +
    step·j, each operation rounded (astroburst_tpu/ops/stats.py:88-101),
    from the count below each edge of the sorted valid values."""
    lo = np.float32(dmin)
    step = (np.float32(dmax) - lo) / np.float32(bins)
    edges = lo + step * np.arange(1, bins, dtype=np.float32)
    below = np.searchsorted(sorted_valid, edges, side="left")
    return np.diff(np.concatenate([[0], below, [sorted_valid.size]]))


def host_ms(fn):
    """(result, ms) of one call on the host clock, ending in a
    synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stf_slider_ms(plane, stats, n: int) -> list:
    """The STF slider path (bench.py:15-20, :311-332): a 2048^2 nearest
    downsample of the 4096^2 f32 plane, then the u8 STF with tensor
    parameters, a new shadow each call; each of ``n`` calls timed by
    its own pair of CUDA events, after 5 warm-up calls."""
    import torch
    from astroburst_tpu_torch.imaging.stf import apply_stf_traced
    from astroburst_tpu_torch.ops.ipc import nearest_downsample
    dev = plane.device
    dmin, dmax = torch.tensor([stats.min, stats.max], dtype=torch.float32,
                              device=dev).unbind()
    params = torch.stack([torch.linspace(0.0, 0.02, n + 5, device=dev),
                          torch.full((n + 5,), 0.3, device=dev)], 1)

    def render(i):
        small = nearest_downsample(plane, 2048)
        return apply_stf_traced(small, dmin, dmax, params[i, 0],
                                params[i, 1], as_u8=True)

    for i in range(5):
        render(i)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    for i, (e0, e1) in enumerate(events):
        e0.record()
        out = render(5 + i)
        e1.record()
    torch.cuda.synchronize()
    if out.shape != nearest_downsample(plane, 2048).shape or \
            out.dtype != torch.uint8:
        raise AssertionError(f"STF slider output {tuple(out.shape)} "
                             f"{out.dtype}")
    return sorted(e0.elapsed_time(e1) for e0, e1 in events)


def open_inspect_path(field, bench_frame, counters, smi):
    """Phase 4g: the open-and-inspect commands on files written under
    build/: the 4096^2 detection field (~3000 stars, NaN patches, +-inf),
    one bench frame (5655 x 2206), an RGB FITS of 3 x 4096^2, a BITPIX 16
    file with BSCALE/BZERO, a two-HDU MEF whose SCI extension holds the
    image, and an ASDF file. Each command runs cold (empty image cache)
    and warm and is checked against what the card computes from the
    in-memory tensors; the kernel counters are reset just before the
    commands and read just after (this slice reaches no kernel: every
    count must stay 0). Then the stages, the commands cold and warm and
    the STF slider path are timed. Returns (launches, times in ms)."""
    import importlib.util
    import os
    import shutil
    import tempfile
    import torch
    from astroburst_tpu_torch import api
    from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
    from astroburst_tpu_torch.io import (extract_image, save_gray_png,
                                         save_rgb_png, try_extract_rgb,
                                         write_fits_mono, write_fits_rgb)
    from astroburst_tpu_torch.io.header import HduHeader
    from astroburst_tpu_torch.io.prefetch import DeviceLoader
    from astroburst_tpu_torch.dtypes import StfParams
    from astroburst_tpu_torch.ops.ipc import (decode_binary_pixels,
                                              nearest_downsample)
    from astroburst_tpu_torch.ops.stats import (compute_histogram_with_stats,
                                                compute_image_stats)
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    dev = field.device
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="open_inspect_", dir=build)
    out = os.path.join(root, "out")
    try:
        t0 = time.perf_counter()
        cards = [("OBJECT", "'M 16'"), ("FILTER", "'Ha 656nm'"),
                 ("EXPTIME", "300.0"), ("TELESCOP", "'chip_smoke'")]
        p_field = os.path.join(root, "field_Ha.fits")
        write_fits_mono(p_field, field.cpu().numpy(), HduHeader(cards))
        p_bench = os.path.join(root, "bench.fits")
        write_fits_mono(p_bench, bench_frame.cpu().numpy(),
                        HduHeader([("OBJECT", "'bench'")]))
        rgb = [field, field * 0.5 + 10.0, field * 0.25 + 30.0]
        p_rgb = os.path.join(root, "rgb.fits")
        write_fits_rgb(p_rgb, *(c.cpu().numpy() for c in rgb),
                       HduHeader([("OBJECT", "'rgb'")]))
        hw = field.shape[0]
        raw16 = np.clip(np.nan_to_num(field.cpu().numpy(), nan=0.0,
                                      posinf=0.0, neginf=0.0) * 8.0 - 4000.0,
                        -32768, 32767).astype(np.int16)
        p_b16 = os.path.join(root, "field_OIII_b16.fits")
        with open(p_b16, "wb") as f:
            f.write(fits_hdu(raw16, [("FILTER", "'OIII'")], bitpix=16,
                             bscale=0.125, bzero=500.0))
        b16 = torch.from_numpy(
            (raw16.astype(np.float64) * 0.125 + 500.0).astype(np.float32)
        ).to(dev)
        sci = field[: hw // 4, : hw // 4].contiguous()
        p_mef = os.path.join(root, "mef_SII.fits")
        with open(p_mef, "wb") as f:
            f.write(fits_hdu(None, [("TELESCOP", "'JWST'"),
                                    ("FILTER", "'SII'")])
                    + fits_hdu(sci.cpu().numpy(), [("EXTNAME", "'SCI'"),
                                                   ("EXPTIME", "99.0")],
                               primary=False))
        p_asdf = os.path.join(root, "field.asdf")
        with open(p_asdf, "wb") as f:
            f.write(asdf_bytes(sci.cpu().numpy()))
        nbytes = sum(os.path.getsize(p) for p in (p_field, p_bench, p_rgb,
                                                  p_b16, p_mef, p_asdf))
        log(f"[data] open and inspect: 6 files, {nbytes / 1e6:.1f} MB "
            f"(written in {time.perf_counter() - t0:.1f} s)")

        def check_png(what, path, planes, stats, params):
            want = [apply_stf_u8(nearest_downsample(p, 4096), prm, st)
                    for p, st, prm in zip(planes, stats, params)]
            want = torch.stack(want, -1) if len(want) == 3 else want[0]
            png = decode_png(path)
            if not np.array_equal(png, want.cpu().numpy()):
                raise AssertionError(f"{what}: {os.path.basename(path)} "
                                     f"differs from the STF'd downsample")

        def check_stats(what, res_stats, st):
            for k, v in res_stats.items():
                if v != getattr(st, k):
                    raise AssertionError(f"{what}: stats[{k}] {v} != "
                                         f"{getattr(st, k)}")

        keys = {"process_fits": {"png_path", "dimensions", "elapsed_ms",
                                 "stats", "stf"}}
        keys["process_fits_full"] = keys["process_fits"] | {"header",
                                                            "histogram"}
        rgb_keys = keys["process_fits"] | {"is_rgb", "stf_r", "stf_g",
                                           "stf_b"}
        st_field = compute_image_stats(field)
        host_field = field.cpu().numpy()
        valid = host_field[np.isfinite(host_field) & (host_field > 1e-7)]
        sorted_valid = np.sort(valid)

        GLOBAL_IMAGE_CACHE.clear()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        cmd_ms = {}
        for temp in ("cold", "warm"):
            def run(name, fn):
                """fn() timed on the host clock; cold: the image cache
                emptied first. Warm calls find what the cold pass left."""
                if temp == "cold":
                    GLOBAL_IMAGE_CACHE.clear()
                res, ms = host_ms(fn)
                cmd_ms[f"{name}_{temp}"] = ms
                return res

            # the 4096^2 field: process_fits(_full), the raw preview,
            # apply_stf_render, the histogram
            for cmd in ("process_fits", "process_fits_full"):
                res = run(cmd, lambda: getattr(api, cmd)(p_field, out))
                what = f"{cmd}(4096^2) {temp}"
                if set(res) != keys[cmd]:
                    raise AssertionError(f"{what}: keys {sorted(res)}")
                check_stats(what, res["stats"], st_field)
                if res["stf"] != auto_stf(st_field).to_dict():
                    raise AssertionError(f"{what}: stf {res['stf']}")
                check_png(what, res["png_path"], [field], [st_field],
                          [auto_stf(st_field)])
                if cmd == "process_fits_full":
                    hist = res["histogram"]
                    want = histogram_oracle(sorted_valid, st_field.min,
                                            st_field.max, 512)
                    if hist["bins"] != want.tolist() or \
                            sum(hist["bins"]) != st_field.valid_count or \
                            hist["total_pixels"] != st_field.valid_count:
                        raise AssertionError(f"{what}: histogram counts")
                    if any(res["header"].get(k) != v.strip("'").strip()
                           for k, v in cards):
                        raise AssertionError(f"{what}: header "
                                             f"{res['header']}")
            raw = run("get_raw_pixels_preview",
                      lambda: api.get_raw_pixels_preview(p_field))
            arr, mn, mx = decode_binary_pixels(raw)
            small = nearest_downsample(field, 2048)
            fin = torch.isfinite(small)
            want = torch.where(fin, small, torch.zeros_like(small))
            if not np.array_equal(arr, want.cpu().numpy()) or \
                    (mn, mx) != (small[fin].min().item(),
                                 small[fin].max().item()):
                raise AssertionError(f"raw preview {temp}: pixels or "
                                     f"min/max ({mn}, {mx})")
            prm = StfParams(shadow=0.02, midtone=0.3, highlight=1.0)
            res = run("apply_stf_render", lambda: api.apply_stf_render(
                p_field, out, prm.shadow, prm.midtone, prm.highlight))
            check_png(f"apply_stf_render {temp}", res["png_path"], [field],
                      [st_field], [prm])
            for bins in (None, 100):
                res = run(f"compute_histogram_{bins or 512}",
                          lambda: api.compute_histogram(p_field, bins))
                want = histogram_oracle(sorted_valid, res["data_min"],
                                        res["data_max"], bins or 512)
                if res["bins"] != want.tolist() or \
                        sum(res["bins"]) != st_field.valid_count or \
                        (res["data_min"], res["data_max"]) != \
                        (st_field.min, st_field.max):
                    raise AssertionError(f"compute_histogram({bins}) "
                                         f"{temp}: counts or range")

            # the bench frame: a 4096 x 1598 preview
            res = run("process_fits_bench",
                      lambda: api.process_fits(p_bench, out))
            st = compute_image_stats(bench_frame)
            check_stats(f"process_fits(bench) {temp}", res["stats"], st)
            check_png(f"process_fits(bench) {temp}", res["png_path"],
                      [bench_frame], [st], [auto_stf(st)])

            # RGB: three planes decoded on every call, six composite keys
            sts = [compute_image_stats(c) for c in rgb]
            for cmd in ("process_fits", "process_fits_full"):
                res = run(f"{cmd}_rgb", lambda: getattr(api, cmd)(p_rgb,
                                                                  out))
                want_keys = rgb_keys | ({"header", "histogram"}
                                        if cmd == "process_fits_full"
                                        else set())
                if set(res) != want_keys or res["is_rgb"] is not True:
                    raise AssertionError(f"{cmd}(rgb): keys {sorted(res)}")
                check_stats(f"{cmd}(rgb)", res["stats"], sts[0])
                check_png(f"{cmd}(rgb)", res["png_path"], rgb, sts,
                          [auto_stf(s) for s in sts])
                for (o, k), plane in zip((("__composite_orig_r",
                                           "__composite_r"),
                                          ("__composite_orig_g",
                                           "__composite_g"),
                                          ("__composite_orig_b",
                                           "__composite_b")), rgb):
                    eo = GLOBAL_IMAGE_CACHE.get(o, dev)
                    ek = GLOBAL_IMAGE_CACHE.get(k, dev)
                    if eo is None or ek is None or eo.image is not ek.image \
                            or not torch.equal(eo.image.nan_to_num(),
                                               plane.nan_to_num()):
                        raise AssertionError(f"{cmd}(rgb): {o} / {k}")

            # BITPIX 16 with BSCALE/BZERO, and the MEF's SCI extension
            res = run("process_fits_full_b16",
                      lambda: api.process_fits_full(p_b16, out))
            st = compute_image_stats(b16)
            check_stats(f"process_fits_full(BITPIX 16) {temp}",
                        res["stats"], st)
            check_png(f"process_fits_full(BITPIX 16) {temp}",
                      res["png_path"], [b16], [st], [auto_stf(st)])
            res = run("process_fits_full_mef",
                      lambda: api.process_fits_full(p_mef, out))
            st = compute_image_stats(sci)
            check_stats(f"process_fits_full(MEF) {temp}", res["stats"], st)
            check_png(f"process_fits_full(MEF) {temp}", res["png_path"],
                      [sci], [st], [auto_stf(st)])
            if (res["header"].get("EXTNAME"), res["header"].get("TELESCOP"),
                    res["header"].get("EXPTIME")) != ("SCI", "JWST", "99.0"):
                raise AssertionError(f"MEF header {res['header']}")

        # header, extension, filter and output-dir commands
        hdr = api.get_header(p_field)
        if [(c["key"], c["value"]) for c in hdr["cards"]
                if c["key"] in dict(cards)] != \
                [(k, v.strip("'").strip()) for k, v in cards]:
            raise AssertionError(f"get_header cards {hdr['cards']}")
        full = api.get_full_header(p_field)
        det = full["filter_detection"]
        if det is None or det["filter"] != "Hα (656nm)" or \
                full["categories"]["observation"].get("OBJECT") != "M 16":
            raise AssertionError(f"get_full_header {det}")
        ext = api.get_fits_extensions(p_mef)
        if ext["extension_count"] != 2 or \
                ext["extensions"][1]["extname"] != "SCI":
            raise AssertionError(f"get_fits_extensions {ext}")
        by_hdu = api.get_header_by_hdu(p_mef, 1)
        if ("EXTNAME", "SCI") not in [(c["key"], c["value"])
                                      for c in by_hdu["cards"]]:
            raise AssertionError(f"get_header_by_hdu {by_hdu}")
        nb = api.detect_narrowband_filters([p_field, p_b16, p_mef])
        if not nb["palette"]["is_complete"] or [
                f["filter_detection"]["filter"] for f in nb["filters"]] != \
                ["Hα (656nm)", "[OIII] (502nm)", "[SII] (673nm)"]:
            raise AssertionError(f"detect_narrowband_filters {nb}")
        info = api.get_output_dir_info(out)
        n_png = len([n for n in os.listdir(out) if n.endswith(".png")])
        if info["file_count"] != n_png or n_png < 6:
            raise AssertionError(f"get_output_dir_info {info}")
        cleaned = api.cleanup_output_cmd(out)
        if cleaned["cleaned_files"] != n_png or os.listdir(out):
            raise AssertionError(f"cleanup_output_cmd {cleaned}")

        # ASDF: PyYAML parses the tree; the card's machine may not have it
        if importlib.util.find_spec("yaml") is None:
            try:
                api.process_fits(p_asdf, out)
            except ModuleNotFoundError as e:
                if e.name != "yaml" or "PyYAML" not in str(e):
                    raise
                log(f"[path] ASDF read not run on the card: PyYAML is not "
                    f"installed on this machine, and process_fits on an "
                    f"ASDF file raised, as it must: {e}")
            else:
                raise AssertionError("an ASDF read without PyYAML did not "
                                     "raise")
        else:
            res = api.process_fits_full(p_asdf, out)
            check_stats("process_fits_full(ASDF)", res["stats"],
                        compute_image_stats(sci))
            log("[path] ASDF read on the card: the image equals the plane "
                "written")
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        if any(launches.values()):
            raise AssertionError(f"open and inspect launched a kernel: "
                                 f"{launches}")
        log(f"[path] open and inspect: process_fits(_full) on the 4096^2 "
            f"field, the bench frame, RGB, BITPIX 16 and MEF files cold and "
            f"warm; every PNG equal to the STF'd downsample on the card, "
            f"stats equal to compute_image_stats, histograms equal to the "
            f"int64 numpy count, the raw preview equal to the scrubbed "
            f"downsample, six composite keys, header/extension/filter/"
            f"output-dir commands; kernel launches {launches}")

        # stage times: device stages by CUDA events, host stages by the
        # host clock ending in a synchronize
        times = {"commands_ms": cmd_ms}
        _, times["decode_field_ms"] = host_ms(lambda: extract_image(p_field))
        load = DeviceLoader(dev)
        load(p_bench)
        _, times["decode_pinned_h2d_field_ms"] = host_ms(
            lambda: load(p_field))
        times["stats_ms"] = cuda_ms(lambda: compute_image_stats(field), 5)
        times["histogram_512_ms"] = cuda_ms(
            lambda: compute_histogram_with_stats(field, st_field), 5)

        def histogram_auto_stf():
            st = compute_image_stats(field)
            auto_stf(st)
            return compute_histogram_with_stats(field, st)

        times["histogram_auto_stf_ms"] = cuda_ms(histogram_auto_stf, 5)
        stf = auto_stf(st_field)
        times["stf_u8_ms"] = cuda_ms(
            lambda: apply_stf_u8(nearest_downsample(field, 4096), stf,
                                 st_field), 10)
        u8 = apply_stf_u8(field, stf, st_field)
        host_u8, times["fetch_u8_ms"] = host_ms(lambda: u8.cpu().numpy())
        _, times["png_ms"] = host_ms(lambda: save_gray_png(
            host_u8, os.path.join(root, "stage.png")))
        rgb_host, times["rgb_decode_ms"] = host_ms(
            lambda: try_extract_rgb(p_rgb))
        sts = [compute_image_stats(c) for c in rgb]
        u8s, times["rgb_u8_fetch_ms"] = host_ms(lambda: torch.stack(
            [apply_stf_u8(c, auto_stf(st), st) for c, st in zip(rgb, sts)]
        ).cpu().numpy())
        _, times["rgb_png_ms"] = host_ms(lambda: save_rgb_png(
            *u8s, os.path.join(root, "stage_rgb.png")))
        del rgb_host, u8s
        slider = stf_slider_ms(field, st_field, STF_SLIDER_CALLS)
        times["stf_slider_ms"] = {"p50": slider[len(slider) // 2],
                                  "min": slider[0], "max": slider[-1],
                                  "calls": len(slider)}
        ref = "(reference: BASELINE.md, its own hardware)"
        log(f"[time] {smi}: process_fits 4096^2 cold "
            f"{cmd_ms['process_fits_cold']:.3f} ms, warm "
            f"{cmd_ms['process_fits_warm']:.3f} ms; beside 120 ms on a "
            f"Ryzen 9 7950X {ref}")
        log(f"[time] {smi}: histogram (512 bins) + auto-STF 4096^2 "
            f"{times['histogram_auto_stf_ms']:.3f} ms (stats "
            f"{times['stats_ms']:.3f}, histogram "
            f"{times['histogram_512_ms']:.3f}); beside 35 ms on a Ryzen 9 "
            f"7950X {ref}")
        log(f"[time] {smi}: STF slider (2048^2 downsample + u8 STF of a "
            f"4096^2 plane) p50 {times['stf_slider_ms']['p50']:.4f} ms over "
            f"{len(slider)} calls (min {slider[0]:.4f}, max "
            f"{slider[-1]:.4f}); beside 8 ms for the WebGPU STF render on "
            f"a consumer GPU {ref}")
        log(f"[time] {smi}: open and inspect stages: " + json.dumps(times))
        GLOBAL_IMAGE_CACHE.clear()
        return launches, times
    finally:
        shutil.rmtree(root)


# --- phase 4h: calibrate → pipeline / drizzle → export, from files -------

REF_DRIZZLE_MS = 4200.0   # drizzle 10 x 4096^2 → 8192^2, BASELINE.md
RGB_PNG_HW = 4096         # side of the planes of the RGB PNG exports
BENCH_RESAMPLE_WH = (3196, 8192)   # the bench frame resampled: 5655 x 2206
WCS_CARDS = [("OBJECT", "TEST"), ("FILTER", "Ha"),       # tests/
             ("CRPIX1", "48"), ("CRPIX2", "48"),         # test_api_surface
             ("CRVAL1", "150.0"), ("CRVAL2", "30.0"),    # .py:55-59
             ("CD1_1", "-0.0002"), ("CD1_2", "0"), ("CD2_1", "0"),
             ("CD2_2", "0.0002"), ("CTYPE1", "'RA---TAN'")]
CDELT_CARDS = [("OBJECT", "'bench'"), ("CRPIX1", "1103.0"),
               ("CRPIX2", "2827.5"), ("CDELT1", "-1.1E-5"),
               ("CDELT2", "1.1E-5")]


def catmull_rom_oracle(img: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """The Catmull-Rom resize (resample.rs:25-61) in numpy f32: per axis
    the source coordinate s = t·scale + (scale − 1)/2, taps floor(s) − 1
    .. + 2 clamped to the plane, weights in f64 rounded to f32, every
    product and sum rounded, rows first, then columns."""
    def axis(x, n_tgt, ax):
        n_src = x.shape[ax]
        scale = n_src / n_tgt
        s = np.arange(n_tgt) * scale + (scale - 1.0) * 0.5
        i0 = np.floor(s).astype(np.int64)
        out = None
        for j in range(4):
            a = np.abs(s - i0 - (j - 1))
            w = np.where(a <= 1.0, a * a * (1.5 * a - 2.5) + 1.0,
                         np.where(a <= 2.0,
                                  a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0,
                                  0.0)).astype(np.float32)
            w = w[:, None] if ax == 0 else w[None, :]
            term = w * np.take(x, np.clip(i0 + j - 1, 0, n_src - 1), axis=ax)
            out = term if out is None else out + term
        return out
    return axis(axis(img, rows, 0), cols, 1)


def wcs_oracle(cards, orig, tgt) -> dict:
    """CRPIX/CD (or CDELT) rescaled to the target dims, host f64
    (resample.rs:63-109), plus NAXIS1/2."""
    v = {k: float(x) for k, x in cards if k.startswith(("CRPIX", "CD"))}
    sx, sy = orig[1] / tgt[1], orig[0] / tgt[0]
    out = {}
    for k, sc in (("CRPIX1", sx), ("CRPIX2", sy)):
        if k in v:
            out[k] = (v[k] - 0.5) / sc + 0.5
    pairs = ((("CD1_1", sx), ("CD1_2", sy), ("CD2_1", sx), ("CD2_2", sy))
             if "CD1_1" in v else (("CDELT1", sx), ("CDELT2", sy)))
    for k, sc in pairs:
        if k in v:
            out[k] = v[k] * sc
    out["NAXIS1"], out["NAXIS2"] = float(tgt[1]), float(tgt[0])
    return out


def calibrate_export_path(bias, darks, flats, lights, calibrated, dres,
                          bench_frame, counters, smi):
    """Phase 4h: the calibrate, pipeline, drizzle, resample and export
    commands on files written under build/ from phase 4b's scene (16
    bias, 16 dark, 16 flat and 10 raw lights of 4096^2, and the 10 lights
    4b calibrated) and a bench frame. Each command runs cold (empty image
    cache) and warm, timed on the host clock ending in a synchronize, and
    is checked against what the card computes from the in-memory tensors
    (``calibrated`` and ``dres`` are 4b's ``calibrate`` and
    ``drizzle_stack``). The kernel counters are reset before and read
    after each of three runs: calibrate + pipeline (no kernel: every
    count 0), the drizzle command (K1, K2 and K7 launched), and the
    resample + export commands (no kernel); the composite exports run
    "cold" with the composite alone in the cache. Returns (launches
    summed over the three runs, times in ms)."""
    import base64
    import os
    import shutil
    import tempfile
    import zipfile
    import torch
    from astroburst_tpu_torch import api
    from astroburst_tpu_torch.api import helpers
    from astroburst_tpu_torch.dtypes import StfParams
    from astroburst_tpu_torch.imaging.calibration_pipeline import (
        ChannelInput, run_batch_pipeline)
    from astroburst_tpu_torch.imaging.resample import resample_image
    from astroburst_tpu_torch.imaging.stf import (apply_stf_f32,
                                                  apply_stf_u8, auto_stf)
    from astroburst_tpu_torch.io import (extract_image, try_extract_rgb,
                                         write_fits_mono, write_fits_rgb)
    from astroburst_tpu_torch.io.header import HduHeader
    from astroburst_tpu_torch.ops.ipc import nearest_downsample
    from astroburst_tpu_torch.ops.stats import compute_image_stats
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    dev = lights.device
    hw = lights.shape[-1]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="calibrate_export_", dir=build)
    out = os.path.join(root, "out")
    cmd_ms = {}
    t_phase = time.perf_counter()

    def run(name, fn):
        """(cold result, warm result): fn() with the image cache emptied
        first, then again; both timed on the host clock."""
        res = []
        for temp in ("cold", "warm"):
            if temp == "cold":
                GLOBAL_IMAGE_CACHE.clear()
            r, cmd_ms[f"{name}_{temp}"] = host_ms(fn)
            res.append(r)
        return res

    def expect(what, cond, detail=""):
        if not cond:
            raise AssertionError(f"{what} {detail}")

    def fits(path):
        return torch.from_numpy(extract_image(path).image).to(dev)

    def reset():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

    def read():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in counters.items()}

    try:
        t0 = time.perf_counter()
        paths = {name: write_fits_frames(os.path.join(root, name), stack)
                 for name, stack in (("bias", bias), ("dark", darks),
                                     ("flat", flats), ("light", lights),
                                     ("calibrated", calibrated))}
        p_wcs = os.path.join(root, "wcs_4096.fits")
        write_fits_mono(p_wcs, calibrated[0].cpu().numpy(),
                        HduHeader(WCS_CARDS))
        p_bench = os.path.join(root, "bench.fits")
        write_fits_mono(p_bench, bench_frame.cpu().numpy(),
                        HduHeader(CDELT_CARDS))
        nbytes = sum(os.path.getsize(p) for ps in paths.values() for p in ps)
        log(f"[data] calibrate/export: {sum(map(len, paths.values()))} "
            f"FITS files of {hw}^2, {nbytes / 1e9:.2f} GB, and two to "
            f"resample (written in {time.perf_counter() - t0:.1f} s)")
        cal = {"bias_paths": paths["bias"], "dark_paths": paths["dark"],
               "flat_paths": paths["flat"]}

        # -- calibrate and run_pipeline_cmd: no kernel -------------------
        reset()
        for res in run("calibrate", lambda: api.calibrate(
                paths["light"][0], out, **cal)):
            img = fits(res["fits_path"])
            expect("calibrate: _calibrated.fits", torch.equal(
                img, calibrated[0]), "differs from phase 4b's calibrate()")
            st = compute_image_stats(calibrated[0])
            expect("calibrate: stats", all(
                v == getattr(st, k) for k, v in res["stats"].items()))
            expect("calibrate: flags", (res["has_bias"], res["has_dark"],
                                        res["has_flat"]) == (True,) * 3)
            expect("calibrate: PNG", np.array_equal(
                decode_png(res["png_path"]),
                apply_stf_u8(calibrated[0], auto_stf(st), st).cpu().numpy()))
        channels = [{"label": c, "lights": paths["light"]} for c in "RGB"]
        ref = run_batch_pipeline([ChannelInput(c, list(lights))
                                  for c in "RGB"],
                                 array_masters(bias, darks, flats))
        for res in run("run_pipeline_cmd", lambda: api.run_pipeline_cmd(
                channels, out, **cal)):
            expect("run_pipeline_cmd: stats", res["stats"] == ref.stats,
                   f"{res['stats']} != {ref.stats}")
            for ch, (label, master) in zip(res["channels"],
                                           ref.master_channels):
                expect(f"master_{label}.fits", ch["label"] == label and
                       torch.equal(fits(ch["fits_path"]), master),
                       "differs from run_batch_pipeline on the card")
                st = compute_image_stats(master)
                want = nearest_downsample(apply_stf_u8(
                    master, auto_stf(st), st), 1024).cpu().numpy()
                expect(f"preview_b64 of {label}", np.array_equal(
                    decode_png(base64.b64decode(ch["preview_b64"])), want))
            rgb = try_extract_rgb(res["rgb_fits_path"])
            expect("pipeline_rgb.fits", all(np.array_equal(
                p, m.cpu().numpy()) for p, (_, m) in zip(
                    (rgb.r, rgb.g, rgb.b), ref.master_channels)))
        launches_cal = read()
        expect("calibrate + run_pipeline_cmd launched a kernel:",
               not any(launches_cal.values()), launches_cal)
        p_rgb = res["rgb_fits_path"]
        log(f"[path] calibrate: _calibrated.fits bit-equal to phase 4b's "
            f"calibrate(), PNG equal to the card's STF u8; run_pipeline_cmd "
            f"(3 x {len(paths['light'])} lights, masters from "
            f"{sum(len(cal[k]) for k in cal)} files): "
            f"masters and pipeline_rgb.fits bit-equal to run_batch_pipeline "
            f"on the card, previews equal; rejected per frame "
            f"{ref.stats['channels'][0]['lights_after_rejection']}; kernel "
            f"launches {launches_cal}")
        del ref
        for name in ("bias", "dark", "flat", "light"):
            shutil.rmtree(os.path.join(root, name))

        # -- drizzle_stack_cmd: K1, K2, K7 -------------------------------
        reset()
        drz = run("drizzle_stack_cmd", lambda: api.drizzle_stack_cmd(
            paths["calibrated"], out))
        launches_drz = read()
        for res in drz:
            expect("drizzled.fits", torch.equal(fits(res["fits_path"]),
                                                dres.image),
                   "differs from drizzle_stack(calibrated) of phase 4b")
            expect("drizzle_stack_cmd: response",
                   res["offsets"] == [[dx, dy] for dx, dy in dres.offsets]
                   and res["rejected_pixels"] == dres.rejected_pixels
                   and res["output_dims"] == list(dres.output_dims[::-1])
                   and res["input_dims"] == [hw, hw] and res["scale"] == 2.0
                   and res["frame_count"] == len(paths["calibrated"]),
                   {k: v for k, v in res.items() if k != "stats"})
        for name in ("coarse_box", "gather_crops", "drizzle_finalize_fused"):
            expect(f"{name} never ran in drizzle_stack_cmd:",
                   launches_drz[name] > 0, launches_drz)
        log(f"[path] drizzle_stack_cmd ({len(paths['calibrated'])} "
            f"calibrated FITS files, scale 2 → {dres.image.shape[0]}^2): "
            f"drizzled.fits bit-equal to phase 4b's drizzle_stack, offsets "
            f"and rejected count equal; kernel launches (cold + warm) "
            f"{launches_drz}")
        p_drz = drz[1]["fits_path"]
        drz_img = dres.image

        # -- resample and export: no kernel ------------------------------
        reset()
        resampled = {}
        for what, path, cards, (tw, th) in (
                ("resample_4096_to_2048", p_wcs, WCS_CARDS, (hw // 2,) * 2),
                ("resample_bench", p_bench, CDELT_CARDS,
                 BENCH_RESAMPLE_WH)):
            src = extract_image(path).image
            want = catmull_rom_oracle(src, th, tw)
            want_wcs = wcs_oracle(cards, src.shape, (th, tw))
            for res in run(what, lambda: api.resample_fits_cmd(
                    path, out, tw, th)):
                got = extract_image(res["fits_path"]).image
                d = float(np.abs(got - want).max())
                expect(what, got.shape == (th, tw) and
                       d <= 1e-5 * float(np.abs(want).max()),
                       f"{got.shape}, max|d| {d} against the tap oracle")
                expect(f"{what}: wcs_updates", res["wcs_updates"] ==
                       want_wcs, f"{res['wcs_updates']} != {want_wcs}")
            resampled[what] = (res["fits_path"], d)
        log(f"[path] resample_fits_cmd: {hw}^2 → {hw // 2}^2 and "
            f"{tuple(bench_frame.shape)} → {BENCH_RESAMPLE_WH[::-1]}, max|d| "
            f"against the numpy tap oracle "
            f"{[d for _, d in resampled.values()]}, wcs_updates exact")

        exports = []
        st_drz = compute_image_stats(drz_img)
        user = StfParams(shadow=0.01, midtone=0.3, highlight=1.0)
        for bitpix in (-32, 16):
            for stf in (False, True):
                o = os.path.join(root, f"drizzled_{bitpix}_{int(stf)}.fits")
                kw = dict(apply_stf_stretch=stf, shadow=user.shadow,
                          midtone=user.midtone, bitpix=bitpix)
                run(f"export_fits_{bitpix}_stf{int(stf)}",
                    lambda: api.export_fits(p_drz, o, **kw))
                exports.append(o)
                want = apply_stf_f32(drz_img, user, st_drz) if stf else \
                    drz_img
                got = fits(o)
                if bitpix == -32:
                    expect(f"export_fits -32 stf={stf}",
                           torch.equal(got, want))
                else:
                    hdr = extract_image(o).header
                    mx = float(want[torch.isfinite(want)].abs().max())
                    tol = 0.5 * hdr.get_f64("BSCALE") + 2 * float(
                        np.spacing(np.float32(mx)))
                    d = float((got - want).abs().max())
                    expect(f"export_fits 16 stf={stf}", d <= tol,
                           f"max|d| {d} > {tol}")

        light0 = calibrated[0]
        host0 = light0.cpu().numpy()
        finite = host0[np.isfinite(host0)]
        mn, mx = float(finite.min()), float(finite.max())
        lin = np.where(np.isfinite(host0),
                       np.clip((host0 - mn) / max(mx - mn, 1e-30), 0, 1), 0.0)
        for depth in (8, 16):
            o = os.path.join(root, f"light0_{depth}.png")
            run(f"export_png_mono_{depth}", lambda: api.export_png(
                paths["calibrated"][0], o, depth))
            exports.append(o)
            top = 65535.0 if depth == 16 else 255.0
            want = (np.clip(lin, 0.0, 1.0) * top).astype(
                np.uint16 if depth == 16 else np.uint8)
            expect(f"export_png mono {depth}",
                   np.array_equal(decode_png(o), want))

        def u16(planes):
            return np.stack([(np.clip(p.cpu().numpy(), 0.0, 1.0) * 65535.0
                              ).astype(np.uint16) for p in planes], -1)

        side = min(RGB_PNG_HW, hw)
        masters = [fits(os.path.join(out, f"master_{c}.fits"))[
            :side, :side].contiguous() for c in "RGB"]
        if side != hw:
            p_rgb = os.path.join(root, f"pipeline_rgb_{side}.fits")
            write_fits_rgb(p_rgb, *(m.cpu().numpy() for m in masters))
        o = os.path.join(root, "pipeline_rgb.png")
        run("export_png_rgb_16", lambda: api.export_png(p_rgb, o))
        exports.append(o)
        sts = [compute_image_stats(m) for m in masters]
        linked = helpers.compute_linked_stf(*sts)
        expect("export_png rgb", np.array_equal(decode_png(o), u16(
            [apply_stf_f32(m, linked, st) for m, st in zip(masters, sts)])))

        # export_fits_rgb from three files (4096^2, 4096^2, 2048^2: the
        # resample route), then from the composite cache
        p_half = resampled["resample_4096_to_2048"][0]
        o = os.path.join(root, "rgb_files.fits")
        run("export_fits_rgb_files", lambda: api.export_fits_rgb(
            o, paths["calibrated"][0], paths["calibrated"][1], p_half))
        exports.append(o)
        want = [calibrated[0], calibrated[1],
                resample_image(fits(p_half), hw, hw)]
        got = try_extract_rgb(o)
        expect("export_fits_rgb (files)", all(np.array_equal(
            g, w.cpu().numpy()) for g, w in zip((got.r, got.g, got.b),
                                                want)))
        # the composite cache: three calibrated lights (cold: the cache
        # holds the composite alone)
        comp = [c[:side, :side].contiguous() for c in calibrated[:3]]
        sts = [compute_image_stats(c) for c in comp]
        GLOBAL_IMAGE_CACHE.clear()
        helpers.insert_composite_rgb(*comp, *sts)
        o = os.path.join(root, "rgb_composite.fits")
        for temp in ("cold", "warm"):
            _, cmd_ms[f"export_fits_rgb_composite_{temp}"] = host_ms(
                lambda: api.export_fits_rgb(o, paths["calibrated"][0]))
        got = try_extract_rgb(o)
        expect("export_fits_rgb (composite)", all(np.array_equal(
            g, c.cpu().numpy()) for g, c in zip((got.r, got.g, got.b),
                                                comp)))
        exports.append(o)
        o = os.path.join(root, "rgb_composite.png")
        prm = [StfParams(0.01, 0.3, 1.0), StfParams(0.02, 0.35, 1.0),
               StfParams(0.0, 0.25, 0.95)]
        kw = dict(shadow_r=0.01, midtone_r=0.3, shadow_g=0.02,
                  midtone_g=0.35, shadow_b=0.0, midtone_b=0.25,
                  highlight_b=0.95)
        for temp in ("cold", "warm"):
            _, cmd_ms[f"export_rgb_png_16_{temp}"] = host_ms(
                lambda: api.export_rgb_png(o, **kw))
        exports.append(o)
        expect("export_rgb_png", np.array_equal(decode_png(o), u16(
            [apply_stf_f32(c, p, st) for c, p, st in zip(comp, prm, sts)])))
        GLOBAL_IMAGE_CACHE.remove_prefix("__composite")

        zpath = os.path.join(root, "bundle.zip")
        res = run("export_zip_bundle", lambda: api.export_zip_bundle(
            exports, zpath))[1]
        with zipfile.ZipFile(zpath) as zf:
            names = zf.namelist()
        expect("export_zip_bundle", res["skipped"] == [] and
               len(names) == len(exports) == len(res["files"]), names)
        launches_exp = read()
        expect("resample + export launched a kernel:",
               not any(launches_exp.values()), launches_exp)
        log(f"[path] export: export_fits of drizzled.fits at BITPIX -32 "
            f"(bit-equal) and 16 (half a quantum), STF on and off; "
            f"export_png mono 8/16 bits equal to the linear map, RGB "
            f"({side}^2, 16 bits) equal to the linked STF on the card; "
            f"export_fits_rgb from {hw}^2 + {hw}^2 + {hw // 2}^2 files "
            f"(resample route) and from the composite cache; export_rgb_png ({side}^2, "
            f"16 bits); export_zip_bundle of {len(names)} files; kernel "
            f"launches {launches_exp}")

        launches = {k: launches_cal[k] + launches_drz[k] + launches_exp[k]
                    for k in launches_drz}
        times = {"commands_ms": cmd_ms,
                 "phase_s": time.perf_counter() - t_phase}
        ref_note = "(reference: BASELINE.md, a Ryzen 9 7950X)"
        log(f"[time] {smi}: drizzle_stack_cmd {len(paths['calibrated'])} x "
            f"{hw}^2 → {drz_img.shape[0]}^2 from FITS: cold "
            f"{cmd_ms['drizzle_stack_cmd_cold']:.3f} ms, warm "
            f"{cmd_ms['drizzle_stack_cmd_warm']:.3f} ms; beside "
            f"{REF_DRIZZLE_MS:.0f} ms for the reference's drizzle "
            f"{ref_note}, as context, not a claim")
        log(f"[time] {smi}: calibrate/pipeline/drizzle/export commands "
            f"(phase 4h {times['phase_s']:.1f} s with its files and "
            f"checks): " + json.dumps(times))
        GLOBAL_IMAGE_CACHE.clear()
        return launches, times
    finally:
        shutil.rmtree(root)


# --- phase 4i: stretch, tone, denoise and detection, from files and the
# composite cache -------------------------------------------------------

COMP_HW = 2048   # phase 4i's composite side (cut from 4096: PERF.md §4)
SUB_N = 10           # the subframe command's files (seeds 0..9)


def same_stars(what, got, want):
    """A command's star list equals the module's DetectionResult."""
    if got != [s.to_dict() for s in want.stars]:
        raise AssertionError(f"{what}: the star list differs from "
                             f"detect_stars on the same plane")


def near_plain(what, got, plain):
    """A payload's stars against ``detect_stars(..., plain=True)``: the
    same count, each matched to its nearest within 1e-3 px and flux
    within 1e-4 relative (the 4c bounds: K11 sums in another order)."""
    a = np.array([(s["y"], s["x"], s["flux"]) for s in got])
    b = np.array([(s.y, s.x, s.flux) for s in plain.stars])
    if len(a) != len(b) or len(a) == 0:
        raise AssertionError(f"{what}: {len(a)} stars, {len(b)} plain")
    d2 = ((a[:, None, :2] - b[None, :, :2]) ** 2).sum(axis=2)
    near = d2.argmin(axis=1)
    d_pos = float(np.sqrt(d2.min(axis=1)).max())
    d_flux = float((np.abs(a[:, 2] - b[near, 2]) / b[near, 2]).max())
    if len(set(near.tolist())) != len(a) or d_pos > 1e-3 or d_flux > 1e-4:
        raise AssertionError(f"{what}: kernel and plain detections differ "
                             f"({d_pos} px, flux {d_flux})")
    return d_pos, d_flux


def tone_detect_path(field, truth, counters, smi, comp_hw=COMP_HW):
    """Phase 4i: the stretch, tone, denoise and detection commands. In:
    ``field`` (4d's 4096^2 star field in [0, 1), NaN patches and +-inf)
    as a BITPIX -32 FITS file, a 3 x comp_hw^2 composite made from its
    corner as ``masked_stretch_path`` makes its channels and a 3 x
    4096^2 one made so from the whole field (each in the cache through
    ``insert_composite_and_orig``), and SUB_N star fields of 4096^2
    (4d's scene at seeds 0..SUB_N-1) as FITS files, all under build/ and
    removed after. The file commands run cold (empty image cache) and
    warm, the composite commands once after a warm-up call, timed on the
    host clock ending in a synchronize; the kernel counters are reset
    just before each command's calls and read just after. Checks:

    - ``masked_stretch_cmd`` (defaults): its FITS bit-equal to
      ``masked_stretch`` on the card with the command's configuration;
      K10, K11 and K13 launched; ``masked_stretch_composite_cmd`` with
      ``shared_mask`` off and on: the per-channel responses and the
      preview equal to ``masked_stretch`` on each plane, or to
      ``masked_stretch_rgb_shared``; K13 launched in both modes;
    - ``detect_stars`` (sigma 5), ``detect_stars_composite`` (on the
      4096^2 composite), ``estimate_psf_cmd`` and ``analyze_subframes_cmd``: every star
      list equal to ``detect_stars`` on the same plane, ``detect_stars``
      near its plain version (``near_plain``) and within 0.3 px of the
      generator's isolated bright stars (``check_positions``), the PSF
      kernel equal to ``estimate_psf`` on the card; K10 and K11
      launched;
    - ``wavelet_denoise_cmd`` and ``extract_background_cmd`` (subtract
      and divide) against the same functions on the CPU on the fetched
      plane: the noise estimate, the cell medians, the global median
      and MAD and the model median bit-equal, the sample count and the
      RMS equal, the images within 1e-5 of the plane's largest
      magnitude; no kernel launched;
    - ``apply_arcsinh_stretch_cmd`` (factor 50, gamma 1 and 2.2),
      ``arcsinh_stretch_composite_cmd`` (factor 30) and
      ``apply_tone_composite_cmd`` (the defaults; then linked STF,
      levels on R, a three-point curve on G and SCNR maximum 0.8 with
      luminance) against their functions on the CPU: images within 1e-5,
      PNGs as decoded pixels within one level; no kernel launched.

    Returns (launches summed over the commands, times in ms)."""
    import os
    import shutil
    import tempfile
    from types import SimpleNamespace
    import torch
    from astroburst_tpu_torch import api
    from astroburst_tpu_torch.analysis import star_detection as SD
    from astroburst_tpu_torch.api import helpers
    from astroburst_tpu_torch.api.processing import (_levels_of,
                                                     _masked_stretch_config,
                                                     _points_of)
    from astroburst_tpu_torch.dtypes import ScnrConfig, ScnrMethod
    from astroburst_tpu_torch.imaging import background as BG
    from astroburst_tpu_torch.imaging import curves as CU
    from astroburst_tpu_torch.imaging import scnr as SC
    from astroburst_tpu_torch.imaging import stretch as ST
    from astroburst_tpu_torch.imaging import wavelet as WV
    from astroburst_tpu_torch.imaging.masked_stretch import (
        masked_stretch, masked_stretch_rgb_shared)
    from astroburst_tpu_torch.imaging.psf_estimation import (
        PsfEstimationConfig, estimate_psf)
    from astroburst_tpu_torch.imaging.stf import (apply_stf_f32,
                                                  apply_stf_u8, auto_stf)
    from astroburst_tpu_torch.io import extract_image, write_fits_mono
    from astroburst_tpu_torch.io.header import HduHeader
    from astroburst_tpu_torch.ops.ipc import nearest_downsample
    from astroburst_tpu_torch.ops.stats import (compute_image_stats,
                                                select_half)
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    f_ys, f_xs, f_amps, dead = truth
    dev = field.device
    cpu = torch.device("cpu")
    hw = field.shape[0]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="tone_detect_", dir=build)
    out = os.path.join(root, "out")
    cmd_ms, launches, total = {}, {}, {k: 0 for k in counters}
    t_phase = time.perf_counter()

    def expect(what, cond, detail=""):
        if not cond:
            raise AssertionError(f"{what} {detail}")

    def counted(name, fn, cold=True):
        """fn() cold and warm (or warm-up + timed when not ``cold``),
        with the counters reset just before and read just after; returns
        the last result."""
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        if cold:
            GLOBAL_IMAGE_CACHE.clear()
            _, cmd_ms[f"{name}_cold"] = host_ms(fn)
        else:
            fn()
        r, cmd_ms[f"{name}_warm" if cold else name] = host_ms(fn)
        torch.cuda.synchronize()
        launches[name] = {k: f.launches for k, f in counters.items()}
        for k, v in launches[name].items():
            total[k] += v
        return r

    def launched(name, kernels):
        got = launches[name]
        if kernels:
            expect(f"{name}: a kernel never ran:",
                   all(got[k] > 0 for k in kernels), got)
        else:
            expect(f"{name} launched a kernel:", not any(got.values()), got)

    def fits(path):
        return torch.from_numpy(extract_image(path).image)

    def same_bits(a, b):
        """Bit-equal f32 planes (NaN payloads included)."""
        a, b = a.cpu().contiguous(), b.cpu().contiguous()
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def close(what, got, want, tol=1e-5):
        """Within tol of the planes' largest finite magnitude; returns
        the measured maximum."""
        g, w = got.cpu(), want.cpu()
        fin = torch.isfinite(w)
        expect(what, torch.equal(fin, torch.isfinite(g)), "(finite sets)")
        top = max(float(w[fin].abs().max()), 1e-30)
        d = float((g[fin] - w[fin]).abs().max())
        expect(what, d <= tol * top, f"max|d| {d} > {tol} x {top}")
        return d / top

    def png_close(what, path, want_u8):
        """Decoded PNG pixels within one level of ``want_u8``; returns
        the share of pixels that differ."""
        px = decode_png(path).astype(np.int64)
        want = want_u8.astype(np.int64)
        expect(what, px.shape == want.shape, f"{px.shape} {want.shape}")
        d = np.abs(px - want)
        expect(what, int(d.max()) <= 1, f"PNG off by {int(d.max())} levels")
        return float((d > 0).mean())

    def mono_u8(plane):
        st = compute_image_stats(plane)
        return apply_stf_u8(nearest_downsample(plane, 4096), auto_stf(st),
                            st).cpu().numpy()

    def rgb_u8(planes):
        return np.stack([helpers._to_u8(nearest_downsample(p, 4096)).cpu()
                         .numpy() for p in planes], -1)

    try:
        t0 = time.perf_counter()
        p_field = os.path.join(root, "field.fits")
        write_fits_mono(p_field, field.cpu().numpy(),
                        HduHeader([("OBJECT", "'chip_smoke 4i'")]))
        sub_paths = []
        for seed in range(SUB_N):
            sub, *_ = star_scene(DET_HW, DET_HW, DET_STARS, seed, dev)
            sub_paths.append(os.path.join(root, f"sub_{seed:02d}.fits"))
            write_fits_mono(sub_paths[-1], sub.cpu().numpy(),
                            HduHeader([("OBJECT", f"'sub {seed}'")]))
            del sub
        t_files = time.perf_counter() - t0
        host = field.cpu()
        err = {}

        # -- masked stretch: K10, K11, K13 -------------------------------
        cfg = _masked_stretch_config(None, None, None, None, None, None)
        res = counted("masked_stretch_cmd",
                      lambda: api.masked_stretch_cmd(p_field, out))
        launched("masked_stretch_cmd",
                 ("sort_tiles", "window_stats", "paint_mask"))
        mod = masked_stretch(field, cfg)
        expect("masked_stretch_cmd: FITS", same_bits(
            fits(res["fits_path"]), mod.image), "differs from "
            "masked_stretch on the card")
        expect("masked_stretch_cmd: response", (
            res["iterations_run"], res["stars_masked"],
            res["mask_coverage"], res["final_background"],
            res["converged"]) == (mod.iterations_run, mod.stars_masked,
                                  mod.mask_coverage, mod.final_background,
                                  mod.converged), res)
        expect("masked_stretch_cmd: PNG", np.array_equal(
            decode_png(res["png_path"]), mono_u8(mod.image)))
        log(f"[path] masked_stretch_cmd {hw}^2: {res['stars_masked']} stars "
            f"masked, coverage {res['mask_coverage']:.4f}, "
            f"{res['iterations_run']} iterations, converged "
            f"{res['converged']}; FITS bit-equal to masked_stretch; "
            f"launches {launches['masked_stretch_cmd']}")

        # -- detection: K10, K11 -----------------------------------------
        res = counted("detect_stars", lambda: api.detect_stars(p_field, 5.0))
        launched("detect_stars", ("sort_tiles", "window_stats"))
        same_stars("detect_stars", res["stars"], SD.detect_stars(field, 5.0))
        d_pos, d_flux = near_plain("detect_stars", res["stars"],
                                   SD.detect_stars(field, 5.0, plain=True))
        err["detect_stars_4k_px"] = check_positions(
            "[path] detect_stars (command)", SimpleNamespace(stars=[
                SimpleNamespace(**s) for s in res["stars"]]), f_ys, f_xs,
            isolated_bright(f_ys, f_xs, f_amps, hw, hw, 2700.0, dead=dead))
        log(f"[path] detect_stars {hw}^2: {res['star_count']} stars, "
            f"background {res['background_median']:.6g} +- "
            f"{res['background_sigma']:.3g}; equal to detect_stars, vs "
            f"plain {d_pos:.2e} px / flux {d_flux:.2e}; launches "
            f"{launches['detect_stars']}")

        res = counted("estimate_psf_cmd",
                      lambda: api.estimate_psf_cmd(p_field))
        launched("estimate_psf_cmd", ("sort_tiles", "window_stats"))
        psf = estimate_psf(field, PsfEstimationConfig())
        expect("estimate_psf_cmd", res["kernel"] == psf.kernel.tolist() and
               res["stars_used"] == [s.to_dict() for s in psf.stars_used]
               and res["spread_pixels"] == psf.spread_pixels)
        expect("estimate_psf_cmd: kernel sum", abs(float(
            psf.kernel.sum()) - 1.0) < 1e-4 and len(psf.stars_used) >= 10)
        log(f"[path] estimate_psf_cmd {hw}^2: {len(res['stars_used'])} stars "
            f"used, {res['stars_rejected']} rejected, FWHM "
            f"{res['average_fwhm']:.4f} px, spread "
            f"{res['spread_pixels']:.4f} px; equal to estimate_psf; "
            f"launches {launches['estimate_psf_cmd']}")

        res = counted("analyze_subframes_cmd",
                      lambda: api.analyze_subframes_cmd(sub_paths))
        launched("analyze_subframes_cmd", ("sort_tiles", "window_stats"))
        expect("analyze_subframes_cmd", res["frame_count"] == SUB_N)
        for p, m in zip(sub_paths, res["frames"]):
            sub = fits(p).to(dev)
            det = SD.detect_stars(sub, 4.0)
            expect(f"analyze_subframes_cmd {os.path.basename(p)}",
                   m["star_count"] == len(det.stars) and
                   m["background_median"] == det.background_median, m)
        expect("analyze_subframes_cmd: all accepted",
               res["accepted_count"] == SUB_N, res["accepted_count"])
        log(f"[path] analyze_subframes_cmd {SUB_N} x {hw}^2: accepted_count "
            f"{res['accepted_count']}, stars "
            f"{[m['star_count'] for m in res['frames']]}, weights "
            f"{[round(m['weight'], 4) for m in res['frames']]}; launches "
            f"{launches['analyze_subframes_cmd']}")

        # -- wavelet and background against the CPU ----------------------
        res = counted("wavelet_denoise_cmd",
                      lambda: api.wavelet_denoise_cmd(p_field, out))
        launched("wavelet_denoise_cmd", ())
        ref = WV.wavelet_denoise(host, WV.WaveletConfig())
        expect("wavelet_denoise_cmd: noise estimate",
               res["noise_estimate"] == ref.noise_estimate,
               f"{res['noise_estimate']} vs CPU {ref.noise_estimate}")
        err["wavelet_denoise"] = close("wavelet_denoise_cmd",
                                       fits(res["fits_path"]), ref.denoised)
        err["wavelet_png_share"] = png_close(
            "wavelet_denoise_cmd: PNG", res["png_path"],
            mono_u8(ref.denoised))
        log(f"[path] wavelet_denoise_cmd {hw}^2 (5 scales): noise "
            f"{res['noise_estimate']:.6g} bit-equal to the CPU's, image "
            f"max|d|/max {err['wavelet_denoise']:.3e}; launches "
            f"{launches['wavelet_denoise_cmd']}")
        gh = hw // 8
        packed = [BG._cell_medians(p, 8, gh, gh).cpu() for p in (field,
                                                                   host)]
        expect("background: cell medians, median and MAD",
               torch.equal(packed[0], packed[1]), "differ from the CPU's")
        for mode in ("subtract", "divide"):
            name = f"extract_background_cmd_{mode}"
            res = counted(name, lambda: api.extract_background_cmd(
                p_field, out, mode=mode))
            launched(name, ())
            ref = BG.extract_background(host, BG.BackgroundConfig(mode=mode))
            mod = BG.extract_background(field, BG.BackgroundConfig(mode=mode))
            expect(f"{name}: samples", (res["sample_count"],
                                        res["rms_residual"]) == (
                ref.sample_count, ref.rms_residual), res)
            mm = [select_half(torch.where(
                torch.isfinite(m) & (m > 0), m, float("inf")).reshape(-1),
                (torch.isfinite(m) & (m > 0)).sum()).cpu()
                for m in (mod.model, ref.model)]
            expect(f"{name}: model median", torch.equal(mm[0], mm[1]),
                   f"{mm}")
            expect(f"{name}: FITS", same_bits(fits(
                res["corrected_fits"]), mod.corrected))
            err[name] = close(name, mod.corrected, ref.corrected)
            err[f"{name}_model"] = close(name, mod.model, ref.model)
            png_close(f"{name}: PNG", res["corrected_png"],
                      mono_u8(ref.corrected))
            log(f"[path] {name} {hw}^2: {res['sample_count']} samples, RMS "
                f"{res['rms_residual']:.6g} (equal to the CPU's), corrected "
                f"max|d|/max {err[name]:.3e}, model "
                f"{err[f'{name}_model']:.3e}; launches {launches[name]}")

        # -- arcsinh on the file -----------------------------------------
        st = compute_image_stats(host)
        for gamma in (1.0, 2.2):
            name = f"apply_arcsinh_stretch_cmd_g{gamma}"
            res = counted(name, lambda: api.apply_arcsinh_stretch_cmd(
                p_field, out, 50.0, gamma))
            launched(name, ())
            ref = ST.arcsinh_stretch_with_stats(host, st.min, st.max, 50.0,
                                                gamma)
            err[name] = close(name, fits(res["fits_path"]), ref)
            err[f"{name}_png_share"] = png_close(f"{name}: PNG",
                                                 res["png_path"],
                                                 mono_u8(ref))
            log(f"[path] {name} {hw}^2: image max|d| {err[name]:.3e} of the "
                f"CPU's, PNG pixels differing "
                f"{err[f'{name}_png_share']:.2e}; launches {launches[name]}")

        # -- the composite -----------------------------------------------
        def composite(base):
            """Three channels made from ``base`` as masked_stretch_path
            makes them, in the cache; returns them and their stats."""
            GLOBAL_IMAGE_CACHE.clear()
            g = torch.Generator(device=dev).manual_seed(27)
            rgb = [base, 0.8 * base + 5e-4 * torch.randn(
                base.shape, generator=g, device=dev), 1.2 * base - 4e-3]
            sts = [compute_image_stats(c) for c in rgb]
            helpers.insert_composite_and_orig(*rgb, *sts)
            return rgb, sts

        rgb, sts = composite(field[:comp_hw, :comp_hw].contiguous())
        rgb_host = [c.cpu() for c in rgb]

        for shared in (False, True):
            mode = "shared" if shared else "per_channel"
            name = f"masked_stretch_composite_cmd_{mode}"
            res = counted(name, lambda: api.masked_stretch_composite_cmd(
                out, shared_mask=shared), cold=False)
            launched(name, ("paint_mask",))
            if shared:
                mod = masked_stretch_rgb_shared(*rgb, cfg)
                chans = [mod[c] for c in "rgb"]
                want = (mod["shared_stars_masked"],
                        mod["shared_mask_coverage"])
            else:
                chans = [masked_stretch(c, cfg) for c in rgb]
                want = (sum(r.stars_masked for r in chans),
                        sum(r.mask_coverage for r in chans) / 3.0)
            expect(name, (res["stars_masked"], res["mask_coverage"]) == want
                   and all(res["channels"][c] == {
                       "iterations_run": r.iterations_run,
                       "final_background": r.final_background,
                       "converged": r.converged}
                       for c, r in zip("rgb", chans)), res)
            expect(f"{name}: PNG", np.array_equal(decode_png(
                res["png_path"]), rgb_u8([r.image for r in chans])))
            log(f"[path] {name} 3 x {comp_hw}^2: {res['stars_masked']} stars, "
                f"coverage {res['mask_coverage']:.4f}, iterations "
                f"{[res['channels'][c]['iterations_run'] for c in 'rgb']}; "
                f"equal to the module calls; launches {launches[name]}")

        res = counted("arcsinh_stretch_composite_cmd",
                      lambda: api.arcsinh_stretch_composite_cmd(out, 30.0),
                      cold=False)
        launched("arcsinh_stretch_composite_cmd", ())
        ref = ST.arcsinh_stretch_rgb(*rgb_host, 30.0)
        err["arcsinh_composite_png_share"] = png_close(
            "arcsinh_stretch_composite_cmd: PNG", res["png_path"],
            rgb_u8(ref))
        dev_planes = ST.arcsinh_stretch_rgb(*rgb, 30.0)
        err["arcsinh_composite"] = max(close("arcsinh composite", a, b)
                                       for a, b in zip(dev_planes, ref))

        tone_cases = {
            "defaults": {},
            "linked_levels_curve_scnr": dict(
                linked_stf=True, levels_r={"black": 0.02, "gamma": 1.3,
                                           "white": 0.95},
                curves_g={"points": [[0.0, 0.0], [0.35, 0.5], [1.0, 1.0]]},
                scnr={"method": "maximum", "amount": 0.8,
                      "preserveLuminance": True})}
        for case, kw in tone_cases.items():
            name = f"apply_tone_composite_cmd_{case}"
            res = counted(name, lambda: api.apply_tone_composite_cmd(
                out, **kw), cold=False)
            launched(name, ())
            if kw.get("linked_stf"):
                p, comb = helpers.compute_linked_stf_with_stats(*sts)
                prms, norms = [p] * 3, [comb] * 3
            else:
                prms, norms = [auto_stf(s) for s in sts], sts
            planes = [apply_stf_f32(c, q, n) for c, q, n in
                      zip(rgb_host, prms, norms)]
            flags = (False, False, False)
            if kw:
                planes = list(CU.apply_levels_rgb(*planes, *(
                    _levels_of(kw.get(k)) for k in ("levels_r", "levels_g",
                                                    "levels_b"))))
                planes = list(CU.apply_curve_rgb(*planes, *(
                    CU.SplineCurve(_points_of(kw.get(k)) or
                                   [(0.0, 0.0), (1.0, 1.0)])
                    for k in ("curves_r", "curves_g", "curves_b"))))
                planes = list(SC.apply_scnr(*planes, ScnrConfig(
                    ScnrMethod.MAXIMUM_NEUTRAL, 0.8, True)))
                flags = (True, True, True)
            expect(name, (res["levels_applied"], res["curves_applied"],
                          res["scnr_applied"]) == flags and
                   res["stf"] == prms[0].to_dict(), res)
            err[f"{name}_png_share"] = png_close(f"{name}: PNG",
                                                 res["png_path"],
                                                 rgb_u8(planes))
            log(f"[path] {name} 3 x {comp_hw}^2: flags {flags}, PNG pixels "
                f"differing from the CPU's {err[f'{name}_png_share']:.2e}; "
                f"launches {launches[name]}")

        # composite detection writes no PNG: at full width
        del rgb, rgb_host
        rgb, _ = composite(field)
        res = counted("detect_stars_composite",
                      lambda: api.detect_stars_composite(), cold=False)
        launched("detect_stars_composite", ("sort_tiles", "window_stats"))
        lum = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
        same_stars("detect_stars_composite", res["stars"],
                   SD.detect_stars(lum, 5.0))
        log(f"[path] detect_stars_composite 3 x {hw}^2: "
            f"{res['star_count']} stars, equal to detect_stars on the "
            f"luminance; launches {launches['detect_stars_composite']}")
        del rgb, lum
        GLOBAL_IMAGE_CACHE.clear()

        # the device stages alone: each command's module call on the card
        stage_ms = {name: cuda_ms(fn, 3) for name, fn in (
            ("masked_stretch", lambda: masked_stretch(field, cfg)),
            ("detect_stars", lambda: SD.detect_stars(field, 5.0)),
            ("estimate_psf", lambda: estimate_psf(field,
                                                  PsfEstimationConfig())),
            ("wavelet_denoise", lambda: WV.wavelet_denoise(
                field, WV.WaveletConfig())),
            ("extract_background", lambda: BG.extract_background(
                field, BG.BackgroundConfig())),
            ("arcsinh_stretch", lambda: ST.arcsinh_stretch_with_stats(
                field, st.min, st.max, 50.0, 2.2)),
            ("stats_auto_stf", lambda: auto_stf(compute_image_stats(field))))}
        times = {"commands_ms": cmd_ms, "device_stages_ms": stage_ms,
                 "files_s": t_files,
                 "phase_s": time.perf_counter() - t_phase}
        log(f"[path] phase 4i errors: {json.dumps(err)}")
        log(f"[time] {smi}: stretch/tone/denoise/detection commands (phase "
            f"4i {times['phase_s']:.1f} s with its files and checks; "
            f"composite commands 3 x {comp_hw}^2, composite detection "
            f"3 x {hw}^2): " + json.dumps(times))
        return total, times
    finally:
        shutil.rmtree(root)


PC_SHIFTS = ((2.3, -1.7), (-3.6, 4.2))   # G and B against R, (dy, dx)
AFF_DEG = 0.4                            # G rotated about the centre ...
AFF_SHIFT_G, AFF_SHIFT_B = (1.5, -2.5), (-2.2, 3.1)   # ... and shifted
DRZ_RGB_N, DRZ_RGB_HW = 4, 1024          # drizzle_rgb: 3 x 4 frames
NB_BINS = ("sii", "ha", "oiii", "nii")   # the blend's narrowband planes


def compose_path(field, truth, counters, smi, wiz_hw=COMP_HW):
    """Phase 4j: the compose commands. In, written as FITS under build/
    (removed after): R, the 4096^2 field of 4c (its NaN patches and
    +-inf included; left 4 columns zero), and from the same star list,
    rendered analytically with their own noise: G and B moved by
    PC_SHIFTS (x0.8 and x1.2; top 6 rows and right 9 columns zero), G
    rotated by AFF_DEG about the centre and moved by AFF_SHIFT_G, B moved
    by AFF_SHIFT_B, an L plane, and four narrowband planes (NB_BINS) of
    wiz_hw^2. The compose and alignment commands run at the field's
    side: ``compose_rgb_cmd`` by phase correlation (K1, K2), by the
    affine method (K10, K11, K12) and with L, ``align_channels_cmd``
    (persisted to disk), ``crop_channels_cmd`` and
    ``export_aligned_channels_cmd``; the wizard's other PNG-writing
    commands at wiz_hw (``blend_channels_cmd`` → ``compute_auto_wb_cmd``
    → ``calibrate_and_scnr_cmd`` → ``reset_wb_cmd`` →
    ``restretch_composite_cmd`` → ``update_composite_channel_cmd`` →
    ``clear_composite_cache_cmd``); then ``process_drizzle_rgb`` on the
    three phase-correlation planes and ``drizzle_rgb`` on three channels
    of DRZ_RGB_N dithered DRZ_RGB_HW^2 frames (K1, K2, K7). Each command
    cold (empty image cache) and warm, or twice where it reads no file,
    timed on the host clock ending in a synchronize; the kernel counters
    are reset just before each command and read just after. Checks:

    - offsets within 0.1 px of the generator's (phase correlation: the
      shifts; affine: the translation of the forward transform), the
      rotation within 0.1 deg;
    - the cache planes (ORIG, KEY, the wizard's aligned and cropped
      keys) and the written FITS bit-equal to the module calls on the
      card (``process_rgb``, ``blend_channels``, ``align_pair``, the
      factors × ORIG → ``apply_scnr``), ORIG never changed through KEY;
    - every PNG, decoded, equal to the u8 of the card's planes;
    - the modules on the card against their plain path (kernels off):
      ``process_rgb`` offsets within 0.05 px and planes within the
      offsets' difference times their gradient, the affine transform
      within 1e-3 with the same method and inliers, ``drizzle_rgb`` the
      same; ``process_drizzle_rgb`` within 1e-6 of the CPU's.

    Returns (launches summed over the commands, times in ms)."""
    import os
    import shutil
    import tempfile
    import torch
    from astroburst_tpu_torch import api
    from astroburst_tpu_torch import constants as C
    from astroburst_tpu_torch.alignment.affine import (align_channel_affine,
                                                       warp_image)
    from astroburst_tpu_torch.alignment.pair import align_pair
    from astroburst_tpu_torch.alignment.phase_correlation import \
        phase_correlate
    from astroburst_tpu_torch.api import helpers
    from astroburst_tpu_torch.api.compose import detect_valid_region
    from astroburst_tpu_torch.compose.channel_blend import blend_channels
    from astroburst_tpu_torch.compose.drizzle_rgb import (
        drizzle_rgb, process_drizzle_rgb)
    from astroburst_tpu_torch.compose.lrgb import apply_lrgb
    from astroburst_tpu_torch.compose.rgb import process_rgb
    from astroburst_tpu_torch.compose.white_balance import \
        select_wb_reference
    from astroburst_tpu_torch.dtypes import (AlignMethod, RgbComposeConfig,
                                             StfParams)
    from astroburst_tpu_torch.imaging.scnr import apply_scnr
    from astroburst_tpu_torch.imaging.stf import (apply_stf_f32,
                                                  apply_stf_u8, auto_stf)
    from astroburst_tpu_torch.io import extract_image, write_fits_mono
    from astroburst_tpu_torch.io.header import HduHeader
    from astroburst_tpu_torch.metadata.presets import resolve_preset_weights
    from astroburst_tpu_torch.ops.ipc import nearest_downsample
    from astroburst_tpu_torch.ops.stats import compute_image_stats
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    f_ys, f_xs, f_amps, _dead = truth
    dev = field.device
    hw = field.shape[0]
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="compose_", dir=build)
    out = os.path.join(root, "out")
    cmd_ms, launches, total = {}, {}, {k: 0 for k in counters}
    t_phase = time.perf_counter()

    def expect(what, cond, detail=""):
        if not cond:
            raise AssertionError(f"{what} {detail}")

    def counted(name, fn, cold=True):
        """fn() cold and warm (or twice, when not ``cold``: first and
        second), the counters reset just before and read just after;
        returns the last result."""
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        if cold:
            GLOBAL_IMAGE_CACHE.clear()
        _, cmd_ms[f"{name}_{'cold' if cold else 'first'}"] = host_ms(fn)
        r, cmd_ms[f"{name}_{'warm' if cold else 'second'}"] = host_ms(fn)
        torch.cuda.synchronize()
        launches[name] = {k: f.launches for k, f in counters.items()}
        for k, v in launches[name].items():
            total[k] += v
        return r

    def launched(name, kernels):
        got = launches[name]
        if kernels:
            expect(f"{name}: a kernel never ran:",
                   all(got[k] > 0 for k in kernels), got)
        else:
            expect(f"{name} launched a kernel:", not any(got.values()), got)

    def fits(path):
        return torch.from_numpy(extract_image(path).image).to(dev)

    def same_bits(a, b):
        a, b = a.contiguous(), b.contiguous()
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def near(what, got, want, tol):
        d = float(np.abs(np.subtract(got, want)).max())
        expect(what, d <= tol, f"{got} vs {want}: {d} > {tol}")
        return d

    def grad_max(p):
        d = [torch.abs(torch.diff(p, dim=k)) for k in (0, 1)]
        return max(float(x[torch.isfinite(x)].max()) for x in d)

    def close_moved(what, got, want, d_off, rel=1e-5):
        """Planes within rel of their largest magnitude plus the offsets'
        difference times their largest one-pixel change."""
        fin = torch.isfinite(want)
        expect(what, torch.equal(fin, torch.isfinite(got)), "finite sets")
        top = float(want[fin].abs().max())
        d = float((got[fin] - want[fin]).abs().max())
        tol = rel * top + d_off * grad_max(want)
        expect(what, d <= tol, f"max|d| {d} > {tol}")
        return d

    def rgb_u8(planes):
        return np.stack([helpers._to_u8(nearest_downsample(p, 4096)).cpu()
                         .numpy() for p in planes], -1)

    def stf_rgb_u8(planes, prms, sts):
        return np.stack([apply_stf_u8(nearest_downsample(p, 4096), q, s)
                         .cpu().numpy() for p, q, s in zip(planes, prms,
                                                           sts)], -1)

    def png_is(what, path, want):
        expect(f"{what}: PNG", np.array_equal(decode_png(path), want),
               "differs from the u8 of the card's planes")

    def render(ys, xs, scale, seed, side=hw):
        g = torch.Generator(device=dev).manual_seed(seed)
        img = 100.0 + 5.0 * torch.randn((side, side), generator=g,
                                        device=dev)
        return scale * (img + render_stars(side, side, ys, xs, f_amps, 0.0,
                                           0.0, 1.5, dev))

    def write(name, plane, k=0):
        p = os.path.join(root, f"{name}.fits")
        write_fits_mono(p, plane.cpu().numpy(), HduHeader([
            ("OBJECT", f"'chip_smoke 4j {name}'"),
            ("CRPIX1", f"{hw / 2 + 0.5 + k}"), ("CRPIX2", f"{hw / 2 - k}")]))
        return p

    try:
        # -- the scene --------------------------------------------------
        t0 = time.perf_counter()
        c = hw / 2.0
        th = math.radians(AFF_DEG)
        co, si = math.cos(th), math.sin(th)
        aff_g = (c - si * c - co * c + AFF_SHIFT_G[0],
                 c - co * c + si * c + AFF_SHIFT_G[1])   # (ty, tx) forward
        r_plane = field.clone()
        r_plane[:, :4] = 0.0
        g_pc = render(f_ys + PC_SHIFTS[0][0], f_xs + PC_SHIFTS[0][1], 0.8, 41)
        g_pc[:6] = 0.0
        b_pc = render(f_ys + PC_SHIFTS[1][0], f_xs + PC_SHIFTS[1][1], 1.2, 42)
        b_pc[:, -9:] = 0.0
        g_aff = render(si * (f_xs - c) + co * (f_ys - c) + c + AFF_SHIFT_G[0],
                       co * (f_xs - c) - si * (f_ys - c) + c + AFF_SHIFT_G[1],
                       0.9, 43)
        b_aff = render(f_ys + AFF_SHIFT_B[0], f_xs + AFF_SHIFT_B[1], 1.1, 44)
        l_plane = render(f_ys, f_xs, 1.0, 45)
        p = {"r": write("r", r_plane), "g": write("g", g_pc, 1),
             "b": write("b", b_pc, 2), "g_aff": write("g_aff", g_aff),
             "b_aff": write("b_aff", b_aff), "l": write("l", l_plane)}
        del g_aff, b_aff, l_plane
        nb = {}
        for k, (name, s) in enumerate(zip(NB_BINS, (0.3, 1.0, 0.5, 0.2))):
            nb[name] = write(f"nb_{name}", render(f_ys, f_xs, s, 50 + k,
                                                  wiz_hw))
        t_files = time.perf_counter() - t0
        err = {}

        # -- compose_rgb_cmd by phase correlation: K1, K2 ----------------
        res = counted("compose_rgb_cmd", lambda: api.compose_rgb_cmd(
            out, r_path=p["r"], g_path=p["g"], b_path=p["b"]))
        launched("compose_rgb_cmd", ("coarse_box", "gather_crops"))
        err["pc_offset_g"] = near("compose_rgb_cmd offset_g",
                                  res["offset_g"], PC_SHIFTS[0], 0.1)
        err["pc_offset_b"] = near("compose_rgb_cmd offset_b",
                                  res["offset_b"], PC_SHIFTS[1], 0.1)
        rgb_in = [fits(p[k]) for k in "rgb"]
        cfg = RgbComposeConfig(linked_stf=False)
        mod = process_rgb(*rgb_in, cfg)
        expect("compose_rgb_cmd: offsets", res["offset_g"] == list(
            mod.offset_g) and res["offset_b"] == list(mod.offset_b))
        keys = (C.COMPOSITE_ORIG_R, C.COMPOSITE_ORIG_G, C.COMPOSITE_ORIG_B,
                C.COMPOSITE_KEY_R, C.COMPOSITE_KEY_G, C.COMPOSITE_KEY_B)
        ent = [GLOBAL_IMAGE_CACHE.get(k, dev) for k in keys]
        for k, n in enumerate("rgb"):
            expect(f"compose_rgb_cmd: ORIG/KEY {n}",
                   ent[k].image is ent[k + 3].image and same_bits(
                       ent[k].image, getattr(mod, f"pre_stretch_{n}")))
        png_is("compose_rgb_cmd", res["png_path"],
               rgb_u8([mod.r, mod.g, mod.b]))
        plain = process_rgb(*rgb_in, cfg, plain=True)
        d_off = max(near("process_rgb kernel vs plain", mod.offset_g,
                         plain.offset_g, 0.05),
                    near("process_rgb kernel vs plain", mod.offset_b,
                         plain.offset_b, 0.05))
        err["process_rgb_plain_offsets"] = d_off
        err["process_rgb_plain_planes"] = max(
            close_moved(f"process_rgb kernel vs plain {n}",
                        getattr(mod, f"pre_stretch_{n}"),
                        getattr(plain, f"pre_stretch_{n}"), 2 * d_off)
            for n in "rgb")
        tmp_png = os.path.join(root, "png_alone.png")
        _, png_ms = host_ms(lambda: helpers.render_rgb_preview(
            mod.r, mod.g, mod.b, tmp_png, 4096))
        cmd_ms["rgb_png_alone"] = png_ms
        del plain
        log(f"[path] compose_rgb_cmd (phase correlation) 3 x {hw}^2: "
            f"offsets G {res['offset_g']} B {res['offset_b']} (generator "
            f"{PC_SHIFTS}); ORIG/KEY and PNG equal to process_rgb on the "
            f"card; kernel vs plain offsets {d_off:.2e} px; launches "
            f"{launches['compose_rgb_cmd']}")

        # -- compose_rgb_cmd by the affine chain: K10, K11, K12 -----------
        res = counted("compose_rgb_cmd_affine", lambda: api.compose_rgb_cmd(
            out, r_path=p["r"], g_path=p["g_aff"], b_path=p["b_aff"],
            align_method="affine"))
        launched("compose_rgb_cmd_affine",
                 ("sort_tiles", "window_stats", "vote"))
        err["aff_offset_g"] = near("compose_rgb_cmd affine offset_g",
                                   res["offset_g"], aff_g, 0.1)
        err["aff_offset_b"] = near("compose_rgb_cmd affine offset_b",
                                   res["offset_b"], AFF_SHIFT_B, 0.1)
        aff_in = [rgb_in[0], fits(p["g_aff"]), fits(p["b_aff"])]
        acfg = RgbComposeConfig(linked_stf=False,
                                align_method=AlignMethod.AFFINE)
        amod = process_rgb(*aff_in, acfg)
        for k, n in enumerate("rgb"):
            expect(f"compose_rgb_cmd affine: ORIG {n}", same_bits(
                GLOBAL_IMAGE_CACHE.get(keys[k], dev).image,
                getattr(amod, f"pre_stretch_{n}")))
        png_is("compose_rgb_cmd affine", res["png_path"],
               rgb_u8([amod.r, amod.g, amod.b]))
        rot = {}
        for n, tgt in (("g", aff_in[1]), ("b", aff_in[2])):
            kr = align_channel_affine(aff_in[0], tgt)
            pr = align_channel_affine(aff_in[0], tgt, plain=True)
            rot[n] = kr.transform.rotation_deg()
            d_t = float(np.abs(np.subtract(kr.transform.as_tuple(),
                                           pr.transform.as_tuple())).max())
            expect(f"affine {n} kernel vs plain", (kr.method, kr.inliers) ==
                   (pr.method, pr.inliers) and d_t <= 1e-3,
                   f"{kr} vs {pr}")
            expect(f"affine {n}: offset", (kr.transform.ty, kr.transform.tx)
                   == tuple(res[f"offset_{n}"]), res[f"offset_{n}"])
            err[f"aff_{n}_plain_transform"] = d_t
        err["aff_rotation_g"] = near("compose_rgb_cmd affine rotation",
                                     rot["g"], AFF_DEG, 0.1)
        near("compose_rgb_cmd affine rotation of B", rot["b"], 0.0, 0.1)
        del amod
        log(f"[path] compose_rgb_cmd (affine) 3 x {hw}^2: offsets G "
            f"{res['offset_g']} (generator {aff_g}), B {res['offset_b']} "
            f"(generator {AFF_SHIFT_B}), rotation {rot['g']:.4f} deg; "
            f"ORIG and PNG equal to process_rgb; launches "
            f"{launches['compose_rgb_cmd_affine']}")

        # -- compose_rgb_cmd with L (LRGB) --------------------------------
        res = counted("compose_rgb_cmd_lrgb", lambda: api.compose_rgb_cmd(
            out, l_path=p["l"], r_path=p["r"], g_path=p["g"],
            b_path=p["b"], lrgb_lightness=0.8, lrgb_chrominance=0.9))
        launched("compose_rgb_cmd_lrgb", ("coarse_box", "gather_crops"))
        expect("compose_rgb_cmd lrgb", res["lrgb_applied"], res)
        l_in = fits(p["l"])
        l_st = compute_image_stats(l_in)
        lrgb = apply_lrgb(apply_stf_f32(l_in, auto_stf(l_st), l_st), mod.r,
                          mod.g, mod.b, 0.8, 0.9)
        png_is("compose_rgb_cmd lrgb", res["png_path"], rgb_u8(lrgb))
        del lrgb, l_in
        log(f"[path] compose_rgb_cmd (LRGB) 3 x {hw}^2: PNG equal to the "
            f"module's LRGB; launches {launches['compose_rgb_cmd_lrgb']}")

        # -- the wizard: align → crop → export at full width ---------------
        res = counted("align_channels_cmd", lambda: api.align_channels_cmd(
            [p["r"], p["g"], p["b"]], out, None, ["r", "g", "b"], True))
        launched("align_channels_cmd", ("coarse_box", "gather_crops"))
        for ch, truth_off in zip(res["channels"][1:], PC_SHIFTS):
            err[f"align_{ch['channel']}"] = near(
                f"align_channels_cmd {ch['channel']}", ch["offset"],
                truth_off, 0.1)
        aligned = [rgb_in[0]] + [align_pair(rgb_in[0], t,
                                            AlignMethod.PHASE_CORRELATION,
                                            hw, hw).aligned
                                 for t in rgb_in[1:]]
        for k, (key, a) in enumerate(zip(res["cache_keys"], aligned)):
            expect(f"align_channels_cmd {key}", same_bits(
                GLOBAL_IMAGE_CACHE.get(key, dev).image, a))
            if k:
                expect(f"align_channels_cmd {key}: FITS", same_bits(
                    fits(os.path.join(out, f"aligned_{'rgb'[k]}.fits")), a))
        keys_al = res["cache_keys"]
        res = counted("crop_channels_cmd", lambda: api.crop_channels_cmd(
            keys_al, out, ["r", "g", "b"]), cold=False)
        launched("crop_channels_cmd", ())
        reg = [detect_valid_region(a, 1e-6) for a in aligned]
        box = (max(r_[0] for r_ in reg), min(r_[1] for r_ in reg),
               max(r_[2] for r_ in reg), min(r_[3] for r_ in reg))
        cr = res["crop_region"]
        expect("crop_channels_cmd: region", (cr["top"], cr["bottom"],
                                             cr["left"], cr["right"]) == box
               and box != (0, hw, 0, hw), cr)
        for key, a in zip(res["cache_keys"], aligned):
            e = GLOBAL_IMAGE_CACHE.get(key, dev).image
            expect(f"crop_channels_cmd {key}", e.is_contiguous() and
                   same_bits(e, a[box[0]:box[1], box[2]:box[3]]))
        res = counted("export_aligned_channels_cmd",
                      lambda: api.export_aligned_channels_cmd(
                          [p["r"], p["g"], p["b"]], out))
        launched("export_aligned_channels_cmd", ("coarse_box",
                                                 "gather_crops"))
        for k, (ch, a) in enumerate(zip(res["channels"], aligned)):
            fi = extract_image(ch["path"])
            expect(f"export_aligned_channels_cmd {k}", same_bits(
                torch.from_numpy(fi.image).to(dev), a))
            dy, dx = ch["offset"]
            expect(f"export_aligned_channels_cmd {k}: CRPIX", abs(
                fi.header.get_f64("CRPIX1") - (hw / 2 + 0.5 + k - dx))
                < 1e-9 and abs(fi.header.get_f64("CRPIX2") -
                               (hw / 2 - k - dy)) < 1e-9)
        del aligned
        log(f"[path] align_channels_cmd / crop_channels_cmd / "
            f"export_aligned_channels_cmd 3 x {hw}^2: offsets "
            f"{[ch['offset'] for ch in res['channels']]}, crop {box}; cache "
            f"planes and FITS equal to align_pair on the card; launches "
            f"{launches['align_channels_cmd']}, "
            f"{launches['export_aligned_channels_cmd']}")

        # -- the wizard's colour flow at wiz_hw ----------------------------
        nb_paths = [nb[b] for b in NB_BINS]
        weights = [{"channelIdx": w["channel_idx"], "r": w["r_weight"],
                    "g": w["g_weight"], "b": w["b_weight"]}
                   for w in resolve_preset_weights("hubble_legacy",
                                                   list(NB_BINS))]
        weights.append({"channel_idx": 3, "r_weight": 0.2, "g_weight": 0.0,
                        "b_weight": 0.05})
        res = counted("blend_channels_cmd", lambda: api.blend_channels_cmd(
            nb_paths, weights, out, "hubble_legacy"))
        launched("blend_channels_cmd", ())
        nb_in = [fits(q) for q in nb_paths]
        blended = blend_channels(nb_in, [
            {"channel_idx": w.get("channelIdx", w.get("channel_idx")),
             "r_weight": w.get("r", w.get("r_weight")),
             "g_weight": w.get("g", w.get("g_weight")),
             "b_weight": w.get("b", w.get("b_weight"))} for w in weights])
        orig = helpers.load_composite_orig_rgb(dev)
        for o, b_ in zip(orig, blended):
            expect("blend_channels_cmd: ORIG", same_bits(o.image, b_))
        sts = [o.stats for o in orig]
        linked = helpers.compute_linked_stf(*sts)
        png_is("blend_channels_cmd", res["png_path"],
               stf_rgb_u8(blended, [linked] * 3, sts))
        snap = [o.image.clone() for o in orig]
        wb = counted("compute_auto_wb_cmd", api.compute_auto_wb_cmd,
                     cold=False)
        launched("compute_auto_wb_cmd", ())
        factors = (wb["r_factor"], wb["g_factor"], wb["b_factor"])
        expect("compute_auto_wb_cmd", factors == select_wb_reference(*sts))
        res = counted("calibrate_and_scnr_cmd",
                      lambda: api.calibrate_and_scnr_cmd(
                          out, *factors, True, "maximum", 0.8, True),
                      cold=False)
        launched("calibrate_and_scnr_cmd", ())
        want = apply_scnr(*(o.image * f for o, f in zip(orig, factors)),
                          helpers.parse_scnr_config(True, "maximum", 0.8,
                                                    True))
        key = helpers.load_composite_rgb(dev)
        for k_, w_ in zip(key, want):
            expect("calibrate_and_scnr_cmd: KEY", same_bits(k_.image, w_))
        lk = helpers.compute_linked_stf(*(k_.stats for k_ in key))
        png_is("calibrate_and_scnr_cmd", res["png_path"], stf_rgb_u8(
            want, [lk] * 3, [k_.stats for k_ in key]))
        res = counted("reset_wb_cmd", lambda: api.reset_wb_cmd(out),
                      cold=False)
        launched("reset_wb_cmd", ())
        key = helpers.load_composite_rgb(dev)
        expect("reset_wb_cmd: KEY is ORIG", all(
            k_.image is o.image for k_, o in zip(key, orig)))
        png_is("reset_wb_cmd", res["png_path"],
               stf_rgb_u8(blended, [linked] * 3, sts))
        args = (0.02, 0.2, 1.0, 0.03, 0.25, 0.98, 0.01, 0.3, 1.0)
        res = counted("restretch_composite_cmd",
                      lambda: api.restretch_composite_cmd(out, *args, True,
                                                          "average", 0.5),
                      cold=False)
        launched("restretch_composite_cmd", ())
        planes = apply_scnr(*(apply_stf_f32(
            o.image, StfParams(*args[3 * i:3 * i + 3]), o.stats)
            for i, o in enumerate(orig)), helpers.parse_scnr_config(
                True, "average", 0.5, None))
        png_is("restretch_composite_cmd", res["png_path"], rgb_u8(planes))
        expect("ORIG never written through KEY", all(
            same_bits(o.image, s) for o, s in zip(
                helpers.load_composite_orig_rgb(dev), snap)))
        res = counted("update_composite_channel_cmd",
                      lambda: api.update_composite_channel_cmd(
                          "g", nb["oiii"]), cold=False)
        launched("update_composite_channel_cmd", ())
        og = GLOBAL_IMAGE_CACHE.get(C.COMPOSITE_ORIG_G, dev)
        expect("update_composite_channel_cmd", og.image is GLOBAL_IMAGE_CACHE
               .get(C.COMPOSITE_KEY_G, dev).image and same_bits(
                   og.image, fits(nb["oiii"])))
        counted("clear_composite_cache_cmd", api.clear_composite_cache_cmd,
                cold=False)
        launched("clear_composite_cache_cmd", ())
        expect("clear_composite_cache_cmd", all(
            GLOBAL_IMAGE_CACHE.get(k) is None for k in keys))
        del blended, orig, key, snap, want, planes, nb_in
        log(f"[path] blend → auto WB → WB + SCNR → reset → restretch → "
            f"update → clear, 3 x {wiz_hw}^2: ORIG equal to blend_channels, "
            f"KEY to ORIG x {tuple(round(f, 6) for f in factors)} → "
            f"apply_scnr, every PNG equal to the card's u8; no kernel")

        # -- drizzle_rgb: K1, K2, K7 ---------------------------------------
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        pd, t_pd = host_ms(lambda: process_drizzle_rgb(*rgb_in))
        cmd_ms["process_drizzle_rgb"] = t_pd
        expect("process_drizzle_rgb: finite", all(bool(torch.isfinite(
            getattr(pd, f"{n}_stretched")).all()) for n in "rgb"))
        # against the CPU on the wiz_hw^2 corner (the CPU's sorts of
        # 4096^2 planes would take the phase's budget)
        corner = [x[:wiz_hw, :wiz_hw] for x in rgb_in]
        pd = process_drizzle_rgb(*corner)
        pd_cpu = process_drizzle_rgb(*(x.cpu() for x in corner))
        err["process_drizzle_rgb_vs_cpu"] = max(
            float((getattr(pd, f"{n}_stretched").cpu()
                   - getattr(pd_cpu, f"{n}_stretched")).abs().max())
            for n in "rgb")
        expect("process_drizzle_rgb vs the CPU",
               err["process_drizzle_rgb_vs_cpu"] <= 1e-6 and pd.wb ==
               pd_cpu.wb, err["process_drizzle_rgb_vs_cpu"])
        del pd, pd_cpu, corner
        drng = np.random.default_rng(61)
        dith = drng.uniform(-2.0, 2.0, (DRZ_RGB_N, 2))
        dith[0] = 0.0
        d_ys = drng.uniform(10, DRZ_RGB_HW - 10, 400)
        d_xs = drng.uniform(10, DRZ_RGB_HW - 10, 400)
        d_amps = drng.uniform(300.0, 3000.0, 400)
        gen = torch.Generator(device=dev).manual_seed(62)
        chans = [[s * (100.0 + render_stars(
            DRZ_RGB_HW, DRZ_RGB_HW, d_ys, d_xs, d_amps, dy, dx, 1.5, dev)
            + 3.0 * torch.randn((DRZ_RGB_HW, DRZ_RGB_HW), generator=gen,
                                device=dev)) for dy, dx in dith]
            for s in (1.0, 0.8, 1.2)]
        for f in counters.values():
            f.launches = 0
        (drz, dres), t_d = host_ms(lambda: drizzle_rgb(*chans))
        torch.cuda.synchronize()
        launches["drizzle_rgb"] = {k: f.launches for k, f in
                                   counters.items()}
        for k, v in launches["drizzle_rgb"].items():
            total[k] += v
        launched("drizzle_rgb", ("coarse_box", "gather_crops",
                                 "drizzle_finalize_fused"))
        cmd_ms["drizzle_rgb"] = t_d
        expect("drizzle_rgb: dims", drz.out_dims == (2 * DRZ_RGB_HW,) * 2 and
               drz.frame_counts == {"r": DRZ_RGB_N, "g": DRZ_RGB_N,
                                    "b": DRZ_RGB_N}, drz.out_dims)
        drz_p, dres_p = drizzle_rgb(*chans, plain=True)
        for n in "rgb":
            off = np.asarray(dres[n].offsets)[:, ::-1]
            err[f"drizzle_rgb_{n}_offsets"] = near(
                f"drizzle_rgb {n} offsets", off, dith, 0.15)
            d_off = near(f"drizzle_rgb {n} kernel vs plain offsets",
                         dres[n].offsets, dres_p[n].offsets, 0.05)
            err[f"drizzle_rgb_{n}_plain"] = close_moved(
                f"drizzle_rgb {n} kernel vs plain",
                getattr(drz, f"{n}_linear"), getattr(drz_p, f"{n}_linear"),
                2 * d_off)
        del drz, drz_p, dres, dres_p, chans
        log(f"[path] process_drizzle_rgb 3 x {hw}^2 {t_pd:.1f} ms; at "
            f"{wiz_hw}^2 within {err['process_drizzle_rgb_vs_cpu']:.2e} of "
            f"the CPU's; "
            f"drizzle_rgb 3 x {DRZ_RGB_N} x {DRZ_RGB_HW}^2 → "
            f"{2 * DRZ_RGB_HW}^2: offsets within 0.15 px of the dithers, "
            f"kernel vs plain {[err[f'drizzle_rgb_{n}_plain'] for n in 'rgb']}"
            f"; launches {launches['drizzle_rgb']}")
        GLOBAL_IMAGE_CACHE.clear()

        # the device stages alone, by CUDA events
        stage_ms = {name: cuda_ms(fn, 3) for name, fn in (
            ("phase_correlate", lambda: phase_correlate(rgb_in[0],
                                                        rgb_in[1])),
            ("align_pair_phase_correlation", lambda: align_pair(
                rgb_in[0], rgb_in[1], AlignMethod.PHASE_CORRELATION, hw,
                hw)),
            ("align_channel_affine+warp_image", lambda: warp_image(
                aff_in[1], align_channel_affine(aff_in[0], aff_in[1])
                .transform, hw, hw)),
            ("process_rgb_phase_correlation", lambda: process_rgb(
                *rgb_in, cfg)),
            ("process_rgb_affine", lambda: process_rgb(*aff_in, acfg)),
            ("compute_image_stats", lambda: compute_image_stats(
                rgb_in[0])))}
        times = {"commands_ms": cmd_ms, "device_stages_ms": stage_ms,
                 "rgb_png_share_of_warm_compose": png_ms / cmd_ms[
                     "compose_rgb_cmd_warm"],
                 "files_s": t_files,
                 "phase_s": time.perf_counter() - t_phase}
        log(f"[path] phase 4j errors: {json.dumps(err)}")
        log(f"[time] {smi}: compose commands (phase 4j "
            f"{times['phase_s']:.1f} s with its files and checks; compose "
            f"and alignment 3 x {hw}^2, the wizard's colour commands 3 x "
            f"{wiz_hw}^2): " + json.dumps(times))
        return total, times
    finally:
        shutil.rmtree(root)


SYNTH_N, SYNTH_HW, SYNTH_STARS = 16, 4096, 3000   # BASELINE.md:13
CUBE_SHAPE = (2048, 512, 512)   # 2 GiB of f32 (BASELINE.md:21)
CUBE_CARDS = [("CTYPE3", "'WAVE'"), ("CUNIT3", "'um'"),
              ("CRVAL3", "0.6"), ("CDELT3", "0.0005"), ("CRPIX3", "1.0")]
TILE_RGB_HW = 4096   # phase 4k's RGB pyramid side (PERF.md §4)
RL_CROP = 512        # the RL card-against-CPU check's crop


def cube_bytes(cube, cards) -> bytes:
    """A primary HDU of an [C, H, W] f32 tensor, written here and not
    by the port's writer: the header with ``cards``, then the samples
    big-endian (byte-swapped on the card, fetched once)."""
    import torch

    def card(key, value):
        return f"{key:<8}= {value:>20}".ljust(80).encode()
    c, h, w = cube.shape
    head = [card("SIMPLE", "T"), card("BITPIX", "-32"), card("NAXIS", "3"),
            card("NAXIS1", str(w)), card("NAXIS2", str(h)),
            card("NAXIS3", str(c))] + [card(k, v) for k, v in cards]
    blob = b"".join(head) + b"END".ljust(80)
    blob += b" " * (-len(blob) % 2880)
    swapped = cube.contiguous().view(torch.uint8).reshape(-1, 4).flip(1) \
        .cpu().numpy()
    return blob + swapped.tobytes() + b"\0" * (-swapped.size % 2880)


def cube_synth_path(field, bench_frame, counters, smi,
                    rgb_hw=TILE_RGB_HW):
    """Phase 4k: the FFT, deconvolution, cube, tile and synth commands
    (A13 + A14), at the sizes users run, under build/ (removed after).
    Each command twice, timed on the host clock ending in a synchronize
    ("cold" after the image cache and the open lazy cubes are cleared,
    "warm" after it), with its peak device memory (beyond what the
    phase already held, such as its own copy of the cube); the kernel
    counters are reset just before each command's two calls and read
    just after.

    - synth: ``generate_synth_stack_cmd`` at the UI's defaults (5 x
      2048^2, 500 stars) and at SYNTH_N x SYNTH_HW^2 with SYNTH_STARS
      stars (each call's FITS byte-identical to the other's, frame 0
      and the ground truth bit-equal to ``synth.generate`` on the card),
      then the ``stack`` command on those files (K1, K2, K3; offsets
      within 0.1 px of 0, the background within 1% of the noise
      model's); ``generate_synth_cmd`` for each PSF and field type with
      the vignette on; the card's ground truth within 1e-6 of its
      largest value of the CPU's (512^2, 60 stars);
    - ``deconvolve_rl_cmd`` on 4c's field (its NaN/inf pixels set to 0:
      RL spreads a NaN over the whole plane) as FITS, 20 iterations,
      kernel 15, and with the estimated PSF (K10, K11): the FITS
      bit-equal to ``richardson_lucy`` on the card; ``richardson_lucy``
      on the card within 5e-5 of its largest value of the CPU's on a
      RL_CROP^2 crop, the same iterations;
    - ``compute_fft_spectrum`` on that file (4096^2 FFT) and on a bench
      frame of 5655 x 2206 (8192^2): the header exact, the bytes equal
      to the truncating u8 of ``compute_power_spectrum`` on the card,
      its |X| (the log1p undone) within 1e-5 of the largest of the CPU's
      (FFT rounding is normwise: a coefficient near 0 can differ by
      much of its own size; f32 log1p near the largest |X| alone is
      ~1.2e-6 of it), the bytes within one level of the CPU's;
    - a CUBE_SHAPE f32 cube (2 GiB, CUBE_CARDS) made on the card:
      ``get_cube_info`` (the open), ``process_cube_lazy_cmd``,
      ``get_cube_frame``, ``get_cube_spectrum`` and ``process_cube_cmd``
      (eager, on the card): the geometry, classification and
      wavelengths, spectra bit-equal to the cube, PNGs equal to the u8
      of the card's planes, the global stats and the median collapse on
      the card bit-equal to the CPU's on a 64-channel slice;
    - ``generate_tiles`` on the 4096^2 file at tile 256 and
      ``generate_tiles_rgb`` on a 3 x rgb_hw^2 composite filled by
      ``compose_rgb_cmd`` (K1, K2) from three synth frames: the pyramid
      and tile counts, and the decoded tiles of the coarsest level
      equal to the module calls on the card and to the port's CPU run
      on the same planes;
    - the device stages alone by CUDA events: ``richardson_lucy``,
      ``render_stars``, ``apply_noise``, ``compute_power_spectrum`` and
      the cube's stats and collapses.

    Returns (launches summed over the commands, times)."""
    import filecmp
    import os
    import shutil
    import struct
    import tempfile
    import torch
    from astroburst_tpu_torch import api
    from astroburst_tpu_torch import constants as C
    from astroburst_tpu_torch.analysis.deconvolution import (
        generate_gaussian_psf, richardson_lucy)
    from astroburst_tpu_torch.analysis.fft import compute_power_spectrum
    from astroburst_tpu_torch.api import cube as cube_api
    from astroburst_tpu_torch.api import helpers
    from astroburst_tpu_torch.api.synth import _build_config
    from astroburst_tpu_torch.cube import eager as CE
    from astroburst_tpu_torch.dtypes import RLConfig
    from astroburst_tpu_torch.imaging.stf import (apply_stf_f32,
                                                  apply_stf_u8, auto_stf)
    from astroburst_tpu_torch.io import extract_image, write_fits_mono
    from astroburst_tpu_torch.io.header import HduHeader
    from astroburst_tpu_torch.ops.stats import compute_image_stats
    from astroburst_tpu_torch.render import tiles as RT
    from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE
    from astroburst_tpu_torch.synth import generate
    from astroburst_tpu_torch.synth.noise import apply_noise
    from astroburst_tpu_torch.synth.pipeline import _ground_truth
    cpu = torch.device("cpu")
    dev = field.device
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="cube_synth_", dir=build)
    out = os.path.join(root, "out")
    cmd_ms, launches, peak_gib, err, stage_ms = {}, {}, {}, {}, {}
    total = {k: 0 for k in counters}
    t_phase = time.perf_counter()

    def expect(what, cond, detail=""):
        if not cond:
            raise AssertionError(f"{what} {detail}")

    def reset_caches():
        GLOBAL_IMAGE_CACHE.clear()
        with cube_api._LAZY_LOCK:
            for c in cube_api._LAZY_CUBES.values():
                c.close()
            cube_api._LAZY_CUBES.clear()

    def counted(name, fn, cold=reset_caches):
        """fn(0) after ``cold()`` and fn(1), timed, with the counters
        reset just before and read just after and the peak device
        memory the two allocate beyond what was held before them;
        returns both results."""
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        cold()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r0, cmd_ms[f"{name}_cold"] = host_ms(lambda: fn(0))
        r1, cmd_ms[f"{name}_warm"] = host_ms(lambda: fn(1))
        torch.cuda.synchronize()
        peak_gib[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        launches[name] = {k: f.launches for k, f in counters.items()}
        for k, v in launches[name].items():
            total[k] += v
        log(f"[4k] {name}: cold {cmd_ms[f'{name}_cold']:.3f} ms, warm "
            f"{cmd_ms[f'{name}_warm']:.3f} ms, peak device memory "
            f"{peak_gib[name]:.3f} GiB, launches {launches[name]}")
        return r0, r1

    def launched(name, kernels):
        got = launches[name]
        if kernels:
            expect(f"{name}: a kernel never ran:",
                   all(got[k] > 0 for k in kernels), got)
        else:
            expect(f"{name} launched a kernel:", not any(got.values()), got)

    def same_bits(a, b):
        a, b = a.cpu().contiguous(), b.cpu().contiguous()
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def fits(path):
        return torch.from_numpy(extract_image(path).image)

    def same_files(what, a, b):
        expect(f"{what}: not byte-identical", all(
            filecmp.cmp(x, y, shallow=False) for x, y in zip(a, b)))

    def near_u8(what, got, want):
        """u8 planes within one level; returns how many differ."""
        d = np.abs(got.astype(np.int64) - want)
        expect(what, d.max() <= 1, f"max {d.max()}")
        return int((d > 0).sum())

    def write(name, plane):
        p = os.path.join(root, f"{name}.fits")
        write_fits_mono(p, plane.cpu().numpy(),
                        HduHeader([("OBJECT", f"'chip_smoke 4k {name}'")]))
        return p

    try:
        os.makedirs(out)
        # -- synth: the UI's defaults, then the bench's 16 x 4096^2 -------
        s5 = counted("generate_synth_stack_cmd(5x2048^2)", lambda i: api.
                     generate_synth_stack_cmd(os.path.join(root, f"s5_{i}")))
        launched("generate_synth_stack_cmd(5x2048^2)", ())
        expect("synth stack keys", set(s5[0]) == {
            C.RES_FRAMES, C.RES_FRAME_COUNT, "ground_truth_path",
            "catalog_path", "star_count", C.RES_ELAPSED_MS})
        expect("synth stack defaults", s5[0][C.RES_FRAME_COUNT] == 5 and
               s5[0]["star_count"] == 500 and
               fits(s5[0][C.RES_FRAMES][0]).shape == (2048, 2048))
        same_files("generate_synth_stack_cmd defaults", [
            *s5[0][C.RES_FRAMES], s5[0]["ground_truth_path"]],
            [*s5[1][C.RES_FRAMES], s5[1]["ground_truth_path"]])
        s16 = counted(f"generate_synth_stack_cmd({SYNTH_N}x{SYNTH_HW}^2)",
                      lambda i: api.generate_synth_stack_cmd(
                          os.path.join(root, f"s16_{i}"), SYNTH_N, SYNTH_HW,
                          SYNTH_HW, SYNTH_STARS))
        frames16 = s16[0][C.RES_FRAMES]
        same_files("generate_synth_stack_cmd 16", [
            *frames16, s16[0]["ground_truth_path"]],
            [*s16[1][C.RES_FRAMES], s16[1]["ground_truth_path"]])
        cfg16 = _build_config(SYNTH_HW, SYNTH_HW, SYNTH_STARS, None, None,
                              None, None, None, None, 1)
        noisy0, gt16, _ = generate(cfg16, dev)
        expect("synth frame 0 / ground truth against synth.generate",
               same_bits(fits(frames16[0]), noisy0) and same_bits(
                   fits(s16[0]["ground_truth_path"]), gt16))
        del noisy0
        shutil.rmtree(os.path.join(root, "s16_1"))
        small = _build_config(512, 512, 60, 5, None, None, None, None, None,
                              1)
        g_card, _ = _ground_truth(small, dev)
        g_cpu, _ = _ground_truth(small, cpu)
        err["render_stars_card_vs_cpu"] = float(
            (g_card.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
        expect("render_stars card vs CPU",
               err["render_stars_card_vs_cpu"] <= 1e-6)

        st16 = counted(f"stack({SYNTH_N}x{SYNTH_HW}^2 synth)",
                       lambda i: api.stack(frames16,
                                           os.path.join(root, "stacked")))
        launched(f"stack({SYNTH_N}x{SYNTH_HW}^2 synth)",
                 ("shift_clip", "coarse_box", "gather_crops"))
        offs = np.abs(np.asarray(st16[1][C.RES_OFFSETS], np.float64))
        err["stack_offsets_px"] = float(offs.max())
        expect("stack offsets of undithered synth frames", offs.max() < 0.1)
        nz = cfg16.noise
        bg = (nz.sky_background * nz.gain * nz.exposure_time
              + nz.dark_current * nz.exposure_time + nz.bias_level) / nz.gain
        med = st16[1][C.RES_STATS][C.RES_MEDIAN]
        expect("stacked background", abs(med - bg) <= 0.01 * bg,
               f"{med} vs {bg}")

        for psf in ("gaussian", "moffat", "airy"):
            for ft in ("uniform", "king_cluster", "exponential_disk"):
                name = f"generate_synth_cmd({psf},{ft})"
                r = counted(name, lambda i: api.generate_synth_cmd(
                    os.path.join(root, f"one_{i}"), field_type=ft,
                    psf_type=psf, apply_vignette=True))
                launched(name, ())
                same_files(name, [r[0][C.RES_FITS_PATH]],
                           [r[1][C.RES_FITS_PATH]])
                expect(name, r[0]["star_count"] == 500)

        # -- deconvolution: 4c's field, 20 iterations, kernel 15 ---------
        hw = field.shape[0]
        scrub = torch.where(torch.isfinite(field), field, 0.0)
        p_field = write("field", scrub)
        rl = counted("deconvolve_rl_cmd", lambda i: api.deconvolve_rl_cmd(
            p_field, out, 20, None, 15))
        launched("deconvolve_rl_cmd", ())
        psf15 = generate_gaussian_psf(15, 2.0)
        mod = richardson_lucy(scrub, psf15, RLConfig())
        expect("deconvolve_rl_cmd FITS against richardson_lucy", same_bits(
            fits(rl[1][C.RES_FITS_PATH]), mod.image) and
            rl[1][C.RES_ITERATIONS_RUN] == mod.iterations_run)
        expect("deconvolve_rl_cmd finite",
               bool(torch.isfinite(mod.image).all()))
        del mod
        rle = counted("deconvolve_rl_cmd(estimated PSF)",
                      lambda i: api.deconvolve_rl_cmd(
                          p_field, out, 20, use_estimated_psf=True))
        launched("deconvolve_rl_cmd(estimated PSF)",
                 ("sort_tiles", "window_stats"))
        crop = scrub[:RL_CROP, :RL_CROP].contiguous()
        a = richardson_lucy(crop, psf15, RLConfig())
        b = richardson_lucy(crop.cpu(), psf15, RLConfig())
        err["rl_crop_card_vs_cpu"] = float(
            (a.image.cpu() - b.image).abs().max() / b.image.abs().max())
        expect("richardson_lucy card vs CPU",
               err["rl_crop_card_vs_cpu"] <= 5e-5 and
               a.iterations_run == b.iterations_run)
        stage_ms[f"richardson_lucy({hw}^2,20,k15)"] = cuda_ms(
            lambda: richardson_lucy(scrub, psf15, RLConfig()), 2)
        stage_ms[f"render_stars({SYNTH_HW}^2,{SYNTH_STARS})"] = cuda_ms(
            lambda: _ground_truth(cfg16, dev), 3)
        stage_ms[f"apply_noise({SYNTH_HW}^2)"] = cuda_ms(
            lambda: apply_noise(gt16, cfg16.noise), 3)

        # -- the display spectrum: 4096^2 and the bench frame (8192^2) ---
        p_bench = write("bench", bench_frame)
        for name, path, plane in (
                (f"compute_fft_spectrum({hw}^2)", p_field, scrub),
                (f"compute_fft_spectrum({bench_frame.shape[1]}x"
                 f"{bench_frame.shape[0]})", p_bench, bench_frame)):
            size = 1 << (max(plane.shape) - 1).bit_length()
            disp = min(size, 1024)
            blob = counted(name, lambda i: api.compute_fft_spectrum(path))[1]
            launched(name, ())
            w, h, dc, mx, _ms, orig, win, pad = struct.unpack("<IIffIIII",
                                                              blob[:32])
            expect(f"{name} header", (w, h, orig, win, pad) ==
                   (disp, disp, size, 1, 0), (w, h, orig, win, pad))
            got = np.frombuffer(blob[32:], np.uint8).reshape(disp, disp)
            card = compute_power_spectrum(plane).spectrum.cpu().numpy()
            spec = compute_power_spectrum(plane.cpu()).spectrum.numpy()
            # the transforms' rounding is normwise: compare |X| (box
            # means of log1p|X| undone) against the largest one
            mag, mag_cpu = np.expm1(card), np.expm1(spec)
            err[f"{name}_card_vs_cpu"] = float(np.abs(mag - mag_cpu).max()
                                               / mag_cpu.max())
            err[f"{name}_log_card_vs_cpu"] = float(np.abs(card - spec).max())
            log(f"[4k] {name}: card against CPU {err[f'{name}_card_vs_cpu']:.3e}"
                f" of the largest |X|, log1p {err[f'{name}_log_card_vs_cpu']:.3e}")
            expect(f"{name} spectrum card vs CPU",
                   err[f"{name}_card_vs_cpu"] <= 1e-5)
            expect(f"{name} max/dc", (mx, dc) == (card.max(), card[
                disp // 2, disp // 2]))

            def u8(sp):
                mn = float(sp.min())
                return ((sp - mn) * (255.0 / max(float(sp.max()) - mn,
                                                 1e-10))).astype(np.uint8)
            expect(f"{name} bytes", np.array_equal(got, u8(card)))
            err[f"{name}_u8_off_cpu"] = near_u8(f"{name} bytes card vs CPU",
                                                got, u8(spec))

        for name, plane in ((f"{hw}^2", scrub), (
                f"{bench_frame.shape[1]}x{bench_frame.shape[0]}",
                bench_frame)):
            stage_ms[f"compute_power_spectrum({name})"] = cuda_ms(
                lambda: compute_power_spectrum(plane), 3)

        # -- the 2 GiB spectral cube ------------------------------------
        t0 = time.perf_counter()
        depth, ch, cw = CUBE_SHAPE
        g = torch.Generator(device=dev).manual_seed(4)
        z = torch.arange(depth, device=dev, dtype=torch.float32)[:, None,
                                                                 None]
        yy = torch.arange(ch, device=dev, dtype=torch.float32)[:, None]
        xx = torch.arange(cw, device=dev, dtype=torch.float32)[None, :]
        src = torch.exp(-((yy - ch / 2) ** 2 + (xx - cw / 2) ** 2) / 800.0)
        cube = (1.0 + 0.2 * src + 5.0 * src * torch.exp(
            -(z - depth / 2) ** 2 / 200.0)
            + 0.05 * torch.randn(CUBE_SHAPE, generator=g, device=dev))
        cube[:, 10:14, 20:30] = float("nan")     # dead spaxels
        cube[:, 40:44, :] = 0.0                  # a masked row band
        p_cube = os.path.join(root, "cube.fits")
        with open(p_cube, "wb") as f:
            f.write(cube_bytes(cube, CUBE_CARDS))
        t_cube_file = time.perf_counter() - t0
        info = counted("get_cube_info", lambda i: api.get_cube_info(p_cube))
        launched("get_cube_info", ())
        expect("get_cube_info", (info[0][C.RES_NAXIS1], info[0][
            C.RES_NAXIS2], info[0][C.RES_NAXIS3], info[0][C.RES_BITPIX]) ==
            (cw, ch, depth, -32) and info[0][C.RES_SPECTRAL_CLASSIFICATION][
                "is_spectral"] and len(info[0][C.RES_WAVELENGTHS]) == depth
            and info[0][C.RES_WAVELENGTHS][0] == 0.6, info[0])
        lazy = counted("process_cube_lazy_cmd",
                       lambda i: api.process_cube_lazy_cmd(p_cube, out))
        launched("process_cube_lazy_cmd", ())
        centre = cube[:, ch // 2, cw // 2].cpu()
        expect("process_cube_lazy_cmd", lazy[1][C.RES_FRAME_COUNT] == 16
               and lazy[1]["total_frames"] == depth and same_bits(
                   torch.tensor(lazy[1]["center_spectrum"]), centre))
        fr = counted("get_cube_frame",
                     lambda i: api.get_cube_frame(p_cube, depth // 2, out))
        launched("get_cube_frame", ())
        plane = cube[depth // 2]
        expect("get_cube_frame PNG", np.array_equal(
            decode_png(fr[1][C.RES_PNG_PATH]), cube_api._norm_u8(
                plane, CE.compute_global_stats(plane)).cpu().numpy()))
        sx, sy = cw // 2, 3 * ch // 5
        sp = counted("get_cube_spectrum",
                     lambda i: api.get_cube_spectrum(p_cube, sx, sy))
        launched("get_cube_spectrum", ())
        expect("get_cube_spectrum", same_bits(torch.tensor(
            sp[1][C.RES_SPECTRUM]), cube[:, sy, sx]))
        eager = counted("process_cube_cmd",
                        lambda i: api.process_cube_cmd(p_cube, out))
        launched("process_cube_cmd", ())
        gst = CE.compute_global_stats(cube)
        expect("process_cube_cmd", eager[1][C.RES_FRAME_COUNT] == 16 and
               eager[1]["center_spectrum"] == lazy[1]["center_spectrum"] and
               np.array_equal(decode_png(eager[1]["collapsed_median_path"]),
                              cube_api._norm_u8(CE.collapse_median(cube),
                                                gst).cpu().numpy()))
        sl = cube[:64]
        expect("global stats card vs CPU (64 channels)",
               CE.compute_global_stats(sl) == CE.compute_global_stats(
                   sl.cpu()))
        expect("median collapse card vs CPU (64 channels)", same_bits(
            CE.collapse_median(sl), CE.collapse_median(sl.cpu())))
        err["cube_global_stats"] = gst.__dict__
        for name, fn in (("compute_global_stats", CE.compute_global_stats),
                         ("collapse_mean", CE.collapse_mean),
                         ("collapse_median", CE.collapse_median)):
            stage_ms[f"{name}(cube)"] = cuda_ms(lambda: fn(cube), 2)
        del cube, sl, z, src, plane
        reset_caches()
        os.remove(p_cube)

        # -- tile pyramids: 4096^2 mono, and the RGB composite -----------
        tl = counted(f"generate_tiles({hw}^2,256)", lambda i: api.
                     generate_tiles(p_field, os.path.join(root, f"t{i}"),
                                    256))
        launched(f"generate_tiles({hw}^2,256)", ())
        levels = tl[1]["levels"]
        expect("generate_tiles levels", len(levels) == RT.compute_num_levels(
            hw, hw, 256) and sum(lv["cols"] * lv["rows"] for lv in levels)
            == sum(4 ** k for k in range(len(levels))), levels)
        st = compute_image_stats(scrub)

        def mono_level0(plane):
            stretched = apply_stf_f32(plane, auto_stf(st), st)
            lo, hi = RT._bounds(stretched).unbind()
            for _ in range(len(levels) - 1):
                stretched = RT.downsample_2x(stretched)
            return RT.quantize(stretched, lo, hi).cpu().numpy()
        lv0 = mono_level0(scrub)
        tile0 = decode_png(os.path.join(tl[1]["base_dir"], "0", "0_0.png"))
        expect("generate_tiles level 0 against the module calls",
               np.array_equal(tile0[:lv0.shape[0], :lv0.shape[1]], lv0))
        expect("generate_tiles level 0 card vs CPU",
               np.array_equal(lv0, mono_level0(scrub.cpu())))

        rgb_paths = [write(f"rgb_{k}", fits(frames16[k])[:rgb_hw, :rgb_hw])
                     for k in range(3)]
        comp = counted("compose_rgb_cmd(synth)", lambda i: api.
                       compose_rgb_cmd(out, r_path=rgb_paths[0],
                                       g_path=rgb_paths[1],
                                       b_path=rgb_paths[2]))
        launched("compose_rgb_cmd(synth)", ("coarse_box", "gather_crops"))
        expect("compose offsets", max(map(abs, comp[1]["offset_g"] +
                                          comp[1]["offset_b"])) < 0.1)
        tr = counted(f"generate_tiles_rgb({rgb_hw}^2,256)", lambda i: api.
                     generate_tiles_rgb(os.path.join(root, f"r{i}"), 256),
                     cold=lambda: None)
        launched(f"generate_tiles_rgb({rgb_hw}^2,256)", ())
        er, eg, eb = helpers.load_composite_rgb(dev)
        linked = helpers.compute_linked_stf(er.stats, eg.stats, eb.stats)
        n_lv = len(tr[1]["levels"])

        def rgb_level0(planes):
            out = []
            for p, e in zip(planes, (er, eg, eb)):
                for _ in range(n_lv - 1):
                    p = RT.downsample_2x(p)
                out.append(apply_stf_u8(p, linked, e.stats).cpu().numpy())
            return np.stack(out, -1)
        lv0 = rgb_level0([er.image, eg.image, eb.image])
        tile0 = decode_png(os.path.join(tr[1]["base_dir"], "0", "0_0.png"))
        expect("generate_tiles_rgb level 0 against the module calls",
               np.array_equal(tile0[:lv0.shape[0], :lv0.shape[1]], lv0))
        expect("generate_tiles_rgb level 0 card vs CPU", np.array_equal(
            lv0, rgb_level0([er.image.cpu(), eg.image.cpu(),
                             eb.image.cpu()])))
        GLOBAL_IMAGE_CACHE.clear()

        times = {"commands_ms": cmd_ms, "device_stages_ms": stage_ms,
                 "peak_device_gib": peak_gib,
                 "cube_file_s": t_cube_file,
                 "phase_s": time.perf_counter() - t_phase}
        log(f"[path] phase 4k launches: {json.dumps(launches)}")
        log(f"[path] phase 4k checks: {json.dumps(err)}")
        log(f"[time] {smi}: FFT/deconvolution/cube/tile/synth commands "
            f"(phase 4k {times['phase_s']:.1f} s with its files and "
            f"checks; RGB pyramid 3 x {rgb_hw}^2): " + json.dumps(times))
        return total, times
    finally:
        reset_caches()
        shutil.rmtree(root)


def stf_preview(img):
    """stats_core → auto-STF → u8 stretch of one plane: (stf [2], u8)."""
    import torch
    from astroburst_tpu_torch.imaging.stf import (apply_stf_traced,
                                                  auto_stf_traced)
    from astroburst_tpu_torch.ops.stats import stats_core
    mn, mx, _total, count, med, mad = stats_core(img, False)
    sigma = torch.clamp(mad * 1.4826, min=1e-30)
    shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
    return (torch.stack([shadow, midtone]),
            apply_stf_traced(img, mn, mx, shadow, midtone, as_u8=True))


def array_masters(bias, darks, flats):
    """The masters from the raw stacks (the array forms of
    create_master_*), as a CalibrationConfig."""
    from astroburst_tpu_torch.stacking import calibration as CAL
    mb = CAL.median_combine(bias)
    md = CAL.median_combine(darks - mb[None])
    mf = CAL._mean_normalize(CAL.median_combine(flats - mb[None] - md[None]))
    return CAL.CalibrationConfig(master_bias=mb, master_dark=md,
                                 master_flat=mf)


def calibrate(bias, darks, flats, lights):
    """Masters from the raw stacks, then every light calibrated."""
    from astroburst_tpu_torch.stacking import calibration as CAL
    cfg = array_masters(bias, darks, flats)
    return [CAL.calibrate_image(f, cfg) for f in lights]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")

    from astroburst_tpu_torch.alignment import affine as AF
    from astroburst_tpu_torch.alignment.coarse_kernel import (
        box_plan, coarse_downsample_stack, coarse_downsample_stack_plain)
    from astroburst_tpu_torch.alignment.vote_kernel import vote
    from astroburst_tpu_torch.analysis import star_detection as SD
    from astroburst_tpu_torch.analysis.tile_sort_kernel import (
        sort_tiles, sort_tiles_chunked)
    from astroburst_tpu_torch.analysis.window_kernel import window_stats
    from astroburst_tpu_torch.alignment.phase_correlation import (
        REFINE_CROP_SIZE, _refine_origin)
    from astroburst_tpu_torch.convert import stack_from_numpy
    from astroburst_tpu_torch.dtypes import (AlignmentMethod, DrizzleConfig,
                                             DrizzleKernel)
    from astroburst_tpu_torch.ops.crop_kernel import gather_crops
    from astroburst_tpu_torch.parallel.pipeline import align_stack_stretch
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import (cuda_device,
                                                     tf32_disabled)
    from astroburst_tpu_torch.stacking.clip import sigma_clip_core
    from astroburst_tpu_torch.stacking.combine import stack_images
    from astroburst_tpu_torch.stacking.drizzle import (
        _drizzle_kernel_exact, _frame_candidates_raw, _masked_candidates,
        _outer, drizzle_stack)
    from astroburst_tpu_torch.stacking.drizzle_kernel import (
        drizzle_finalize, drizzle_finalize_fused,
        drizzle_finalize_fused_plain, drizzle_finalize_plain)
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        _clip_plan, shift_clip_onepass, shift_clip_onepass_plain)
    from astroburst_tpu_torch.imaging.star_mask_kernel import paint_mask
    from astroburst_tpu_torch.stacking.drizzle import drizzle_exact_parity
    from astroburst_tpu_torch.stacking.drizzle_gather_kernel import (
        drizzle_gather_finalize)

    # ---- 1. device ---------------------------------------------------
    t_start = time.perf_counter()
    dev = cuda_device()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    nvcc_ver = subprocess.run([K.nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    log(f"[device] {kind} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvcc: {nvcc_ver.splitlines()[-1]}")
    log(f"[device] nvidia-smi name, power.limit: {smi}")
    if not tf32_disabled():
        raise AssertionError("TF32 is enabled")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    lib = K.library()
    log(f"[build] {lib.path.relative_to(K.BUILD_ROOT.parent.parent)}: "
        f"nvcc {lib.build_seconds:.2f} s, one process per source "
        f"(load {time.perf_counter() - t0:.2f} s)")
    rows = ptxas_summary(lib.build_log)
    for name, regs, smem, stack_b, sst, sld in rows:
        log(f"[build]   {name}: sm_90a, {regs} registers, {smem} B smem, "
            f"{stack_b} B stack, spills {sst}/{sld} B")
    built = {r[0].split("<")[0] for r in rows}
    want = {"shift_clip_kernel", "coarse_box_kernel", "gather_crops_kernel",
            "drizzle_finalize_kernel", "drizzle_finalize_shared_kernel",
            "drizzle_finalize_scratch_kernel", "shift_clip_shared_kernel",
            "shift_clip_scratch_kernel", "tile_sort_kernel",
            "tile_sort_chunked_kernel", "window_stats_kernel",
            "triangle_vote_kernel", "drizzle_gather_kernel",
            "drizzle_gather_shared_kernel", "drizzle_gather_scratch_kernel",
            "star_mask_kernel"}
    if not want <= built:
        raise AssertionError(f"kernels missing from the build: "
                             f"{want - built}")
    spills = [r[0] for r in rows if r[4] or r[5]]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    # the register instances of K3, K7/K8 and K9, and K2, K11, K12 and
    # K13, keep their values out of local memory
    framed = [r[0] for r in rows if r[3] and r[0].startswith((
        "shift_clip_kernel<", "drizzle_finalize_kernel<",
        "drizzle_gather_kernel<", "gather_crops_kernel",
        "window_stats_kernel", "triangle_vote_kernel",
        "star_mask_kernel"))]
    if framed:
        raise AssertionError(f"register instances with a stack frame: "
                             f"{framed}")

    # ---- 3. kernels vs plain at the main paths' shapes -----------------
    t0 = time.perf_counter()
    frames = make_frames(N_FRAMES, H, W)
    shifts = bench_shifts(N_FRAMES, H, W)
    for k in (1, N_FRAMES - 1):  # the replayed shifts are make_frames's
        resid = frames[k] - np.roll(frames[0], tuple(shifts[k]), (0, 1))
        if float(resid[64:-64, 64:-64].std()) > 4.0:
            raise AssertionError("bench_shifts no longer replays "
                                 "make_frames")
    stack = stack_from_numpy(frames, dev)
    del frames
    big_frames, big_shifts = wide_shift_frames(BIG_N, BIG_HW, BIG_SHIFT)
    log(f"[data] bench stack {tuple(stack.shape)}, {BIG_N} frames of "
        f"{BIG_HW}^2 (made in {time.perf_counter() - t0:.1f} s)")
    report = {}
    npix = N_FRAMES * H * W

    a = coarse_downsample_stack(stack, 512, with_stats=True)
    b = coarse_downsample_stack_plain(stack, 512, with_stats=True)
    torch.cuda.synchronize()
    by, bx, ds_r, ds_c = box_plan(H, W, 512)   # 12, 5 at the bench shape
    if a[0].shape != (N_FRAMES, ds_r, ds_c) or a[1:3] != (by, bx):
        raise AssertionError(f"K1 plan {a[0].shape} {a[1:3]}")
    if not torch.allclose(a[0], b[0], rtol=1e-5, atol=1e-6):
        raise AssertionError("K1 box means differ from the plain version")
    for x, y, what in zip(a[3:], b[3:], ("min", "max", "count")):
        if not torch.equal(x, y):
            raise AssertionError(f"K1 {what} differs")
    k1_err = float((a[0] - b[0]).abs().max())
    log(f"[K1] coarse_box {list(stack.shape)} -> {tuple(a[0].shape)}: "
        f"max|d|={k1_err:.3e}; min/max/count exact")
    region = stack[:, None, :ds_r * by, :ds_c * bx]
    k1_lib = torch.nn.functional.avg_pool2d(region, (by, bx))[:, 0]
    if not torch.allclose(k1_lib, a[0], rtol=1e-5, atol=1e-3):
        raise AssertionError("avg_pool2d is not the K1 box mean")
    report["coarse_box"] = {"max_abs_err": k1_err, "ms": cuda_ms(
        lambda: coarse_downsample_stack(stack, 512, with_stats=True), 20),
        "plain_ms": cuda_ms(lambda: coarse_downsample_stack_plain(
            stack, 512, with_stats=True), 5),
        "library_ms": cuda_ms(lambda: torch.nn.functional.avg_pool2d(
            region, (by, bx)), 20),
        "library": "torch.nn.functional.avg_pool2d (box means only)"}
    report["coarse_box"].update(zip(("bound_ms", "bound_by"), bound(
        4 * (npix + N_FRAMES * ds_r * ds_c), 3 * npix)))

    cy = torch.as_tensor(H // 2 + shifts[1:, 0], device=dev)
    cx = torch.as_tensor(W // 2 + shifts[1:, 1], device=dev)
    y0s, x0s = _refine_origin(cy, cx, H, W, REFINE_CROP_SIZE)
    report["gather_crops"] = check_crops(stack, y0s, x0s)

    rng = np.random.default_rng(5)
    offs = rng.uniform(-12, 12, (2, N_FRAMES)).astype(np.float32)
    offs[:, 0] = 0.0
    dys, dxs = (torch.as_tensor(o, device=dev) for o in offs)
    got = shift_clip_onepass(stack, dys, dxs)
    ref = shift_clip_onepass_plain(stack, dys, dxs)
    torch.cuda.synchronize()
    k3_err, k3_flips = check_flips(
        f"[K3] shift_clip {N_FRAMES}x{H}x{W} +-12", N_FRAMES, got[0],
        ref[0], got[1], ref[1])
    # bytes: the stack once, the image and the rejected map; operations:
    # the 4x4 Catmull-Rom taps (32) and their 8 weights (56) per
    # pixel-frame — the data-dependent clip is not counted
    report["shift_clip"] = {"max_abs_err": k3_err, "flips": k3_flips,
                            "ms": cuda_ms(lambda: shift_clip_onepass(
                                stack, dys, dxs), 10),
                            "plain_ms": cuda_ms(
                                lambda: shift_clip_onepass_plain(
                                    stack, dys, dxs), 3),
                            "library_ms": None}
    report["shift_clip"].update(zip(("bound_ms", "bound_by"), bound(
        4 * npix + 8 * H * W, 88 * npix)))
    zeros = torch.zeros(N_FRAMES, device=dev)
    got = shift_clip_onepass(stack, zeros, zeros)
    ref = sigma_clip_core(stack)
    torch.cuda.synchronize()
    e0, f0 = check_flips(f"[K3] shift_clip at zero offsets vs "
                         f"sigma_clip_core {N_FRAMES}x{H}x{W}", N_FRAMES,
                         got[0], ref[0], got[1], ref[1])
    report["shift_clip"].update({
        "max_abs_err_zero_offsets": e0, "flips_zero_offsets": f0,
        "ms_zero_offsets": cuda_ms(lambda: shift_clip_onepass(
            stack, zeros, zeros), 10),
        "plain_ms_zero_offsets": cuda_ms(lambda: sigma_clip_core(stack), 3)})
    big = stack_from_numpy(np.stack(big_frames), dev)
    boffs = rng.uniform(-BIG_SHIFT, BIG_SHIFT, (2, BIG_N)).astype(np.float32)
    bdys, bdxs = (torch.as_tensor(o, device=dev) for o in boffs)
    got = shift_clip_onepass(big, bdys, bdxs)
    ref = shift_clip_onepass_plain(big, bdys, bdxs)
    torch.cuda.synchronize()
    e24, f24 = check_flips(
        f"[K3] shift_clip {BIG_N}x{BIG_HW}x{BIG_HW} +-{BIG_SHIFT}", BIG_N,
        got[0], ref[0], got[1], ref[1])
    report["shift_clip"].update({
        "max_abs_err_24x2048": e24, "flips_24x2048": f24,
        "ms_24x2048": cuda_ms(lambda: shift_clip_onepass(big, bdys, bdxs),
                              10),
        "plain_ms_24x2048": cuda_ms(lambda: shift_clip_onepass_plain(
            big, bdys, bdxs), 3),
        "bound_ms_24x2048": bound(4 * BIG_N * BIG_HW ** 2 + 8 * BIG_HW ** 2,
                                  88 * BIG_N * BIG_HW ** 2)[0]})
    del big, got, ref

    # edge cases the bench frames do not reach: non-finite pixels, exact
    # zero offsets, 1 frame, the shared-memory instance of K3 (48 and 100
    # frames); K1 on NaN/inf with remainder rows and columns
    for n in (1, 48, 100):
        e = rng.normal(100, 5, (n, 300, 400)).astype(np.float32)
        e[rng.random(e.shape) < 0.01] = np.nan
        e[:, 7, 9] = np.nan
        e[: n // 2, 11, 13] = np.inf
        eoffs = rng.uniform(-30, 30, (2, n)).astype(np.float32)
        eoffs[:, 0] = 0.0
        eoffs[0, n // 3] = 0.0
        es = stack_from_numpy(e, dev)
        edys, edxs = (torch.as_tensor(o, device=dev) for o in eoffs)
        got = shift_clip_onepass(es, edys, edxs, 2.5, 3.0, 5)
        ref = shift_clip_onepass_plain(es, edys, edxs, 2.5, 3.0, 5)
        torch.cuda.synchronize()
        check_flips(f"[K3] shift_clip {n}x300x400 +-30, NaN/inf pixels, "
                    f"{_clip_plan(n, 300, 400).instance} instance", n, got[0],
                    ref[0], got[1], ref[1])
    report["shift_clip"].update(check_shift_clip_instances(rng, dev))
    e = rng.normal(100, 10, (3, 1030, 1100)).astype(np.float32)
    e[0, 5, 7] = np.nan
    e[1, 1029, 1099] = -5.0
    e[2, 100:110, 50:60] = np.inf
    es = stack_from_numpy(e, dev)
    a = coarse_downsample_stack(es, 512, with_stats=True)
    b = coarse_downsample_stack_plain(es, 512, with_stats=True)
    torch.cuda.synchronize()
    if not (torch.equal(torch.isfinite(a[0]), torch.isfinite(b[0]))
            and torch.allclose(a[0], b[0], rtol=1e-5, atol=1e-6,
                               equal_nan=True)
            and all(torch.equal(x, y) for x, y in zip(a[3:], b[3:]))):
        raise AssertionError("K1 differs from plain on NaN/inf frames")
    log(f"[K1] coarse_box [3, 1030, 1100] with NaN/inf: non-finite boxes "
        f"{int((~torch.isfinite(a[0])).sum())}, stats exact")
    del es, got, ref

    # K7 / K8 at one band of the drizzle bench (bench_ops.py:366-397:
    # 10 x 4096^2 f32, offsets in +-2, scale 2, pixfrac 0.7, square,
    # 5 iterations → 2 x 2 taps, 40 candidates x 1024 x 8192)
    t0 = time.perf_counter()
    drng = np.random.default_rng(DRZ_SEED)
    gen = torch.Generator(device=dev).manual_seed(DRZ_SEED)
    dstack = torch.randn((DRZ_N, DRZ_HW, DRZ_HW), generator=gen,
                         device=dev) * 8.0 + 100.0
    dd_ys = torch.as_tensor(drng.uniform(-2, 2, DRZ_N), dtype=torch.float32,
                            device=dev)
    dd_xs = torch.as_tensor(drng.uniform(-2, 2, DRZ_N), dtype=torch.float32,
                            device=dev)
    out_hw = 2 * DRZ_HW
    r0 = 3 * DRZ_BAND   # the fourth band: r0/scale = 1536 in f32
    cand, wys, wxs, taps = _frame_candidates_raw(
        dstack, dd_ys - r0 / 2.0, dd_xs, 2.0, 0.7, DrizzleKernel.SQUARE,
        DRZ_BAND, out_hw)
    wys_t = wys.T.contiguous()
    m = cand.shape[0]
    cap = max(2 * DRZ_N, 4)
    fin_args = (DRZ_N, taps, taps, cap, 3.0, 3.0, 5)
    got = drizzle_finalize_fused(cand, wys_t, wxs, *fin_args)
    ref = drizzle_finalize_fused_plain(cand, wys_t, wxs, *fin_args)
    torch.cuda.synchronize()
    log(f"[data] drizzle bench stack {tuple(dstack.shape)}, band "
        f"{tuple(cand.shape)} (made in {time.perf_counter() - t0:.1f} s)")
    report["drizzle_finalize_fused"] = check_finalize(
        f"[K7] drizzle_finalize_fused {tuple(cand.shape)}", got, ref)
    band_px = DRZ_BAND * out_hw
    report["drizzle_finalize_fused"].update({
        "ms": cuda_ms(lambda: drizzle_finalize_fused(cand, wys_t, wxs,
                                                     *fin_args), 10),
        "plain_ms": cuda_ms(lambda: drizzle_finalize_fused_plain(
            cand, wys_t, wxs, *fin_args), 2),
        "library_ms": None,
        "shape": list(cand.shape)})
    # bytes and operations of the pushes each pixel walks
    report["drizzle_finalize_fused"].update(zip(("bound_ms", "bound_by"),
                                                bound(*finalize_work(
        cand, wys, wxs, DRZ_N, taps, cap))))
    # K7 at drizzle_stack's own band of 64 rows (40 x 64 x 8192)
    cand64, wys64, wxs64, _ = _frame_candidates_raw(
        dstack, dd_ys - r0 / 2.0, dd_xs, 2.0, 0.7, DrizzleKernel.SQUARE,
        DRZ_BAND64, out_hw)
    wys64_t = wys64.T.contiguous()
    check_finalize(f"[K7] drizzle_finalize_fused {tuple(cand64.shape)}",
                   drizzle_finalize_fused(cand64, wys64_t, wxs64, *fin_args),
                   drizzle_finalize_fused_plain(cand64, wys64_t, wxs64,
                                                *fin_args))
    report["drizzle_finalize_fused"].update({
        "ms_band64": cuda_ms(lambda: drizzle_finalize_fused(
            cand64, wys64_t, wxs64, *fin_args), 50),
        "plain_ms_band64": cuda_ms(lambda: drizzle_finalize_fused_plain(
            cand64, wys64_t, wxs64, *fin_args), 3),
        "bound_ms_band64": bound(*finalize_work(
            cand64, wys64, wxs64, DRZ_N, taps, cap))[0]})
    del cand64
    cand_v, cand_w = _masked_candidates(cand, _outer(
        wys.reshape(DRZ_N, taps, DRZ_BAND), wxs.reshape(DRZ_N, taps, out_hw)))
    got = drizzle_finalize(cand_v, cand_w, cap, 3.0, 3.0, 5)
    ref = drizzle_finalize_plain(cand_v, cand_w, cap, 3.0, 3.0, 5)
    torch.cuda.synchronize()
    report["drizzle_finalize"] = check_finalize(
        f"[K8] drizzle_finalize {tuple(cand_v.shape)}", got, ref)
    k7_ref = drizzle_finalize_fused_plain(cand, wys_t, wxs, *fin_args)
    if not all(torch.equal(x, y) for x, y in zip(ref, k7_ref)):
        raise AssertionError("K8 and K7 plain versions differ on the "
                             "same candidates")
    report["drizzle_finalize"].update({
        "ms": cuda_ms(lambda: drizzle_finalize(cand_v, cand_w, cap, 3.0,
                                               3.0, 5), 10),
        "plain_ms": cuda_ms(lambda: drizzle_finalize_plain(
            cand_v, cand_w, cap, 3.0, 3.0, 5), 2),
        "library_ms": None,
        "shape": list(cand_v.shape)})
    report["drizzle_finalize"].update(zip(("bound_ms", "bound_by"), bound(
        8 * m * band_px + 12 * band_px, m * band_px)))
    del cand, cand_v, cand_w, got, ref, k7_ref

    # NaN/inf pixels: min(cap, m) = 2n at 2 x 2 taps → 20 (registers),
    # 60, 120, 256 (shared memory) and 300 (past 128 frames: the global
    # scratch); K8 gets the raw non-finite values at weight 0
    for n in (10, 30, 60, 128, 150):
        e = rng.normal(100, 8, (n, 40, 72)).astype(np.float32)
        e[rng.random(e.shape) < 0.02] = np.nan
        e[: n // 2, 5, 9] = np.inf
        e[1, 20, 30] = -np.inf
        e[2, 10, 10] = 5000.0
        es = stack_from_numpy(e, dev)
        ed = [torch.as_tensor(rng.uniform(-2, 2, n), dtype=torch.float32,
                              device=dev) for _ in range(2)]
        cand, wys, wxs, taps = _frame_candidates_raw(
            es, ed[0], ed[1], 2.0, 1.0, DrizzleKernel.SQUARE, 80, 144)
        args = (n, taps, taps, max(2 * n, 4), 2.5, 3.0, 5)
        wys_t = wys.T.contiguous()
        check_finalize(f"[K7] {tuple(cand.shape)}, NaN/inf pixels",
                       drizzle_finalize_fused(cand, wys_t, wxs, *args),
                       drizzle_finalize_fused_plain(cand, wys_t, wxs, *args))
        _, cand_w = _masked_candidates(cand, _outer(
            wys.reshape(n, taps, 80), wxs.reshape(n, taps, 144)))
        check_finalize(f"[K8] {tuple(cand.shape)}, NaN/inf at weight 0",
                       drizzle_finalize(cand, cand_w, *args[3:]),
                       drizzle_finalize_plain(cand, cand_w, *args[3:]))
    # the global-scratch instance (150 frames, cap 300), timed
    report["drizzle_finalize_fused"].update({
        "shape_150_frames": list(cand.shape),
        "ms_150_frames": cuda_ms(lambda: drizzle_finalize_fused(
            cand, wys_t, wxs, *args), 10),
        "plain_ms_150_frames": cuda_ms(lambda: drizzle_finalize_fused_plain(
            cand, wys_t, wxs, *args), 3)})
    del es, cand, cand_w
    # every instance on stacks with ties and +-0 (FINALIZE_INSTANCES)
    for n, inst in FINALIZE_INSTANCES:
        es = torch.as_tensor(tie_stack(n, rng), device=dev)
        ed = [torch.as_tensor(rng.uniform(-2, 2, n), dtype=torch.float32,
                              device=dev) for _ in range(2)]
        cand, wys, wxs, taps = _frame_candidates_raw(
            es, ed[0], ed[1], 2.0, 1.0, DrizzleKernel.SQUARE, 80, 144)
        args = (n, taps, taps, max(2 * n, 4), 2.5, 3.0, 5)
        wys_t = wys.T.contiguous()
        check_finalize(f"[K7] {tuple(cand.shape)}, depth {2 * n}, {inst}; "
                       f"ties, +-0, NaN/inf",
                       drizzle_finalize_fused(cand, wys_t, wxs, *args),
                       drizzle_finalize_fused_plain(cand, wys_t, wxs, *args))
        _, cand_w = _masked_candidates(cand, _outer(
            wys.reshape(n, taps, 80), wxs.reshape(n, taps, 144)))
        check_finalize(f"[K8] {tuple(cand.shape)}, depth {2 * n}, {inst}; "
                       f"ties, +-0, NaN/inf at weight 0",
                       drizzle_finalize(cand, cand_w, *args[3:]),
                       drizzle_finalize_plain(cand, cand_w, *args[3:]))
    del es, cand, cand_w

    # K9 at the drizzle bench: the full 8192^2 output, no candidates
    report["drizzle_gather_finalize"] = check_drizzle_gather(
        dstack, dd_ys, dd_xs, rng)

    # K10: the tile sort, bit-equal, at the detection path's steps
    t0 = time.perf_counter()
    (field, f_ys, f_xs, f_amps, dead), (field5, g5_ys, g5_xs, g5_amps,
                                        dead5) = detection_fields(dev)
    log(f"[data] star fields {DET_HW}^2 x {DET_STARS} stars and {H}x{W} x "
        f"200 stars (made in {time.perf_counter() - t0:.1f} s)")
    report["sort_tiles"], report["sort_tiles_chunked"] = check_tile_sort(
        field, field5, rng)

    # K11: window statistics at the peaks of both detection fields and
    # on adversarial windows
    report["window_stats"] = check_window_stats(field, field5)

    # K13: the star mask of the masked stretch's own records, on the
    # field in [0, 1) (see masked_stretch_path)
    ms_field = field / MS_SCALE
    report["paint_mask"] = check_star_mask(ms_field, MS_PEAKS)

    # K12: the vote at the full triangle count of 60 stars, and on
    # adversarial lists
    report["vote"] = check_vote(dev)

    # ---- 4a. main paths of the earlier slice, through the kernels ------
    counters = {"shift_clip": shift_clip_onepass,
                "coarse_box": coarse_downsample_stack,
                "gather_crops": gather_crops,
                "drizzle_finalize_fused": drizzle_finalize_fused,
                "drizzle_finalize": drizzle_finalize,
                "sort_tiles": sort_tiles,
                "sort_tiles_chunked": sort_tiles_chunked,
                "window_stats": window_stats,
                "vote": vote,
                "paint_mask": paint_mask,
                "drizzle_gather_finalize": drizzle_gather_finalize}
    big_list = [torch.as_tensor(f, device=dev) for f in big_frames]
    del big_frames
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = align_stack_stretch(stack)
    res = stack_images(big_list)
    torch.cuda.synchronize()
    launches_stack = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in align_stack_stretch + stack_images: "
        f"{launches_stack}")
    for name in ("shift_clip", "coarse_box", "gather_crops"):
        if launches_stack[name] < 1:
            raise AssertionError(f"{name} never ran: {launches_stack}")

    comb = out["combined"]
    if comb.shape != (H, W) or not bool(torch.isfinite(comb).all()):
        raise AssertionError("combined plane is not finite [H, W]")
    if out["preview"].dtype != torch.uint8 or out["preview"].shape != (H, W):
        raise AssertionError("preview is not u8 [H, W]")
    off = out["offsets"].cpu().numpy()
    off_err = float(np.abs(off - shifts).max())
    log(f"[path] align_stack_stretch offsets vs generator: max|d|="
        f"{off_err:.4f} px; rejected {int(out['rejected'])}; stf "
        f"{out['stf'].tolist()}")
    if off_err > 0.1:
        raise AssertionError(f"offsets off by {off_err} px: {off.tolist()}")
    if [list(o) for o in res.offsets] != big_shifts.tolist():
        raise AssertionError(f"stack_images offsets {res.offsets} != "
                             f"{big_shifts.tolist()}")
    if not bool(torch.isfinite(res.image).all()):
        raise AssertionError("stack_images image is not finite")
    log(f"[path] stack_images {BIG_N}x{BIG_HW}^2: offsets match the "
        f"generator (+-{BIG_SHIFT}); rejected {res.rejected_pixels}")

    # the same entry points through the plain versions on the card
    out_p = align_stack_stretch(stack, plain=True)
    res_p = stack_images(big_list, plain=True)
    torch.cuda.synchronize()
    d_off = float((out["offsets"] - out_p["offsets"]).abs().max())
    d_stf = float((out["stf"] - out_p["stf"]).abs().max())
    log(f"[path] kernel vs plain: offsets max|d|={d_off:.2e}, stf "
        f"max|d|={d_stf:.2e}")
    if d_off > 0.05 or d_stf > 1e-4:
        raise AssertionError("kernel path and plain path disagree")
    check_flips("[path] align_stack_stretch combined", N_FRAMES, comb,
                out_p["combined"], out["rejected"], out_p["rejected"])
    if res.offsets != res_p.offsets:
        raise AssertionError("stack_images offsets differ from plain")
    check_flips("[path] stack_images image", BIG_N, res.image, res_p.image,
                res.rejected_pixels, res_p.rejected_pixels)
    del out_p, res_p

    mpx = npix / 1e6
    torch.cuda.reset_peak_memory_stats()
    ms_k = cuda_ms(lambda: align_stack_stretch(stack), 10)
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_p = cuda_ms(lambda: align_stack_stretch(stack, plain=True), 3)
    peak_p = torch.cuda.max_memory_allocated()
    ms_s = cuda_ms(lambda: stack_images(big_list), 3)
    ms_sp = cuda_ms(lambda: stack_images(big_list, plain=True), 2)
    log(f"[time] {smi}: align_stack_stretch {N_FRAMES}x{H}x{W} kernels "
        f"{ms_k:.3f} ms ({mpx / ms_k * 1e3:.1f} Mpx/s, peak "
        f"{peak_k / 2**30:.2f} GiB) | plain {ms_p:.3f} ms "
        f"({mpx / ms_p * 1e3:.1f} Mpx/s, peak {peak_p / 2**30:.2f} GiB)")
    log(f"[time] {smi}: stack_images {BIG_N}x{BIG_HW}^2 kernels {ms_s:.3f} ms | "
        f"plain {ms_sp:.3f} ms (host offsets fetch included)")
    del big_list, out, res, comb

    # stack_images past 128 frames: K3's scratch instance, counted alone
    t0 = time.perf_counter()
    many_frames, many_shifts = wide_shift_frames(MANY_N, MANY_HW, MANY_SHIFT,
                                                 seed=12)
    many_list = [torch.as_tensor(f, device=dev) for f in many_frames]
    del many_frames
    torch.cuda.synchronize()
    log(f"[data] {MANY_N} frames of {MANY_HW}^2, shifts up to "
        f"+-{MANY_SHIFT} (made in {time.perf_counter() - t0:.1f} s)")
    for fn in counters.values():
        fn.launches = 0
    res = stack_images(many_list)
    torch.cuda.synchronize()
    launches_many = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in stack_images {MANY_N}x{MANY_HW}^2 "
        f"(K3 {_clip_plan(MANY_N, MANY_HW, MANY_HW)}): {launches_many}")
    for name in ("shift_clip", "coarse_box", "gather_crops"):
        if launches_many[name] < 1:
            raise AssertionError(f"{name} never ran: {launches_many}")
    if [list(o) for o in res.offsets] != many_shifts.tolist():
        raise AssertionError(f"stack_images {MANY_N} frames: offsets "
                             f"{res.offsets} != {many_shifts.tolist()}")
    if res.image.shape != (MANY_HW, MANY_HW) or \
            not bool(torch.isfinite(res.image).all()):
        raise AssertionError(f"stack_images {MANY_N} frames: image is not "
                             f"a finite plane")
    res_p = stack_images(many_list, plain=True)
    torch.cuda.synchronize()
    if res.offsets != res_p.offsets:
        raise AssertionError("stack_images offsets differ from plain")
    check_flips(f"[path] stack_images {MANY_N}x{MANY_HW}^2 image", MANY_N,
                res.image, res_p.image, res.rejected_pixels,
                res_p.rejected_pixels)
    log(f"[path] stack_images {MANY_N}x{MANY_HW}^2: offsets match the "
        f"generator (+-{MANY_SHIFT}); rejected {res.rejected_pixels}")
    del res, res_p
    ms_m = cuda_ms(lambda: stack_images(many_list), 2)
    ms_mp = cuda_ms(lambda: stack_images(many_list, plain=True), 1)
    log(f"[time] {smi}: stack_images {MANY_N}x{MANY_HW}^2 kernels "
        f"{ms_m:.3f} ms | plain {ms_mp:.3f} ms (host offsets fetch "
        f"included)")

    # ---- 4f. the stack command: FITS in, stacked FITS + preview out ----
    launches_cmd, _ = stack_command_path(stack, shifts, many_list,
                                         many_shifts, counters, smi)
    bench_frame = stack[0].clone()      # for phase 4g
    del stack, many_list

    # ---- 4b. main path of this slice: calibrate → drizzle → stretch ----
    t0 = time.perf_counter()
    bias, darks, flats, lights, dith = calibration_scene(
        DRZ_N, DRZ_HW, DRZ_SEED + 1, dev)
    torch.cuda.synchronize()
    log(f"[data] calibration scene: {bias.shape[0]} bias, {darks.shape[0]} "
        f"darks, {flats.shape[0]} flats, {lights.shape[0]} lights of "
        f"{DRZ_HW}^2, dithers in +-2 px (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    for fn in counters.values():
        fn.launches = 0
    calibrated = calibrate(bias, darks, flats, lights)
    dres = drizzle_stack(calibrated, DrizzleConfig())
    dstf, dprev = stf_preview(dres.image)
    torch.cuda.synchronize()
    launches_drizzle = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in calibrate → drizzle_stack → stretch: "
        f"{launches_drizzle}")
    for name in ("coarse_box", "gather_crops", "drizzle_finalize_fused"):
        if launches_drizzle[name] < 1:
            raise AssertionError(f"{name} never ran: {launches_drizzle}")

    if dres.output_dims != (out_hw, out_hw) or \
            dres.image.shape != (out_hw, out_hw):
        raise AssertionError(f"drizzle output {dres.output_dims}")
    if not bool(torch.isfinite(dres.image).all()) or \
            not bool(torch.isfinite(dres.weight_map).all()):
        raise AssertionError("drizzle image or weights not finite")
    if dprev.dtype != torch.uint8 or dprev.shape != (out_hw, out_hw):
        raise AssertionError("drizzle preview is not u8")
    doff = np.asarray(dres.offsets)[:, ::-1]   # (dx, dy) → (dy, dx)
    doff_err = float(np.abs(doff - dith).max())
    log(f"[path] drizzle_stack offsets vs generator dithers: max|d|="
        f"{doff_err:.4f} px; rejected {dres.rejected_pixels}; stf "
        f"{dstf.tolist()}; weight map mean "
        f"{float(dres.weight_map.mean()):.4f}")
    if doff_err > 0.15:
        raise AssertionError(f"drizzle offsets off by {doff_err} px: "
                             f"{doff.tolist()} vs {dith.tolist()}")

    dres_p = drizzle_stack(calibrated, DrizzleConfig(), plain=True)
    dstf_p, _ = stf_preview(dres_p.image)
    torch.cuda.synchronize()
    d_off = float(np.abs(np.asarray(dres.offsets)
                         - np.asarray(dres_p.offsets)).max())
    d_stf = float((dstf - dstf_p).abs().max())
    d_img = float((dres.image - dres_p.image).abs().max())
    log(f"[path] drizzle kernel vs plain: offsets max|d|={d_off:.2e}, stf "
        f"max|d|={d_stf:.2e}, image max|d|={d_img:.3e}, rejected "
        f"{dres.rejected_pixels} vs {dres_p.rejected_pixels}")
    if d_off > 0.05 or d_stf > 1e-4:
        raise AssertionError("drizzle kernel path and plain path disagree")
    if not (torch.equal(dres.image, dres_p.image)
            and torch.equal(dres.weight_map, dres_p.weight_map)
            and dres.rejected_pixels == dres_p.rejected_pixels):
        raise AssertionError("drizzle image, weights or rejected count "
                             "not bit-equal to the plain path")
    del dres_p

    d_ys_t = torch.tensor([-o[1] for o in dres.offsets], device=dev)
    d_xs_t = torch.tensor([-o[0] for o in dres.offsets], device=dev)
    cal_stack = torch.stack(calibrated)
    exact_args = (cal_stack, d_ys_t, d_xs_t, 2.0, 0.7, DrizzleKernel.SQUARE,
                  out_hw, out_hw, 3.0, 3.0, 5)
    torch.cuda.reset_peak_memory_stats()
    ms_d = cuda_ms(lambda: drizzle_stack(calibrated, DrizzleConfig()), 2)
    peak_d = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_dp = cuda_ms(lambda: drizzle_stack(calibrated, DrizzleConfig(),
                                          plain=True), 1)
    peak_dp = torch.cuda.max_memory_allocated()
    ms_full = cuda_ms(lambda: stf_preview(drizzle_stack(
        calibrate(bias, darks, flats, lights), DrizzleConfig()).image), 1)
    torch.cuda.reset_peak_memory_stats()
    ms_b = cuda_ms(lambda: _drizzle_kernel_exact(
        *exact_args, band_rows=DRZ_BAND), 2)
    peak_b = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_bp = cuda_ms(lambda: _drizzle_kernel_exact(
        *exact_args, band_rows=DRZ_BAND, plain=True), 1)
    peak_bp = torch.cuda.max_memory_allocated()
    log(f"[time] {smi}: drizzle_stack {DRZ_N}x{DRZ_HW}^2 -> {out_hw}^2 "
        f"(band 64, offsets fetch included) kernels {ms_d:.3f} ms (peak "
        f"{peak_d / 2**30:.2f} GiB) | plain {ms_dp:.3f} ms (peak "
        f"{peak_dp / 2**30:.2f} GiB)")
    log(f"[time] {smi}: _drizzle_kernel_exact band {DRZ_BAND} kernels "
        f"{ms_b:.3f} ms (peak {peak_b / 2**30:.2f} GiB) | plain "
        f"{ms_bp:.3f} ms (peak {peak_bp / 2**30:.2f} GiB)")
    log(f"[time] {smi}: calibrate (16+16+16 masters, {DRZ_N} lights) → "
        f"drizzle_stack → stats/STF/u8: {ms_full:.3f} ms")

    # ---- 4h. calibrate → pipeline / drizzle → export, from files -------
    launches_export, _ = calibrate_export_path(
        bias, darks, flats, lights, calibrated, dres, bench_frame, counters,
        smi)
    del bias, darks, flats, lights, calibrated, dres

    # ---- 4e. the parity drizzle (K9): calibrated lights, drizzle bench ---
    bench_args = (dstack, dd_ys, dd_xs, 2.0, 0.7, DrizzleKernel.SQUARE,
                  out_hw, out_hw, 3.0, 3.0, 5)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    par_cal = drizzle_exact_parity(*exact_args)
    par_bench = drizzle_exact_parity(*bench_args)
    torch.cuda.synchronize()
    launches_parity = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in drizzle_exact_parity (calibrated "
        f"lights, drizzle bench): {launches_parity}")
    if launches_parity["drizzle_gather_finalize"] < 2:
        raise AssertionError(f"drizzle_gather_finalize did not run on "
                             f"both stacks: {launches_parity}")
    parity_err = {}
    for tag, got, a in (("calibrated", par_cal, exact_args),
                        ("bench", par_bench, bench_args)):
        want = _drizzle_kernel_exact(*a, band_rows=out_hw)   # K7, one band
        parity_err[tag] = check_parity_drizzle(
            f"[path] drizzle_exact_parity {tag} vs one-band "
            f"_drizzle_kernel_exact", got, want)
        if not bool(torch.isfinite(got[0]).all()):
            raise AssertionError(f"parity drizzle {tag}: image not finite")
    del par_cal, par_bench, want
    torch.cuda.reset_peak_memory_stats()
    ms_par = cuda_ms(lambda: drizzle_exact_parity(*exact_args), 5)
    peak_par = torch.cuda.max_memory_allocated()
    ms_par_p = cuda_ms(lambda: drizzle_exact_parity(*exact_args, plain=True),
                       1)
    ms_par_b = cuda_ms(lambda: drizzle_exact_parity(*bench_args), 5)
    torch.cuda.reset_peak_memory_stats()
    ms_one = cuda_ms(lambda: _drizzle_kernel_exact(*exact_args,
                                                   band_rows=out_hw), 1)
    peak_one = torch.cuda.max_memory_allocated()
    log(f"[time] {smi}: drizzle_exact_parity {DRZ_N}x{DRZ_HW}^2 -> "
        f"{out_hw}^2 (plan and its offsets fetch included) calibrated "
        f"lights {ms_par:.3f} ms (peak {peak_par / 2**30:.2f} GiB), bench "
        f"stack {ms_par_b:.3f} ms | plain {ms_par_p:.3f} ms | beside "
        f"drizzle_stack band 64 {ms_d:.3f} ms, _drizzle_kernel_exact band "
        f"{DRZ_BAND} {ms_b:.3f} ms and one band {ms_one:.3f} ms (peak "
        f"{peak_one / 2**30:.2f} GiB)")
    times_parity = {"drizzle_exact_parity_calibrated": (ms_par, ms_par_p),
                    "drizzle_exact_parity_bench": (ms_par_b, None),
                    "drizzle_stack_band64": (ms_d, ms_dp),
                    "drizzle_kernel_exact_band1024": (ms_b, ms_bp),
                    "drizzle_kernel_exact_one_band": (ms_one, None)}
    del cal_stack, dstack, exact_args, bench_args

    # ---- 4c. star detection → affine alignment → warp ----------------
    t0 = time.perf_counter()
    a5_ref, a5_tgt = affine_scene(H, W, AFF_STARS_5K, 8, dev)
    a4_ref, a4_tgt = affine_scene(DET_HW, DET_HW, AFF_STARS_4K, 24, dev)
    drng = np.random.default_rng(25)
    a_dith = drng.uniform(-2.0, 2.0, (DRA_N, 2))
    a_dith[0] = 0.0
    d_ys_g = drng.uniform(10, DRA_HW - 10, 300)
    d_xs_g = drng.uniform(10, DRA_HW - 10, 300)
    d_amps = drng.uniform(300.0, 3000.0, 300)
    gen = torch.Generator(device=dev).manual_seed(25)
    a_frames = [100.0 + render_stars(DRA_HW, DRA_HW, d_ys_g, d_xs_g, d_amps,
                                     dy, dx, 1.5, dev)
                + 3.0 * torch.randn((DRA_HW, DRA_HW), generator=gen,
                                    device=dev) for dy, dx in a_dith]
    torch.cuda.synchronize()
    log(f"[data] affine pairs {H}x{W} x {AFF_STARS_5K} stars and "
        f"{DET_HW}^2 x {AFF_STARS_4K} stars, {DRA_N} dithered {DRA_HW}^2 "
        f"frames (made in {time.perf_counter() - t0:.1f} s)")
    drz_affine = DrizzleConfig(alignment_method=AlignmentMethod.AFFINE)

    def affine_path(plain=False):
        out = {"det4k": SD.detect_stars(field, plain=plain),
               "det5k": SD.detect_stars(field5, plain=plain)}
        for tag, ref_, tgt_ in (("5k", a5_ref, a5_tgt),
                                ("4k", a4_ref, a4_tgt)):
            res = AF.align_channel_affine(ref_, tgt_, plain=plain)
            out[f"aff{tag}"] = res
            out[f"warp{tag}"] = AF.warp_image(tgt_, res.transform,
                                              *ref_.shape)
        out["drizzle"] = drizzle_stack(a_frames, drz_affine, plain=plain)
        return out

    for fn in counters.values():
        fn.launches = 0
    ap = affine_path()
    torch.cuda.synchronize()
    launches_affine = {name: fn.launches for name, fn in counters.items()}
    log(f"[path] kernel launches in detect_stars + align_channel_affine + "
        f"warp_image + drizzle_stack(AFFINE): {launches_affine}")
    for name in ("sort_tiles", "window_stats", "vote"):
        if launches_affine[name] < 1:
            raise AssertionError(f"{name} never ran: {launches_affine}")

    det_err = {
        "4k": check_positions(
            f"[path] detect_stars {DET_HW}^2", ap["det4k"], f_ys, f_xs,
            isolated_bright(f_ys, f_xs, f_amps, DET_HW, DET_HW, 2700.0,
                            dead=dead)),
        "5k": check_positions(
            f"[path] detect_stars {H}x{W}", ap["det5k"], g5_ys, g5_xs,
            isolated_bright(g5_ys, g5_xs, g5_amps, H, W, 1000.0,
                            dead=dead5))}
    scenes = {"5k": a5_ref, "4k": a4_ref}
    for tag in ("5k", "4k"):
        res = ap[f"aff{tag}"]
        rot = res.transform.rotation_deg()
        log(f"[path] align_channel_affine {tag}: {res.method}, "
            f"{res.matched_stars} matched, {res.inliers} inliers, residual "
            f"{res.residual_px:.4f} px, rotation {rot:.4f} deg, transform "
            f"{[round(v, 5) for v in res.transform.as_tuple()]}")
        if res.method not in ("affine", "rigid") or \
                abs(abs(rot) - 0.4) > 0.1:
            raise AssertionError(f"affine {tag}: {res}")
        warped = ap[f"warp{tag}"]
        if warped.shape != scenes[tag].shape or \
                not bool(torch.isfinite(warped).all()):
            raise AssertionError(f"warp {tag}: not a finite plane of the "
                                 f"reference's shape")
    adoff = np.asarray(ap["drizzle"].offsets)[:, ::-1]
    adoff_err = float(np.abs(adoff - a_dith).max())
    log(f"[path] drizzle_stack(AFFINE) {DRA_N}x{DRA_HW}^2 offsets vs "
        f"dithers: max|d|={adoff_err:.4f} px")
    if adoff_err > 0.15 or not bool(torch.isfinite(
            ap["drizzle"].image).all()):
        raise AssertionError(f"drizzle AFFINE offsets off by {adoff_err}")

    # the same entry points through the plain versions on the card
    pp = affine_path(plain=True)
    torch.cuda.synchronize()
    for tag in ("det4k", "det5k"):
        # the same stars; their brightest-first order may swap where two
        # fluxes agree to f32 rounding, so each is matched to its nearest
        a = np.array([(s.y, s.x, s.flux) for s in ap[tag].stars])
        b = np.array([(s.y, s.x, s.flux) for s in pp[tag].stars])
        if len(a) != len(b):
            raise AssertionError(f"{tag}: {len(a)} stars through the "
                                 f"kernels, {len(b)} plain")
        d2 = ((a[:, None, :2] - b[None, :, :2]) ** 2).sum(axis=2)
        near = d2.argmin(axis=1)
        d_pos = float(np.sqrt(d2.min(axis=1)).max())
        d_flux = float((np.abs(a[:, 2] - b[near, 2]) / b[near, 2]).max())
        log(f"  [path] {tag} kernel vs plain: {len(a)} stars, positions "
            f"max|d| {d_pos:.2e} px, flux max rel {d_flux:.2e}")
        if len(set(near.tolist())) != len(a) or d_pos > 1e-3 or \
                d_flux > 1e-4:
            raise AssertionError(f"{tag}: kernel and plain detections "
                                 f"differ")
    d_aff = {}
    for tag in ("aff5k", "aff4k"):
        a, b = ap[tag], pp[tag]
        d_aff[tag] = float(np.abs(np.subtract(a.transform.as_tuple(),
                                              b.transform.as_tuple())).max())
        if (a.method, a.inliers, a.matched_stars) != \
                (b.method, b.inliers, b.matched_stars) or d_aff[tag] > 1e-3:
            raise AssertionError(f"{tag}: kernel {a} vs plain {b}")
    d_doff = float(np.abs(np.asarray(ap["drizzle"].offsets)
                          - np.asarray(pp["drizzle"].offsets)).max())
    log(f"[path] affine kernel vs plain: same stars, methods and inliers; "
        f"transform max|d| {d_aff}, drizzle offsets max|d| {d_doff:.2e}")
    if d_doff > 1e-3:
        raise AssertionError("drizzle AFFINE offsets differ from plain")
    del pp

    times_c = {}
    for name, fn, reps in (
            ("detect_stars_4096", lambda p: SD.detect_stars(field, plain=p),
             5),
            ("detect_stars_5655x2206",
             lambda p: SD.detect_stars(field5, plain=p), 5),
            ("align_channel_affine+warp_5655x2206",
             lambda p: AF.warp_image(a5_tgt, AF.align_channel_affine(
                 a5_ref, a5_tgt, plain=p).transform, H, W), 3),
            ("align_channel_affine+warp_4096",
             lambda p: AF.warp_image(a4_tgt, AF.align_channel_affine(
                 a4_ref, a4_tgt, plain=p).transform, DET_HW, DET_HW), 3),
            ("drizzle_stack_affine_4x1024",
             lambda p: drizzle_stack(a_frames, drz_affine, plain=p), 2)):
        times_c[name] = (cuda_ms(lambda: fn(False), reps),
                         cuda_ms(lambda: fn(True), max(1, reps - 2)))
        log(f"[time] {smi}: {name} kernels {times_c[name][0]:.3f} ms | "
            f"plain {times_c[name][1]:.3f} ms (host fetches included)")

    # ---- 4d. star mask → masked stretch on the 4096^2 field ----------
    launches_mask, times_mask, d_ms_img, d_ms_cov = masked_stretch_path(
        ms_field, counters)
    for name, (k, p) in times_mask.items():
        log(f"[time] {smi}: {name} {DET_HW}^2 kernels {k:.3f} ms | plain "
            f"{p:.3f} ms (host fetches included)")

    # ---- 4g. open and inspect: FITS, RGB, MEF, ASDF in; previews out --
    launches_open, _ = open_inspect_path(field, bench_frame, counters, smi)

    # ---- 4i. stretch, tone, denoise, detection: files and the composite --
    launches_tone, _ = tone_detect_path(ms_field, (f_ys, f_xs, f_amps, dead),
                                        counters, smi)

    # ---- 4j. compose: RGB, LRGB, the wizard's blend/colour/align/crop ----
    launches_compose, _ = compose_path(field, (f_ys, f_xs, f_amps, dead),
                                       counters, smi)
    for name in ("coarse_box", "gather_crops", "sort_tiles", "window_stats",
                 "vote", "drizzle_finalize_fused"):
        if launches_compose[name] < 1:
            raise AssertionError(f"{name} never ran on the compose path: "
                                 f"{launches_compose}")

    # ---- 4k. FFT, deconvolution, cubes, tiles and synth: A13 + A14 -----
    launches_cube, _ = cube_synth_path(field, bench_frame, counters, smi)
    del bench_frame
    for name in ("shift_clip", "coarse_box", "gather_crops", "sort_tiles",
                 "window_stats"):
        if launches_cube[name] < 1:
            raise AssertionError(f"{name} never ran on the FFT, cube, tile "
                                 f"and synth path: {launches_cube}")
    if "jax" in sys.modules or "astroburst_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")

    # ---- 5. report -----------------------------------------------------
    meta = {
        "shift_clip": ("astroburst_tpu_torch/csrc/shift_clip.cu",
                       "astroburst_tpu/stacking/onepass_kernel.py:262"),
        "coarse_box": ("astroburst_tpu_torch/csrc/coarse_box.cu",
                       "astroburst_tpu/alignment/coarse_kernel.py:155"),
        "gather_crops": ("astroburst_tpu_torch/csrc/gather_crops.cu",
                         "astroburst_tpu/ops/crop_kernel.py:50"),
        "drizzle_finalize_fused": (
            "astroburst_tpu_torch/csrc/drizzle_finalize.cu",
            "astroburst_tpu/stacking/drizzle_kernel.py:292"),
        "drizzle_finalize": (
            "astroburst_tpu_torch/csrc/drizzle_finalize.cu",
            "astroburst_tpu/stacking/drizzle_kernel.py:339"),
        "sort_tiles": ("astroburst_tpu_torch/csrc/tile_sort.cu",
                       "astroburst_tpu/analysis/tile_sort_kernel.py:81"),
        "sort_tiles_chunked": (
            "astroburst_tpu_torch/csrc/tile_sort.cu",
            "astroburst_tpu/analysis/tile_sort_kernel.py:81"),
        "window_stats": ("astroburst_tpu_torch/csrc/window_stats.cu",
                         "astroburst_tpu/analysis/window_kernel.py:274"),
        "vote": ("astroburst_tpu_torch/csrc/triangle_vote.cu",
                 "astroburst_tpu/alignment/vote_kernel.py:104"),
        "paint_mask": ("astroburst_tpu_torch/csrc/star_mask.cu",
                       "astroburst_tpu/imaging/star_mask_kernel.py:87"),
        "drizzle_gather_finalize": (
            "astroburst_tpu_torch/csrc/drizzle_gather.cu",
            "astroburst_tpu/stacking/drizzle_gather_kernel.py:209"),
    }
    paths = {"align_stack_stretch+stack_images": launches_stack,
             f"stack_images({MANY_N}x{MANY_HW}^2)": launches_many,
             "calibrate+drizzle_stack": launches_drizzle,
             "detect_stars+align_channel_affine+warp_image"
             "+drizzle_stack(AFFINE)": launches_affine,
             "masked_stretch(x10,converged)+masked_stretch_rgb_shared":
                 launches_mask,
             "drizzle_exact_parity(calibrated,bench)": launches_parity,
             "stack(command)": launches_cmd,
             "open_and_inspect(commands)": launches_open,
             "calibrate+pipeline+drizzle+export(commands)": launches_export,
             "stretch+tone+denoise+detection(commands)": launches_tone,
             "compose(commands)+drizzle_rgb": launches_compose,
             "fft+deconvolution+cube+tiles+synth(commands)": launches_cube}
    kernels = []
    for name, (source, replaces) in meta.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path}
        entry.update(report[name])
        kernels.append(entry)
    kernels[0]["also_replaces"] = [
        "astroburst_tpu/stacking/fused_kernel.py:223",
        "astroburst_tpu/stacking/rolling_kernel.py:226",
        "astroburst_tpu/stacking/clip_kernel.py:183"]
    for entry in kernels:   # K8: the JAX tests' entry only
        if entry["name"] == "drizzle_finalize":
            entry["on_main_path"] = False
    paths_ms = {name: {"kernels_ms": k, "plain_ms": pl}
                for name, (k, pl) in times_c.items()}
    log(f"[path] detection/affine entry points: {json.dumps(paths_ms)}; "
        f"farthest isolated-star detection {det_err} px")
    log(f"[path] masked stretch entry points: " + json.dumps(
        {n: {"kernels_ms": k, "plain_ms": p} for n, (k, p)
         in times_mask.items()}) + f"; kernel vs plain image max|d| "
        f"{d_ms_img:.3e}, coverage max|d| {d_ms_cov:.3e}")
    log(f"[path] parity drizzle entry points: " + json.dumps(
        {n: {"kernels_ms": k, "plain_ms": p} for n, (k, p)
         in times_parity.items()}) + f"; against the one-band exact "
        f"route: {json.dumps(parity_err)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after start")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


def phase_4i_alone(sides) -> None:
    """Phase 4i alone, once per composite side in ``sides``: the build,
    4c's detection field scaled into [0, 1) as in 4d, then
    ``tone_detect_path`` with its checks and K10/K11/K13 counters;
    prints the card's name and power limit and each run's seconds."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")
    from astroburst_tpu_torch.analysis.tile_sort_kernel import (
        sort_tiles, sort_tiles_chunked)
    from astroburst_tpu_torch.analysis.window_kernel import window_stats
    from astroburst_tpu_torch.imaging.star_mask_kernel import paint_mask
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import cuda_device
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    lib = K.library()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvcc {lib.build_seconds:.1f} s")
    (field, ys, xs, amps, dead), _ = detection_fields(cuda_device())
    counters = {"sort_tiles": sort_tiles,
                "sort_tiles_chunked": sort_tiles_chunked,
                "window_stats": window_stats, "paint_mask": paint_mask}
    for side in sides:
        t0 = time.perf_counter()
        total, _ = tone_detect_path(field / MS_SCALE, (ys, xs, amps, dead),
                                    counters, smi, comp_hw=side)
        log(f"[4i] composite commands 3 x {side}^2: phase "
            f"{time.perf_counter() - t0:.1f} s, launches {total}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after start")


def phase_4j_alone(sides) -> None:
    """Phase 4j alone, once per side of the wizard's colour commands in
    ``sides``: the build, 4c's detection field, then ``compose_path``
    with its checks and every kernel's counter; prints the card's name
    and power limit and each run's seconds."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")
    from astroburst_tpu_torch.alignment.coarse_kernel import \
        coarse_downsample_stack
    from astroburst_tpu_torch.alignment.vote_kernel import vote
    from astroburst_tpu_torch.analysis.tile_sort_kernel import (
        sort_tiles, sort_tiles_chunked)
    from astroburst_tpu_torch.analysis.window_kernel import window_stats
    from astroburst_tpu_torch.ops.crop_kernel import gather_crops
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import cuda_device
    from astroburst_tpu_torch.stacking.drizzle_kernel import \
        drizzle_finalize_fused
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    lib = K.library()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvcc {lib.build_seconds:.1f} s")
    (field, ys, xs, amps, dead), _ = detection_fields(cuda_device())
    counters = {"coarse_box": coarse_downsample_stack,
                "gather_crops": gather_crops, "sort_tiles": sort_tiles,
                "sort_tiles_chunked": sort_tiles_chunked,
                "window_stats": window_stats, "vote": vote,
                "drizzle_finalize_fused": drizzle_finalize_fused}
    for side in sides:
        t0 = time.perf_counter()
        total, _ = compose_path(field, (ys, xs, amps, dead), counters, smi,
                                wiz_hw=side)
        log(f"[4j] the wizard's colour commands 3 x {side}^2: phase "
            f"{time.perf_counter() - t0:.1f} s, launches {total}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after start")


def phase_4k_alone(sides) -> None:
    """Phase 4k alone, once per side of the RGB tile pyramid in
    ``sides``: the build, 4c's detection field and one bench frame, then
    ``cube_synth_path`` with its checks and the counters of the kernels
    it reaches; prints the card's name and power limit and each run's
    seconds."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false); this script runs only on the card")
    from astroburst_tpu_torch.alignment.coarse_kernel import \
        coarse_downsample_stack
    from astroburst_tpu_torch.analysis.tile_sort_kernel import (
        sort_tiles, sort_tiles_chunked)
    from astroburst_tpu_torch.analysis.window_kernel import window_stats
    from astroburst_tpu_torch.ops.crop_kernel import gather_crops
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import cuda_device
    from astroburst_tpu_torch.stacking.onepass_kernel import \
        shift_clip_onepass
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    lib = K.library()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvcc {lib.build_seconds:.1f} s")
    dev = cuda_device()
    (field, *_), _ = detection_fields(dev)
    bench_frame = torch.as_tensor(make_frames(1, H, W)[0], device=dev)
    counters = {"shift_clip": shift_clip_onepass,
                "coarse_box": coarse_downsample_stack,
                "gather_crops": gather_crops, "sort_tiles": sort_tiles,
                "sort_tiles_chunked": sort_tiles_chunked,
                "window_stats": window_stats}
    for side in sides:
        t0 = time.perf_counter()
        total, _ = cube_synth_path(field, bench_frame, counters, smi,
                                   rgb_hw=side)
        log(f"[4k] RGB pyramid 3 x {side}^2: phase "
            f"{time.perf_counter() - t0:.1f} s, launches {total}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after start")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase-4k"]:
        phase_4k_alone([int(a) for a in sys.argv[2:]] or [TILE_RGB_HW])
    elif sys.argv[1:2] == ["--phase-4i"]:
        phase_4i_alone([int(a) for a in sys.argv[2:]] or [COMP_HW])
    elif sys.argv[1:2] == ["--phase-4j"]:
        phase_4j_alone([int(a) for a in sys.argv[2:]] or [COMP_HW])
    else:
        main()
