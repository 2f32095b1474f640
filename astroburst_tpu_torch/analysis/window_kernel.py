"""K11: per-peak window statistics for star detection.

Counterpart of astroburst_tpu/analysis/window_kernel.py:
``window_stats_pallas``; the CUDA kernel is ``csrc/window_stats.cu``
(header note there: what bounds it and how it is laid out). For each
peak: the 41 × 41 window around its centre, a flood fill from the
centre over finite pixels above the threshold (8-connected, at most
``half`` = 20 dilation rounds), then the masked moments. Returns [K, 9]
f32 rows: npix, flux, cy, cx, r2m, sxx, syy, sxy, pval, with
window-relative centroids (0..40); rows of slots ≥ ``n_valid`` are zero.

Unlike the TPU kernel, this one reads the UNPADDED image (pixels outside
the plane read as NaN), so peak centres are image coordinates and no
padded copy is made; ``n_valid``, ``threshold`` and ``bg_med`` stay on
the device. The plain version is the XLA gather + fill + moments of
star_detection.py:360-406, with the dead rows zeroed as the kernel
zeroes them.

``window_stats`` launches the kernel for a CUDA tensor and runs
``window_stats_plain`` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.runtime import kernels as K

WINDOW = 41
HALF = WINDOW // 2


def window_members_plain(image: torch.Tensor, pys: torch.Tensor,
                         pxs: torch.Tensor, threshold: torch.Tensor):
    """The [K, 41, 41] windows (NaN outside the plane) and their member
    masks after exactly HALF fill rounds."""
    dev = image.device
    padded = torch.nn.functional.pad(image, (HALF, HALF, HALF, HALF),
                                     value=float("nan"))
    ar = torch.arange(WINDOW, device=dev)
    pys = pys.to(device=dev, dtype=torch.int64)
    pxs = pxs.to(device=dev, dtype=torch.int64)
    win = padded[(pys[:, None] + ar)[:, :, None],
                 (pxs[:, None] + ar)[:, None, :]]          # [K, 41, 41]
    wabove = torch.isfinite(win) & (win > threshold)
    k = win.shape[0]
    member = torch.zeros((k, WINDOW, WINDOW), dtype=torch.bool, device=dev)
    member[:, HALF, HALF] = True
    for _ in range(HALF):
        m = torch.nn.functional.pad(member, (1, 1, 1, 1))
        grown = member
        for dy in range(3):
            for dx in range(3):
                if dy != 1 or dx != 1:
                    grown = grown | m[:, dy:dy + WINDOW, dx:dx + WINDOW]
        member = grown & wabove
    return win, member


def window_stats_plain(image: torch.Tensor, pys: torch.Tensor,
                       pxs: torch.Tensor, threshold: torch.Tensor,
                       bg_med: torch.Tensor,
                       n_valid: torch.Tensor) -> torch.Tensor:
    """[K, 9] window statistics in torch (exactly HALF fill rounds)."""
    dev = image.device
    win, member = window_members_plain(image, pys, pxs, threshold)
    k = win.shape[0]
    v = torch.where(member, torch.clamp(win - bg_med, min=0.0), 0.0)
    npix = member.sum(dim=(1, 2)).to(torch.float32)
    flux = v.sum(dim=(1, 2))
    yy = torch.arange(WINDOW, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(WINDOW, dtype=torch.float32, device=dev)[None, None, :]
    safe_flux = torch.clamp(flux, min=1e-30)
    cy = (yy * v).sum(dim=(1, 2)) / safe_flux
    cx = (xx * v).sum(dim=(1, 2)) / safe_flux
    dy = yy - cy[:, None, None]
    dx = xx - cx[:, None, None]
    r2m = ((dx * dx + dy * dy) * v).sum(dim=(1, 2))
    sxx = (dx * dx * v).sum(dim=(1, 2)) / safe_flux
    syy = (dy * dy * v).sum(dim=(1, 2)) / safe_flux
    sxy = (dx * dy * v).sum(dim=(1, 2)) / safe_flux
    pval = v.amax(dim=(1, 2))
    stats = torch.stack([npix, flux, cy, cx, r2m, sxx, syy, sxy, pval],
                        dim=1)
    live = torch.arange(k, device=dev) < n_valid.to(dev)
    return torch.where(live[:, None], stats, 0.0)


def window_stats(image: torch.Tensor, pys: torch.Tensor, pxs: torch.Tensor,
                 threshold: torch.Tensor, bg_med: torch.Tensor,
                 n_valid: torch.Tensor) -> torch.Tensor:
    """[K, 9] statistics of the windows centred on (pys, pxs) of the
    [H, W] ``image``; ``threshold``, ``bg_med`` (f32) and ``n_valid``
    (int32 on the card) are one-element tensors on the image's device.
    On the card the call makes one launch, which reads those three where
    they lie, and allocates the output, nothing else."""
    if not K.use_kernel(image, "window_stats"):
        return window_stats_plain(image, pys, pxs, threshold, bg_med,
                                  n_valid)
    K.require_cuda(image, "image", 2)
    K.require_cuda(pys, "pys", 1, torch.int32)
    K.require_cuda(pxs, "pxs", 1, torch.int32)
    k = pys.shape[0]
    if pxs.shape != (k,):
        raise ValueError("pys and pxs must be 1-D of equal length")
    dev = image.device
    for t, name, dtype in ((threshold, "threshold", torch.float32),
                           (bg_med, "bg_med", torch.float32),
                           (n_valid, "n_valid", torch.int32)):
        if t.device != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be one {dtype} value on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((k, 9), dtype=torch.float32, device=dev)
    h, w = image.shape
    K.launch("abt_window_stats", image.data_ptr(), h, w, pys.data_ptr(),
             pxs.data_ptr(), k, n_valid.data_ptr(), threshold.data_ptr(),
             bg_med.data_ptr(), out.data_ptr(), K.stream_handle(image))
    window_stats.launches += 1
    return out


window_stats.launches = 0
