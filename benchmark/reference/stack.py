"""Shift, sigma-clip combine, robust statistics, auto-STF and preview.

- Shift: per-frame Catmull-Rom resampling, out[k, y, x] =
  bicubic(frame k, y + dy_k, x + dx_k), taps clamped to the plane, the
  four row taps summed first, zero where the source centre falls
  outside [-0.5, n - 0.5]; a frame whose offset is under 1e-12 on both
  axes is taken as it is.
- Clip: per pixel over the frames, iteration 0 centred on the median
  with sigma = max(1.4826 MAD, 1e-10) (both at sorted index cnt // 2),
  later ones on the mean and sample std; low/high bounds; a pixel is
  clipped while it holds 2 or more values and its last pass removed
  one; the result is the mean of the survivors (summed in frame
  order), else the last finite centre, else 0. Values take part when
  finite.
- Statistics of the valid pixels (finite and above 1e-7): min, max,
  sum, count, median and MAD, at the single rank ceil(n/2) above 4 M
  pixels and as the mean of the two middle ranks up to it.
- Auto-STF (target background 0.25, shadow clip -2.8 sigma) and its
  u8 preview, round-half-even, invalid pixels black; the nearest
  downsample of a plane larger than the preview's side.
- Histogram: the count of each bin over the f32 interior edges
  dmin + step * j.
"""

from __future__ import annotations

import math

import torch

MAD_TO_SIGMA = 1.4826
EXACT_PAIR_MAX_PIXELS = 4_000_000
PADDING = 1e-7


def catmull_rom(t: torch.Tensor) -> torch.Tensor:
    a = torch.abs(t)
    inner = a * a * (1.5 * a - 2.5) + 1.0
    outer = a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0
    return torch.where(a <= 1.0, inner,
                       torch.where(a <= 2.0, outer, torch.zeros_like(a)))


def shift_frame(img: torch.Tensor, dy: float, dx: float) -> torch.Tensor:
    """One [H, W] frame moved by (dy, dx), host offsets."""
    rows, cols = img.shape
    if abs(dy) < 1e-12 and abs(dx) < 1e-12:
        return img
    dev = img.device
    ky, kx = math.floor(dy), math.floor(dx)
    fy = torch.tensor(dy, dtype=torch.float32) - float(ky)
    fx = torch.tensor(dx, dtype=torch.float32) - float(kx)
    ar = torch.arange(rows, device=dev)
    ac = torch.arange(cols, device=dev)
    tmp = None
    for j in range(4):
        w = float(catmull_rom(fy - (j - 1)))
        term = w * img[torch.clamp(ar + ky + j - 1, 0, rows - 1)]
        tmp = term if tmp is None else tmp + term
    out = None
    for i in range(4):
        w = float(catmull_rom(fx - (i - 1)))
        term = w * tmp[:, torch.clamp(ac + kx + i - 1, 0, cols - 1)]
        out = term if out is None else out + term
    sy = ar.to(torch.float32)[:, None] + torch.tensor(dy, dtype=torch.float32)
    sx = ac.to(torch.float32)[None, :] + torch.tensor(dx, dtype=torch.float32)
    inside = (sy >= -0.5) & (sy <= rows - 0.5) & (sx >= -0.5) & \
        (sx <= cols - 0.5)
    return torch.where(inside, out, torch.zeros((), device=dev))


def _select(stack, mask, rank):
    inf = torch.full_like(stack, float("inf"))
    svals = torch.sort(torch.where(mask, stack, inf), dim=0).values
    return torch.gather(svals, 0, rank[None].to(torch.int64))[0]


def _frame_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


def sigma_clip(stack: torch.Tensor, sigma_low: float, sigma_high: float,
               max_iter: int):
    """(combined [H, W] f32, rejected count as an int) of [N, H, W]."""
    finite = torch.isfinite(stack)
    count0 = finite.sum(dim=0)
    mask = finite
    stopped = torch.zeros(stack.shape[1:], dtype=torch.bool,
                          device=stack.device)
    last = torch.full(stack.shape[1:], float("nan"), device=stack.device)
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)
    for it in range(max_iter):
        cnt = mask.sum(dim=0)
        cntf = torch.clamp(cnt.to(torch.float32), min=1.0)
        if it == 0:
            center = _select(stack, mask, cnt // 2)
            mad = _select(torch.abs(stack - center), mask, cnt // 2)
            sigma = torch.clamp(mad * MAD_TO_SIGMA, min=1e-10)
        else:
            center = _frame_sum(torch.where(mask, stack, zero)) / cntf
            var = _frame_sum(torch.where(mask, (stack - center) ** 2,
                                         zero)) / torch.clamp(cntf - 1.0,
                                                              min=1.0)
            sigma = torch.clamp(torch.sqrt(var), min=1e-10)
        active = (cnt >= 2) & ~stopped
        dev = stack - center
        keep = (dev >= -sigma_low * sigma) & (dev <= sigma_high * sigma)
        new_mask = torch.where(active[None], mask & keep, mask)
        removed = cnt - new_mask.sum(dim=0)
        last = torch.where(active, center, last)
        stopped = stopped | (active & (removed == 0))
        mask = new_mask
    final = mask.sum(dim=0)
    mean = _frame_sum(torch.where(mask, stack, zero)) / torch.clamp(
        final.to(torch.float32), min=1.0)
    fallback = torch.where(torch.isfinite(last), last, zero)
    combined = torch.where(final > 0, mean, fallback)
    return combined, int((count0 - final).sum())


def clip_in_rows(stack: torch.Tensor, sigma_low: float, sigma_high: float,
                 max_iter: int, rows: int = 512):
    """``sigma_clip`` a block of rows at a time (it holds several copies
    of the block)."""
    parts, rejected = [], 0
    for y0 in range(0, stack.shape[1], rows):
        c, r = sigma_clip(stack[:, y0:y0 + rows], sigma_low, sigma_high,
                          max_iter)
        parts.append(c)
        rejected += r
    return torch.cat(parts), rejected


def stats(x: torch.Tensor, pair=None) -> dict:
    """Robust statistics of the valid pixels, host floats of f32 values.
    ``pair``: the two-rank median (default: up to 4 M pixels)."""
    flat = x.reshape(-1)
    valid = torch.isfinite(flat) & (flat > PADDING)
    n = int(valid.sum())
    if n == 0:
        return {"min": 0.0, "max": 0.0, "mean": 0.0, "median": 0.0,
                "mad": 0.0, "sigma": 0.0, "count": 0}
    vals = flat[valid]
    srt = torch.sort(vals).values
    if pair is None:
        pair = flat.numel() <= EXACT_PAIR_MAX_PIXELS

    def median(s):
        if pair:
            return (s[(n + 1) // 2 - 1] + s[n // 2]) * 0.5
        return s[(n + 1) // 2 - 1]

    med = median(srt)
    mad = median(torch.sort(torch.abs(vals - med)).values)
    out = {"min": float(srt[0]), "max": float(srt[-1]),
           "mean": float(vals.sum()) / n, "median": float(med),
           "mad": float(mad), "count": n}
    out["sigma"] = max(out["mad"] * MAD_TO_SIGMA, 1e-30)
    return out


def auto_stf(st: dict, target_bg: float = 0.25,
             shadow_k: float = -2.8) -> dict:
    """(shadow, midtone, highlight) from ``stats``, host f64 math."""
    if st["count"] == 0:
        return {"shadow": 0.0, "midtone": 0.5, "highlight": 1.0}
    rng = max(st["max"] - st["min"], 1e-30)
    med = (st["median"] - st["min"]) / rng
    shadow = min(max(med + shadow_k * st["sigma"] / rng, 0.0), 0.98)
    m = min(max((med - shadow) / max(1.0 - shadow, 1e-15), 0.0), 1.0)
    if m <= 0.0 or m >= 1.0:
        mid = 0.5
    else:
        denom = 2.0 * target_bg * m - target_bg - m
        mid = 0.5 if abs(denom) < 1e-15 else min(
            max(m * (target_bg - 1.0) / denom, 0.0001), 0.9999)
    return {"shadow": shadow, "midtone": mid, "highlight": 1.0}


def auto_stf_f32(st: dict, device, target_bg: float = 0.25,
                 shadow_k: float = -2.8):
    """(shadow, midtone) as f32 0-d tensors, every step in f32 (the
    form a device pipeline computes without a host round trip)."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    mn, mx = t(st["min"]), t(st["max"])
    rng = torch.clamp(mx - mn, min=1e-30)
    med = (t(st["median"]) - mn) / rng
    sigma = torch.clamp(t(st["mad"]) * MAD_TO_SIGMA, min=1e-30)
    shadow = torch.clamp(med + shadow_k * (sigma / rng), 0.0, 0.98)
    m = torch.clamp((med - shadow) / torch.clamp(1.0 - shadow, min=1e-15),
                    0.0, 1.0)
    denom = 2.0 * target_bg * m - target_bg - m
    tiny = torch.abs(denom) < 1e-15
    bal = torch.clamp(m * (target_bg - 1.0) / torch.where(
        tiny, torch.ones_like(denom), denom), 0.0001, 0.9999)
    mid = torch.where((m <= 0.0) | (m >= 1.0) | tiny, t(0.5), bal)
    if st["count"] == 0:
        return t(0.0), t(0.5)
    return shadow, mid


def stf_u8(x: torch.Tensor, dmin, inv_range, shadow, inv_clip,
           midtone) -> torch.Tensor:
    """The STF of x as u8 from f32 parameters (0-d tensors or floats
    rounded to f32); invalid pixels black."""
    def t(v):
        return torch.as_tensor(v, dtype=torch.float32).to(x.device)

    c = torch.clamp((((x - t(dmin)) * t(inv_range)) - t(shadow))
                    * t(inv_clip), 0.0, 1.0)
    m = t(midtone)
    s = (m - 1.0) * c / ((2.0 * m - 1.0) * c - m)
    s = torch.where(c <= 0.0, torch.zeros_like(c),
                    torch.where(c >= 1.0, torch.ones_like(c), s))
    q = torch.clamp(torch.round(s * 255.0), 0.0, 255.0)
    valid = torch.isfinite(x) & (x > PADDING)
    return torch.where(valid, q, torch.zeros_like(q)).to(torch.uint8)


def preview_u8(x: torch.Tensor, st: dict, stf: dict,
               max_dim: int = 4096) -> torch.Tensor:
    """A command's preview: the nearest downsample to ``max_dim``, then
    the STF with its parameters worked out on the host in f64."""
    rng = max(st["max"] - st["min"], 1e-30)
    return stf_u8(nearest_downsample(x, max_dim), st["min"], 1.0 / rng,
                  stf["shadow"], 1.0 / max(1.0 - stf["shadow"], 1e-15),
                  stf["midtone"])


def nearest_downsample(x: torch.Tensor, max_dim: int) -> torch.Tensor:
    h, w = x.shape
    if h <= max_dim and w <= max_dim:
        return x
    scale = max_dim / max(h, w)
    dh, dw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)

    def index(src, dst):
        d = torch.arange(dst, dtype=torch.int32, device=x.device)
        return torch.clamp((d * (src / dst)).to(torch.int32), max=src - 1)

    return x.index_select(0, index(h, dh)).index_select(1, index(w, dw))


def histogram(x: torch.Tensor, dmin: float, dmax: float,
              bins: int) -> torch.Tensor:
    """int64 [bins] counts of the valid pixels over the f32 edges."""
    flat = x.reshape(-1)
    valid = torch.isfinite(flat) & (flat > PADDING)
    if not (math.isfinite(dmin) and math.isfinite(dmax)) or \
            dmax - dmin < 1e-10:
        return torch.zeros(bins, dtype=torch.int64)
    lo = torch.tensor(dmin, dtype=torch.float32, device=x.device)
    step = (torch.tensor(dmax, dtype=torch.float32, device=x.device)
            - lo) / bins
    edges = lo + step * torch.arange(1, bins, dtype=torch.float32,
                                     device=x.device)
    idx = torch.searchsorted(edges, flat[valid], right=True)
    return torch.bincount(idx, minlength=bins)[:bins].cpu()
