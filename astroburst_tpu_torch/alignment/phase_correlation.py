"""FFT phase correlation, coarse to fine
(counterpart of astroburst_tpu/alignment/phase_correlation.py).

Hann-windowed buffers → rfft2 → ε-guarded cross-power → irfft2 → peak
+ SNR confidence → circular unwrap + 3-point quadratic subpixel
(phase_correlation.rs, math/subpixel.rs:18-84). Planes larger than
512 on either axis are first correlated on coarse box-mean surfaces
(kernel K1, alignment/coarse_kernel.py), which seed one 512² refine
crop per target (kernel K2, ops/crop_kernel.py).

The (8, 128) origin arithmetic of ``_crop_origin_static`` and
``_refine_origin`` was chosen for TPU tiling, but it decides which
pixels the refine crops hold, so it is kept verbatim: changing it
moves the sub-pixel offsets.

``phase_correlate_stack`` replaces both ``phase_correlate_stack_traced``
and ``phase_correlate_stack_padded`` of the JAX package, which differ
only in TPU layout. ``phase_correlate`` is the host-level pair API.

On the card a coarse-to-fine call is ~120 small torch ops a
correlation, each costing the host far more than the card. So from the
second call with the same (device, N, H, W, dtype) on, the two
correlations are replayed as captured CUDA graphs (``_StackGraphs``):
K1 fills buffers the graphs own, the first graph correlates the coarse
surfaces and ends in the crop origins, K2 gathers the crops into the
second graph's input, and the second correlates the crops and gates
them. The graphs hold no pointer into the caller's stack, run the same
ops as the eager call, and so give its bits. The CPU, the plain
versions (``runtime/kernels.plain_versions``) and planes of at most
512 px a side run eagerly, as does a key's first call; ``_GRAPHS``
keeps at most 4 keys.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections import OrderedDict
from dataclasses import dataclass

import torch

from astroburst_tpu_torch.alignment.coarse_kernel import (
    box_plan, coarse_downsample_stack, frame_stats_plain, reduce_row_stats)
from astroburst_tpu_torch.ops import fft as F
from astroburst_tpu_torch.ops.crop_kernel import gather_crops
from astroburst_tpu_torch.ops.window import hann_periodic
from astroburst_tpu_torch.runtime import kernels as K
from astroburst_tpu_torch.runtime import trace

COARSE_MAX_DIM = 512        # phase_correlation.rs:10
REFINE_CROP_SIZE = 512      # phase_correlation.rs:11
CONFIDENCE_THRESHOLD = 2.0  # phase_correlation.rs:12
EPSILON = 1e-15


@dataclass(frozen=True)
class PhaseCorrelationResult:
    dy: float
    dx: float
    confidence: float


def is_low_confidence(confidence: float) -> bool:
    return confidence < CONFIDENCE_THRESHOLD


def _gate(mn: torch.Tensor, mx: torch.Tensor,
          cnt: torch.Tensor) -> torch.Tensor:
    """finite_count < 16 or range < 1e-10 (phase_correlation.rs:143-161)."""
    return (cnt < 16) | (torch.abs(mx - mn) < 1e-10)


def _is_constant_or_zero(img: torch.Tensor) -> torch.Tensor:
    """The validity gate over the last two axes (NaN/inf excluded)."""
    return _gate(*frame_stats_plain(img))


@functools.lru_cache(maxsize=64)
def hann_on(n: int, device: torch.device) -> torch.Tensor:
    """``hann_periodic(n)`` as an f32 tensor on ``device``, made once per
    (length, device): an upload from host memory on every call would
    make the host wait for the card, and a CUDA graph cannot hold it."""
    return torch.from_numpy(hann_periodic(n)).to(device)


def _windowed_padded(img: torch.Tensor, fft_rows: int,
                     fft_cols: int) -> torch.Tensor:
    """Hann-window (zeroing non-finite) and zero-pad (fft.rs:202-226)."""
    rows, cols = img.shape[-2], img.shape[-1]
    wy = hann_on(rows, img.device)
    wx = hann_on(cols, img.device)
    vals = torch.where(torch.isfinite(img), img, torch.zeros_like(img))
    vals = vals * wy[:, None] * wx[None, :]
    return torch.nn.functional.pad(vals, (0, fft_cols - cols,
                                          0, fft_rows - rows))


def _peak_neighbors(corr: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """Wraparound prev/next values on both axes (subpixel.rs:28-64)."""
    rows, cols = corr.shape[-2], corr.shape[-1]
    flat = corr.reshape(*corr.shape[:-2], rows * cols)

    def at(y, x):
        idx = y * cols + x
        return torch.gather(flat, -1, idx[..., None])[..., 0]

    center = at(py, px)
    y_prev = at((py - 1) % rows, px)
    y_next = at((py + 1) % rows, px)
    x_prev = at(py, (px - 1) % cols)
    x_next = at(py, (px + 1) % cols)
    return center, y_prev, y_next, x_prev, x_next


def _quadratic(prev, center, nxt):
    """3-point parabola vertex, clamped to ±0.5 (subpixel.rs:18-26):
    (next − prev) / (2·(2·center − prev − next)), positive when the peak
    leans towards ``nxt``. The JAX package's ``_quadratic`` has
    (prev − next) over the same denominator, the vertex negated, so its
    sub-pixel part points away from the true shift (ROADMAP C8); the
    port follows the parabola."""
    denom = 2.0 * (2.0 * center - prev - nxt)
    small = torch.abs(denom) < 1e-15
    off = torch.where(small, torch.zeros_like(denom),
                      (nxt - prev) / torch.where(small,
                                                 torch.ones_like(denom),
                                                 denom))
    return torch.clamp(off, -0.5, 0.5)


def _peak_stats(corr: torch.Tensor):
    """(argmax flat index, peak, sum, sum of squares) over the last two
    axes; ties go to the lowest flat index (``torch.argmax`` returns the
    first maximal index)."""
    r, c = corr.shape[-2], corr.shape[-1]
    flat = corr.reshape(*corr.shape[:-2], r * c)
    idx = torch.argmax(flat, dim=-1)
    peak = torch.gather(flat, -1, idx[..., None])[..., 0]
    return idx, peak, flat.sum(dim=-1), (flat * flat).sum(dim=-1)


def _corr_to_shift(corr: torch.Tensor, fft_rows: int, fft_cols: int):
    """Peak + SNR confidence + circular unwrap + quadratic subpixel. The
    variance keeps the one-pass sum/sumsq form of the JAX package."""
    idx, peak_val, s, s2 = _peak_stats(corr)
    py = torch.div(idx, fft_cols, rounding_mode="floor")
    px = idx % fft_cols
    n = fft_rows * fft_cols
    mean = s / n
    var = torch.clamp(s2 - s * mean, min=0.0) / max(n - 1, 1)
    sigma = torch.sqrt(var)
    confidence = torch.where(torch.abs(sigma) < 1e-15,
                             torch.zeros_like(sigma),
                             (peak_val - mean) / torch.clamp(sigma,
                                                             min=1e-30))
    center, yp, yn, xp, xn = _peak_neighbors(corr, py, px)
    sub_dy = _quadratic(yp, center, yn)
    sub_dx = _quadratic(xp, center, xn)
    raw_dy = torch.where(py > fft_rows // 2, py - fft_rows, py).float()
    raw_dx = torch.where(px > fft_cols // 2, px - fft_cols, px).float()
    return raw_dy + sub_dy, raw_dx + sub_dx, confidence


def _frame_by_frame(fn, x: torch.Tensor, **kw) -> torch.Tensor:
    """``fn`` (a 2-D transform) over the frames of ``x`` [..., R, C]. On
    the CPU each frame is transformed on its own: MKL's batched
    real-to-complex transforms round a frame differently with the batch
    it is in, and a frame's offset must not depend on which frames
    share its call (the sharded step aligns each shard's frames alone:
    parallel/pipeline.py). cuFFT's batched plans are used as they are."""
    if x.is_cuda or x.ndim == 2:
        return fn(x, **kw)
    flat = x.reshape(-1, *x.shape[-2:])
    out = torch.cat([fn(flat[i:i + 1], **kw) for i in range(flat.shape[0])])
    return out.reshape(*x.shape[:-2], *out.shape[-2:])


def correlate_single(a: torch.Tensor, b: torch.Tensor):
    """Single-scale phase correlation of b [..., R, C] against a [R, C].

    Returns (dy, dx, confidence) f32 with b's leading shape. With b
    displaced by (+dy, +dx) relative to a, the peak lands at (+dy, +dx),
    so shift_bicubic(b, dy, dx) maps b back onto a (align.rs:92-105).
    ``rfft2``/``irfft2`` with ``s=`` cover odd (1-pixel) axes too.
    """
    with trace.span("alignment.correlate"):
        return _correlate_single(a, b)


def _correlate_single(a: torch.Tensor, b: torch.Tensor):
    rows, cols = a.shape[-2], a.shape[-1]
    fft_rows = F.next_power_of_two(rows)
    fft_cols = F.next_power_of_two(cols)
    fa = torch.fft.rfft2(_windowed_padded(a, fft_rows, fft_cols))
    fb = _frame_by_frame(torch.fft.rfft2,
                         _windowed_padded(b, fft_rows, fft_cols))
    cr, ci = F.cross_power(fb.real, fb.imag, fa.real, fa.imag, EPSILON)
    corr = _frame_by_frame(torch.fft.irfft2, torch.complex(cr, ci),
                           s=(fft_rows, fft_cols))
    dy, dx, confidence = _corr_to_shift(corr, fft_rows, fft_cols)
    bad = _is_constant_or_zero(a) | _is_constant_or_zero(b)
    zero = torch.zeros_like(dy)
    return (torch.where(bad, zero, dy), torch.where(bad, zero, dx),
            torch.where(bad, zero, confidence))


def _centered_crop_static(img: torch.Tensor, size: int) -> torch.Tensor:
    rows, cols = img.shape[-2], img.shape[-1]
    y0, x0 = _crop_origin_static(rows, cols, size)
    return img[..., y0:y0 + min(size, rows), x0:x0 + min(size, cols)]


def _crop_origin_static(rows: int, cols: int, size: int):
    return ((max(rows // 2 - size // 2, 0) // 8) * 8,
            (max(cols // 2 - size // 2, 0) // 128) * 128)


def _refine_origin(cy: torch.Tensor, cx: torch.Tensor, rows: int, cols: int,
                   size: int):
    """Refine-crop origin rounded to the NEAREST (8, 128) multiple and
    clamped to a tile-multiple upper bound (phase_correlation.py:294)."""
    y0 = torch.div(cy - size // 2 + 4, 8, rounding_mode="floor") * 8
    x0 = torch.div(cx - size // 2 + 64, 128, rounding_mode="floor") * 128
    y0 = torch.clamp(y0, 0, (max(rows - size, 0) // 8) * 8)
    x0 = torch.clamp(x0, 0, (max(cols - size, 0) // 128) * 128)
    return y0, x0


def _refine_origins(cdy: torch.Tensor, cdx: torch.Tensor, by: int, bx: int,
                    rows: int, cols: int):
    """Each target's refine-crop origin (int64 [N]) from its coarse
    offset."""
    tgt_cy = torch.clamp(torch.round(rows // 2 + cdy * by), 0,
                         rows - 1).to(torch.int64)
    tgt_cx = torch.clamp(torch.round(cols // 2 + cdx * bx), 0,
                         cols - 1).to(torch.int64)
    return _refine_origin(tgt_cy, tgt_cx, rows, cols, REFINE_CROP_SIZE)


def _combine(tgt_y0, tgt_x0, rdy, rdx, rconf, ref_stats, tgt_stats,
             rows: int, cols: int):
    """The offsets from the crop origins and the refine, zeroed where
    the reference or the target fails the validity gate."""
    ref_y0, ref_x0 = _crop_origin_static(rows, cols, REFINE_CROP_SIZE)
    dy = (tgt_y0 - ref_y0).float() + rdy
    dx = (tgt_x0 - ref_x0).float() + rdx
    bad = _gate(*ref_stats) | _gate(*tgt_stats)
    zero = torch.zeros_like(dy)
    return (torch.where(bad, zero, dy), torch.where(bad, zero, dx),
            torch.where(bad, zero, rconf))


def phase_correlate_stack(ref: torch.Tensor, targets: torch.Tensor, *,
                          plain: bool = False):
    """Coarse-to-fine phase correlation of each frame of ``targets``
    [N, H, W] against ``ref`` [H, W]. Returns (dys, dxs, confidences),
    each f32 [N], on the inputs' device; nothing waits on the host.

    On a CUDA stack the coarse surfaces and the per-frame validity gate
    come from kernel K1 and the refine crops from kernel K2, and a
    shape seen before replays its CUDA graphs (module docstring).
    ``plain`` runs the call in ``runtime/kernels.plain_versions()``.
    """
    if plain:
        with K.plain_versions():
            return phase_correlate_stack(ref, targets)
    with trace.span("alignment.phase_corr"):
        return _phase_correlate_stack(ref, targets)


def _phase_correlate_stack(ref: torch.Tensor, targets: torch.Tensor):
    n, rows, cols = targets.shape
    small = rows <= COARSE_MAX_DIM and cols <= COARSE_MAX_DIM
    if K.use_kernel(targets, "phase_correlate_stack"):
        key = None if small else graph_key(ref, targets)
        graphs = None if key is None else _GRAPHS.get(key)
        if graphs is not None:
            return graphs.run(ref, targets)
        trace.count("alignment.phase_corr.eager")
    if small:
        return correlate_single(ref, targets)

    with trace.span("alignment.coarse"):
        ref_ds, by, bx, *ref_stats = coarse_downsample_stack(
            ref[None], COARSE_MAX_DIM, with_stats=True)
        tgt_ds, _, _, *tgt_stats = coarse_downsample_stack(
            targets, COARSE_MAX_DIM, with_stats=True)
    cdy, cdx, _ = correlate_single(ref_ds[0], tgt_ds)
    tgt_y0, tgt_x0 = _refine_origins(cdy, cdx, by, bx, rows, cols)
    s_r = min(REFINE_CROP_SIZE, rows)
    s_c = min(REFINE_CROP_SIZE, cols)
    with trace.span("alignment.crops"):
        crops = gather_crops(targets, tgt_y0, tgt_x0, s_r, s_c)
        ref_crop = _centered_crop_static(ref, REFINE_CROP_SIZE)
    rdy, rdx, rconf = correlate_single(ref_crop, crops)
    return _combine(tgt_y0, tgt_x0, rdy, rdx, rconf, ref_stats, tgt_stats,
                    rows, cols)


# ---- the coarse-to-fine correlation as CUDA graphs ---------------------------


def graph_key(ref: torch.Tensor, targets: torch.Tensor):
    """(device, N, H, W, dtype) of a call the graphs can take, or None:
    at least one target, the reference one [H, W] plane of the same
    device and dtype, both contiguous."""
    n, rows, cols = targets.shape
    if n < 1 or tuple(ref.shape) != (rows, cols) or \
            ref.device != targets.device or ref.dtype != targets.dtype or \
            not (ref.is_contiguous() and targets.is_contiguous()):
        return None
    return (targets.device, n, rows, cols, targets.dtype)


class GraphCache:
    """At most ``capacity`` keys, the least recently used dropped first.
    A key's first sighting returns None (its call runs eagerly), the
    second builds its entry with ``build(key)``, and later sightings
    return that entry."""

    def __init__(self, build, capacity: int = 4):
        self._build = build
        self._capacity = capacity
        self._entries = OrderedDict()     # key -> entry, or None once seen
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key not in self._entries:
                self._entries[key] = None
                if len(self._entries) > self._capacity:
                    self._entries.popitem(last=False)
                return None
            self._entries.move_to_end(key)
            if self._entries[key] is None:
                self._entries[key] = self._build(key)
            return self._entries[key]

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)


def capture_cuda(body, pool=None):
    """Warm ``body`` up on a side stream (cuFFT's plans, the allocator's
    blocks), capture it into a CUDA graph in ``pool`` (a new one where
    None) and replay it once. Returns (the graph, what ``body``
    returned: tensors the graph owns, which each replay overwrites)."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = body()
    graph.replay()
    return graph, out


class _StackGraphs:
    """One key's coarse-to-fine correlation over buffers it owns: K1
    fills the coarse surfaces and row stats, graph 1 (``_coarse``)
    correlates them and ends in the int64 crop origins, K2 gathers the
    crops and a copy takes the reference's crop, and graph 2
    (``_refine``) correlates the crops and gates and combines the
    offsets into [3, N]. Each is captured by ``capture`` on the entry's
    first run; a run hands back a clone, never the graph's buffer."""

    def __init__(self, key, capture=capture_cuda):
        device, n, rows, cols, _ = key
        self.device, self.rows, self.cols = device, rows, cols
        self.by, self.bx, ds_r, ds_c = box_plan(rows, cols, COARSE_MAX_DIM)
        self.s_r = min(REFINE_CROP_SIZE, rows)
        self.s_c = min(REFINE_CROP_SIZE, cols)
        f32 = dict(dtype=torch.float32, device=device)

        def k1_out(m):
            return (torch.empty((m, ds_r, ds_c), **f32),
                    torch.empty((m, ds_r), **f32),
                    torch.empty((m, ds_r), **f32),
                    torch.empty((m, ds_r), dtype=torch.int32, device=device))
        self.ref_k1, self.tgt_k1 = k1_out(1), k1_out(n)
        self.crops = torch.empty((n, self.s_r, self.s_c), **f32)
        self.ref_crop = torch.empty((self.s_r, self.s_c), **f32)
        self._capture = capture
        self._coarse = self._refine = None
        self._origins = self._result = None
        self._lock = threading.Lock()
        self._cuda = device.type == "cuda"
        # the last run's end: a run on another stream waits for it
        # before it overwrites the buffers
        self._done = torch.cuda.Event() if self._cuda else None

    def _coarse_body(self):
        cdy, cdx, _ = _correlate_single(self.ref_k1[0][0], self.tgt_k1[0])
        return _refine_origins(cdy, cdx, self.by, self.bx, self.rows,
                               self.cols)

    def _refine_body(self):
        rdy, rdx, rconf = _correlate_single(self.ref_crop, self.crops)
        return torch.stack(_combine(
            *self._origins, rdy, rdx, rconf,
            reduce_row_stats(*self.ref_k1[1:]),
            reduce_row_stats(*self.tgt_k1[1:]), self.rows, self.cols))

    def run(self, ref: torch.Tensor, targets: torch.Tensor):
        scope = torch.cuda.device(self.device) if self._cuda else \
            contextlib.nullcontext()
        with self._lock, scope:
            if self._cuda:
                torch.cuda.current_stream().wait_event(self._done)
            coarse_downsample_stack(ref[None], COARSE_MAX_DIM,
                                    out=self.ref_k1)
            coarse_downsample_stack(targets, COARSE_MAX_DIM, out=self.tgt_k1)
            if self._coarse is None:
                trace.count("alignment.phase_corr.graph_capture")
                self._coarse, self._origins = self._capture(
                    self._coarse_body)
            else:
                self._coarse.replay()
            gather_crops(targets, *self._origins, self.s_r, self.s_c,
                         out=self.crops)
            self.ref_crop.copy_(_centered_crop_static(ref,
                                                      REFINE_CROP_SIZE))
            if self._refine is None:
                self._refine, self._result = self._capture(
                    self._refine_body, self._coarse.pool())
            else:
                self._refine.replay()
            out = self._result.clone()
            if self._cuda:
                self._done.record()
        trace.count("alignment.phase_corr.graph_replay")
        return out.unbind(0)


_GRAPHS = GraphCache(_StackGraphs)


def phase_correlate(reference, target) -> PhaseCorrelationResult:
    """Host-level API: crop both [H, W] tensors to their common dims,
    correlate on their device, fetch (dy, dx, confidence)."""
    rows = min(reference.shape[0], target.shape[0])
    cols = min(reference.shape[1], target.shape[1])
    ref = reference[:rows, :cols].float().contiguous()
    tgt = target[:rows, :cols].float().contiguous()
    dy, dx, conf = phase_correlate_stack(ref, tgt[None])
    return PhaseCorrelationResult(float(dy[0]), float(dx[0]), float(conf[0]))
