"""Spans and counters inside the port, on the profiler's clock.

Tracing is off by default. An operator turns it on, runs commands, and
drains what was kept::

    from astroburst_tpu_torch.runtime import trace

    trace.enable()
    api.process_fits_full(path, out_dir)
    got = trace.drain()          # the spans and counts so far; emptied
    trace.disable()

    for s in got.spans:          # Span(id, name, start_ns, end_ns, ...)
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms")
    print(got.counters)          # {"io.png.raw_bytes": ..., ...}

- A span is ``with trace.span(name):``. Its record, kept when it
  closes, is ``Span(id, name, start_ns, end_ns, parent, request,
  thread)``: ``parent`` is the ``id`` of the span open on the same
  thread when it opened (each thread keeps its own stack), or -1; a
  span opened with none open starts a new ``request``, which every span
  under it shares. A span's self time is its length less its
  children's (they nest on one thread, so they do not overlap).
- ``trace.count(name, n)`` adds ``n`` to a named integer counter. Each
  call is kept as ``Count(name, n, t_ns, request)``, so a reader can
  take the part of a counter inside a time window; ``drain`` also sums
  them by name in ``counters``.
- The clock is ``time.time_ns()`` (CLOCK_REALTIME nanoseconds), the
  clock ``torch.profiler`` stamps its events with; kineto maps the
  card's CUPTI timestamps onto it. A span can therefore be set directly
  against the device intervals of a profiler trace taken in the same
  process.
- No span synchronizes the device or opens a profiler range: a span
  times the host. What the card did inside it comes from the device
  trace.
- Off, ``span`` tests one module global and returns one shared no-op
  object, and ``count`` tests the same global and returns: no clock
  read, no allocation, no lock.
- Records stay in memory until drained: at most ``MAX_RECORDS`` spans
  and counts together; past that they are dropped and counted in the
  counter ``trace.dropped``. There is no environment variable, no file
  and no thread.

The spans and counters, from the entry points down:

==================================  ========================================
Name                                Where
==================================  ========================================
``api.process_fits_full``           the body of ``api.io.process_fits_full``
``pipeline.align_stack_stretch``    the body of
                                    ``parallel.pipeline.align_stack_stretch``
``stacking.drizzle_stack``          the body of
                                    ``stacking.drizzle.drizzle_stack``
``api.process_cube``                the body of ``api.cube.process_cube_cmd``
``api.compose_rgb``                 the body of ``api.compose.compose_rgb_cmd``
``api.masked_stretch_composite``    the body of ``api.processing.
                                    masked_stretch_composite_cmd``
``stretch.masked.mask``             ``imaging.masked_stretch``: the star
                                    mask (the luminance in the shared
                                    form, detection with K10 and K11, the
                                    dedupe, the paint with K13, the
                                    protection, one fetch of the counts);
                                    counters ``stretch.masked.candidates``
                                    (the detection's peaks) and
                                    ``stretch.masked.stars`` (the stars
                                    painted)
``stretch.masked.mtf``              there: the MTF loops under the mask
                                    (one, or the shared mask's three);
                                    counters ``stretch.masked.iterations``
                                    (each loop's ``iterations_run``),
                                    ``stretch.masked.loops`` (one a loop)
                                    and ``stretch.masked.ran_out`` (the
                                    loops that used every iteration
                                    without stopping on their test)
``stretch.masked.preview``          in ``masked_stretch_composite_cmd``:
                                    the RGB preview's u8, fetch and PNG
``compose.harmonize``               in ``compose.rgb.process_rgb``: the
                                    bicubic resample of channels to the
                                    largest dimensions
``compose.align``                   in ``process_rgb``: G and B aligned to
                                    the reference (``align_rgb_channels``)
``compose.color``                   in ``process_rgb``: the six stats,
                                    white balance, STF and SCNR
``compose.preview``                 in ``compose_rgb_cmd``: the RGB
                                    preview's u8, fetch and PNG
``alignment.affine.detect``         ``alignment.fused_chain._detect_device``:
                                    normalize, detect (K10, K11), dedupe
``alignment.affine.match``          in the fused chain: the triangles, the
                                    vote (K12), the greedy match, both
                                    RANSACs, and the one info fetch that
                                    waits for them; counters
                                    ``alignment.affine.star`` (1 a target
                                    aligned by stars),
                                    ``alignment.affine.fallback`` (1 a
                                    target sent to the phase-correlation
                                    fallback) and
                                    ``alignment.affine.inliers`` (the
                                    inliers), read from the fetched info
``alignment.affine.warp``           the fused chain's direct warp
``cube.load``                       ``io.prefetch.load_cube``: the cube's
                                    decode and upload; counter
                                    ``cube.load_bytes``: the f32 bytes put
                                    on the device
``cube.stats``                      in ``process_cube_cmd``: the global
                                    stats (``compute_global_stats``);
                                    counters ``cube.stats.radix_select``
                                    (1 a call that launched the radix
                                    select, ``csrc/radix_select.cu``) and
                                    ``cube.stats.plain`` (1 a call on a
                                    CUDA cube, inside
                                    ``kernels.plain_versions``, that ran
                                    the plain sorts and bisection; the
                                    CPU runs them uncounted), counted in
                                    ``compute_global_stats``, so also for
                                    the lazy command's mean image and
                                    ``get_cube_frame``, outside this span
``cube.collapse``                   there: the mean and median collapses
``cube.previews``                   there: the normalizations, fetches and
                                    PNGs of the collapses and the frames
``io.decode``                       the host codec's decode of FITS pixels
                                    (``io.fits_reader.decode_pixels``);
                                    counter ``io.decode_bytes``: the f32
                                    bytes it wrote
``io.upload``                       a loaded plane's copy to the device
                                    (``io.prefetch.DeviceLoader``)
``io.fetch``                        a preview's copy to the host, where
                                    the host waits for the card
                                    (``api.helpers``)
``io.png.scanlines``                the filter-byte scanlines (``io.png``)
``io.png.deflate``                  the deflate of them (row bands on a
                                    pool when more than one); counters
                                    ``io.png.raw_bytes`` (bytes in),
                                    ``io.png.out_bytes`` (bytes out) and
                                    ``io.png.bands`` (its bands, 1 for
                                    one ``zlib.compress``)
``io.write``                        a PNG or mono FITS file written
                                    (``io.png._save``,
                                    ``io.fits_writer.write_fits_mono``)
``stats.core``                      ``ops.stats.stats_core`` (two sorts,
                                    median, MAD), ``compute_image_stats``
``stats.stf``                       the auto-STF and its u8 apply
                                    (``align_stack_stretch``,
                                    ``api.helpers.save_stf_preview_png``)
``stats.histogram``                 the display histogram of
                                    ``process_fits_full``
``alignment.phase_corr``            the body of ``alignment.phase_correlation.
                                    phase_correlate_stack``; counters
                                    ``alignment.phase_corr.graph_replay``
                                    (1 a call that replayed its CUDA
                                    graphs, the capturing call too),
                                    ``alignment.phase_corr.graph_capture``
                                    (1 a capture of a key's two graphs)
                                    and ``alignment.phase_corr.eager`` (1
                                    a call on a CUDA stack, outside
                                    ``kernels.plain_versions``, that ran
                                    eagerly)
``alignment.coarse``                its coarse surfaces (kernel K1); only
                                    on an eager call, as the two below
``alignment.correlate``             each ``correlate_single`` (cuFFT and
                                    the peak)
``alignment.crops``                 its refine crops (kernel K2)
``stacking.shift_clip``             ``stacking.onepass_kernel.
                                    shift_clip_onepass`` (kernel K3)
``stacking.drizzle``                the body of ``stacking.drizzle.
                                    _drizzle_kernel_exact``; counter
                                    ``stacking.drizzle.bands`` (its bands)
``stacking.drizzle.taps``           its batched tap pass
``stacking.drizzle.gather``         its one ``drizzle_gather_banded``
``trace.dropped``                   counter: records past ``MAX_RECORDS``
==================================  ========================================
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple

MAX_RECORDS = 2_000_000


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int     # id of the enclosing span on the thread, or -1
    request: int    # shared by every span under one root span
    thread: int     # threading.get_ident() of the thread it ran on


class Count(NamedTuple):
    name: str
    n: int
    t_ns: int
    request: int    # the request of the span open then, or -1


class Drained(NamedTuple):
    spans: List[Span]
    counts: List[Count]
    counters: Dict[str, int]   # the counts summed by name


_on = False
_spans: List[Span] = []
_counts: List[Count] = []
_dropped = 0
_lock = threading.Lock()        # guards _dropped and the swap in drain
_ids = itertools.count()
_requests = itertools.count()
_local = threading.local()


class _NoSpan:
    """What ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(records: list, record) -> None:
    global _dropped
    if len(_spans) + len(_counts) < MAX_RECORDS:
        records.append(record)
    else:
        with _lock:
            _dropped += 1


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = -1, next(_requests)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _keep(_spans, Span(self.id, self.name, self.start_ns, end,
                           self.parent, self.request, threading.get_ident()))
        return False


def span(name: str):
    """A context manager that records ``name`` from entry to exit while
    tracing is on; the shared no-op while it is off."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    _keep(_counts, Count(name, int(n), time.time_ns(),
                         stack[-1].request if stack else -1))


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> Drained:
    """The spans (by start) and counts kept so far, and the counters;
    the recorder is emptied. Spans still open are kept when they
    close."""
    global _spans, _counts, _dropped
    with _lock:
        spans, counts, dropped = _spans, _counts, _dropped
        _spans, _counts, _dropped = [], [], 0
    counters: Dict[str, int] = {}
    for c in counts:
        counters[c.name] = counters.get(c.name, 0) + c.n
    if dropped:
        counters["trace.dropped"] = dropped
    return Drained(sorted(spans, key=lambda s: (s.start_ns, s.id)), counts,
                   counters)
