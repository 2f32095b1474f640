"""Align + stack + stretch, on one device and sharded over a mesh
(counterpart of astroburst_tpu/parallel/pipeline.py).

N raw frames [N, H, W] → phase-correlation alignment to frame 0
(kernels K1 + K2 and cuFFT) → fused bicubic shift + per-pixel sigma
clip (kernel K3) → robust stats → auto-STF → u8 stretch. Every step
stays on the device; nothing waits on the host. The TPU switches of
the JAX function (``use_pallas``, ``true_shape``, ``off_max``,
``interpret``) have no counterpart: the stack is unpadded and the
shift is not clamped.

The sharded step (``make_sharded_stack_step``) runs the same pipeline
over a ``parallel/mesh.Mesh`` of (frames, rows): each frame shard
aligns its frames against frame 0 (broadcast), one all-to-all takes
frames to rows (``sharded_shift_clip_a2a``), K3's slab entry clips
each row shard after a halo exchange, and the stats come from
reductions only: min and max by ``pmin``/``pmax``, the median and MAD
exact by a bisection over f32 keys with ``psum``med counts
(``sharded_select``, the form of ``ops/select.py``). No plane is
gathered: the results come back per shard. The halo is
ceil(max |dy|) + 2 rows (``onepass_kernel.slab_halo``), from one host
fetch of the offsets, where the TPU used its clamp's off_max + 2.
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.alignment.phase_correlation import (
    phase_correlate_stack)
from astroburst_tpu_torch.imaging.stf import apply_stf_traced, auto_stf_traced
from astroburst_tpu_torch.ops.masking import validity_mask
from astroburst_tpu_torch.ops.select import (KEY_MAX, KEY_MIN, ROUNDS,
                                             key_to_f32, sorted_rows)
from astroburst_tpu_torch.ops.stats import stats_core
from astroburst_tpu_torch.parallel.halo import exchange_row_halos
from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, as_sharded,
                                                on_shards)
from astroburst_tpu_torch.runtime import trace
from astroburst_tpu_torch.stacking.onepass_kernel import (
    shift_clip_onepass, shift_clip_onepass_slab, slab_halo)


def align_stack_stretch(stack: torch.Tensor, sigma_low: float = 3.0,
                        sigma_high: float = 3.0, max_iter: int = 5,
                        align: bool = True,
                        exact_pair: bool = False) -> dict:
    """Run the pipeline over a contiguous f32 [N, H, W] stack.

    Returns a dict of tensors on the stack's device: combined f32
    [H, W], preview u8 [H, W], offsets [N, 2] f32 (frame 0 is the
    reference, offset 0), confidences [N] f32, rejected (0-d int64),
    stf (shadow, midtone) f32 [2], data_range (min, max) f32 [2].
    """
    with trace.span("pipeline.align_stack_stretch"):
        n = stack.shape[0]
        zeros = torch.zeros(n, dtype=torch.float32, device=stack.device)
        if align and n > 1:
            dys1, dxs1, confs1 = phase_correlate_stack(stack[0], stack[1:])
            dys = torch.cat([zeros[:1], dys1])
            dxs = torch.cat([zeros[:1], dxs1])
            confs = torch.cat([zeros[:1], confs1])
        else:
            dys = dxs = confs = zeros

        combined, rejected = shift_clip_onepass(stack, dys, dxs, sigma_low,
                                                sigma_high, max_iter)
        mn, mx, _total, count, med, mad = stats_core(combined, exact_pair)
        with trace.span("stats.stf"):
            sigma = torch.clamp(mad * 1.4826, min=1e-30)
            shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
            preview = apply_stf_traced(combined, mn, mx, shadow, midtone,
                                       as_u8=True)
        return {
            "combined": combined,
            "preview": preview,
            "offsets": torch.stack([dys, dxs], dim=1),
            "confidences": confs,
            "rejected": rejected,
            "stf": torch.stack([shadow, midtone]),
            "data_range": torch.stack([mn, mx]),
        }


# ---- sharded statistics --------------------------------------------------


def sharded_select(mesh: Mesh, rows, ks, axes) -> list:
    """The 0-based rank-``ks`` values ([R] int64, the same on every
    shard) of the values below +inf of all shards' ``rows`` (each a
    ``ops/select.sorted_rows``), bit for bit as one sort of them all
    would give them: 32 rounds of a key bisection whose counts are
    ``psum``med over ``axes``. A zero comes back as +0.0. One result a
    shard, on its device."""
    lo = [torch.full(k.shape, KEY_MIN, dtype=torch.int64, device=k.device)
          for k in ks]
    hi = [torch.full(k.shape, KEY_MAX, dtype=torch.int64, device=k.device)
          for k in ks]
    for _ in range(ROUNDS):
        mid = [torch.div(a + b, 2, rounding_mode="floor")
               for a, b in zip(lo, hi)]

        def count(i, r, m):
            v = key_to_f32(m)[None, :].expand(r.shape[0], -1)
            return torch.searchsorted(r, v.contiguous(), right=True).sum(0)

        total = mesh.psum(on_shards(mesh, count, rows, mid), axes)
        left = [c > k for c, k in zip(total, ks)]
        lo = [torch.where(t, a, torch.minimum(m + 1, b))
              for t, a, m, b in zip(left, lo, mid, hi)]
        hi = [torch.where(t, m, b) for t, m, b in zip(left, mid, hi)]
    out = []
    for a in lo:
        v = key_to_f32(a)
        out.append(torch.where(v == 0.0, 0.0, v))
    return out


def _median_ranks(count: torch.Tensor, exact_pair: bool) -> torch.Tensor:
    """0-based ranks of ``ops/stats._rank_median``: ceil(n/2) (1-based),
    or the pair floor((n+1)/2) and floor(n/2) + 1."""
    r1 = torch.clamp(torch.div(count + 1, 2, rounding_mode="floor") - 1,
                     min=0)
    if not exact_pair:
        return r1[None]
    return torch.stack([r1, torch.div(count, 2, rounding_mode="floor")])


def _rank_value(v: torch.Tensor, count: torch.Tensor, exact_pair: bool):
    med = (v[0] + v[1]) * 0.5 if exact_pair else v[0]
    return torch.where(count > 0, med, torch.zeros_like(med))


def _extreme(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` of a 1-D tensor whose masked entries hold its identity
    (±inf); that identity for an empty shard."""
    if x.numel() == 0:
        ident = float("inf") if fn is torch.amin else float("-inf")
        return torch.full((), ident, dtype=x.dtype, device=x.device)
    return fn(x)


def sharded_stats_core(mesh: Mesh, parts, axes, exact_pair: bool):
    """``ops/stats.stats_core`` over a plane split over ``axes`` (the
    valid pixels of every shard's part): lists of (min, max, sum,
    count, median, mad), one 0-d tensor a shard. min, max and count
    are exact reductions; the median and MAD the same order statistics
    as the single-device sort (``sharded_select``); the sum adds the
    shards' sums in the mesh's order."""
    flats = [p.reshape(-1) for p in parts]
    masks = on_shards(mesh, lambda i, f: validity_mask(f), flats)
    inf = float("inf")
    count = mesh.psum(on_shards(mesh, lambda i, m: m.sum(), masks), axes)
    total = mesh.psum(on_shards(
        mesh, lambda i, f, m: torch.where(m, f, 0.0).sum(), flats, masks),
        axes)
    mn = mesh.pmin(on_shards(
        mesh, lambda i, f, m: _extreme(torch.where(m, f, inf), torch.amin),
        flats, masks), axes)
    mx = mesh.pmax(on_shards(
        mesh, lambda i, f, m: _extreme(torch.where(m, f, -inf), torch.amax),
        flats, masks), axes)
    ranks = on_shards(mesh, lambda i, c: _median_ranks(c, exact_pair),
                      count)
    vals = on_shards(mesh, lambda i, f, m: sorted_rows(
        torch.where(m, f, inf), lambda x: x), flats, masks)
    med = on_shards(mesh, lambda i, v, c: _rank_value(v, c, exact_pair),
                    sharded_select(mesh, vals, ranks, axes), count)
    devs = on_shards(mesh, lambda i, f, m, md: sorted_rows(
        torch.where(m, torch.abs(f - md), inf), lambda x: x),
        flats, masks, med)
    mad = on_shards(mesh, lambda i, v, c: _rank_value(v, c, exact_pair),
                    sharded_select(mesh, devs, ranks, axes), count)
    return mn, mx, total, count, med, mad


# ---- the sharded shift + clip --------------------------------------------


def _host_offsets(dys, dxs, n: int):
    """The offsets as f32 host tensors [n], in one fetch."""
    both = torch.stack([torch.as_tensor(d, dtype=torch.float32).reshape(n)
                        for d in (dys, dxs)]).cpu()
    return both[0], both[1]


def _halo_clip_local(mesh: Mesh, slabs, dys, dxs, axes, local_h: int,
                     h: int, halo: int, sigma_low: float, sigma_high: float,
                     max_iter: int):
    """Per shard: the halo exchange (edge replicas at the image's
    edges), then K3's slab entry on the extended slab; the rejected
    counts ``psum``med. A shard whose block runs past the image (the
    blocks are padded with edge rows) clips only its rows inside it:
    its slab is cut after them and their bottom halo, which are all
    replicas of the last row there. Returns (combined: Sharded rows over
    ``axes``, rejected 0-d int64 on the first shard's device)."""
    ext = exchange_row_halos(mesh, slabs, halo, axes, dim=1)

    def run(i, e):
        g0 = mesh.index(i, axes) * local_h
        rows = max(0, min(local_h, h - g0))
        if rows == 0:
            return e.new_empty((0, e.shape[2])), torch.zeros(
                (), dtype=torch.int64, device=e.device)
        if rows < local_h:
            e = e[:, :rows + 2 * halo].contiguous()
        return shift_clip_onepass_slab(e, dys, dxs, halo, g0, h, sigma_low,
                                       sigma_high, max_iter)

    res = on_shards(mesh, run, ext)
    rejected = mesh.psum([r for _, r in res], axes)
    return Sharded(mesh, [c for c, _ in res], 0, axes, h), rejected[0]


def sharded_shift_clip(mesh: Mesh, stack, dys, dxs, row_axes,
                       sigma_low: float, sigma_high: float, max_iter: int):
    """Row-sharded shift + clip: each shard holds a band of rows of
    every frame (``stack``: a tensor, placed here in equal bands with
    edge rows past the image, or a Sharded of rows split over
    ``row_axes``), gets ceil(max |dy|) + 2 halo rows from its
    neighbours, and runs K3's slab entry with the outside-source mask
    in global rows. ``row_axes``: an axis name or a tuple (all axes
    split the rows over the whole mesh). Returns (combined: Sharded
    rows, rejected 0-d int64)."""
    row_axes = mesh.axes(row_axes)
    slabs = as_sharded(mesh, stack, 1, row_axes, pad_edge=True)
    n = slabs.parts[0].shape[0]
    dy, dx = _host_offsets(dys, dxs, n)
    halo = slab_halo(dy)
    local_h = slabs.parts[0].shape[1]
    return _halo_clip_local(mesh, slabs.parts, dy, dx, row_axes, local_h,
                            slabs.length, halo, sigma_low, sigma_high,
                            max_iter)


def _frames_to_rows(mesh: Mesh, parts, frames_axis: str, rows_axis: str,
                    n: int, local_h: int) -> list:
    """The explicit frames→rows reshard (one ``all_to_all`` over the
    frames axis): shard (f, r) enters with its frame block [n/F, F·R·
    local_h, W], keeps its r-th share of each row block and sends the
    rest, and leaves with all n frames of row block f·R + r."""
    f_sz, r_sz = mesh.shape[frames_axis], mesh.shape[rows_axis]

    def pick(i, x):
        r = mesh.index(i, rows_axis)
        y = x.reshape(x.shape[0], f_sz, r_sz, local_h, x.shape[2])
        return y[:, :, r]

    moved = mesh.all_to_all(on_shards(mesh, pick, parts), frames_axis,
                            split_dim=1, concat_dim=0)
    return on_shards(mesh, lambda i, y: y.reshape(n, local_h, y.shape[-1]),
                     moved)


def reshard_frames_to_rows(mesh: Mesh, x, frames_axis: str,
                           rows_axis: str) -> Sharded:
    """[n, H, W] split over frames → split over (frames, rows) along H,
    with one ``all_to_all`` over the frames axis. Needs n % |frames| ==
    0 and H % (|frames|·|rows|) == 0."""
    xs = as_sharded(mesh, x, 0, frames_axis)
    f_sz, r_sz = mesh.shape[frames_axis], mesh.shape[rows_axis]
    n_sh = f_sz * r_sz
    n = sum(b.shape[0] for b in xs.blocks())
    h = xs.parts[0].shape[1]
    if n % f_sz or h % n_sh:
        raise ValueError(f"reshard needs n % {f_sz} == 0 and h % {n_sh} "
                         f"== 0; got n={n}, h={h}")
    parts = _frames_to_rows(mesh, xs.parts, frames_axis, rows_axis, n,
                            h // n_sh)
    return Sharded(mesh, parts, 1, (frames_axis, rows_axis), h)


def sharded_shift_clip_a2a(mesh: Mesh, stack, dys, dxs, frames_axis: str,
                           rows_axis: str, sigma_low: float,
                           sigma_high: float, max_iter: int):
    """Row-sharded shift + clip taking a FRAMES-sharded stack: each
    frame block is padded to F·R equal row bands (edge rows), one
    ``all_to_all`` over the frames axis gives shard (f, r) all frames
    of band f·R + r, then the halo exchange and K3's slab entry as in
    ``sharded_shift_clip``. Returns (combined: Sharded rows over
    (frames, rows), rejected 0-d int64)."""
    xs = as_sharded(mesh, stack, 0, frames_axis)
    f_sz, r_sz = mesh.shape[frames_axis], mesh.shape[rows_axis]
    n_sh = f_sz * r_sz
    n = sum(b.shape[0] for b in xs.blocks())
    if n % f_sz:
        raise ValueError(f"{n} frames not divisible by the {f_sz}-way "
                         f"'{frames_axis}' axis; use sharded_shift_clip")
    h = xs.parts[0].shape[1]
    local_h = -(-h // n_sh)
    idx = torch.clamp(torch.arange(local_h * n_sh), max=h - 1)
    padded = xs.parts if local_h * n_sh == h else on_shards(
        mesh, lambda i, x: x.index_select(1, idx.to(x.device)), xs.parts)
    slabs = _frames_to_rows(mesh, padded, frames_axis, rows_axis, n,
                            local_h)
    dy, dx = _host_offsets(dys, dxs, n)
    return _halo_clip_local(mesh, slabs, dy, dx, (frames_axis, rows_axis),
                            local_h, h, slab_halo(dy), sigma_low,
                            sigma_high, max_iter)


def _gather_offsets(mesh: Mesh, per_shard, n: int) -> torch.Tensor:
    """[3, n] (dys, dxs, confidences) from the shards' own frames: each
    shard fills its columns, the rest -0.0, and a ``psum`` over the
    whole mesh adds them (x + -0.0 is x for every x, -0.0 included)."""
    def fill(i, item):
        dev = mesh.device(i)
        out = torch.full((3, n), -0.0, dtype=torch.float32, device=dev)
        if item is not None:
            cols, vals = item
            out[:, cols] = vals
        return out

    return mesh.psum(on_shards(mesh, fill, per_shard), mesh.axis_names)


def make_sharded_stack_step(mesh: Mesh, sigma_low: float = 3.0,
                            sigma_high: float = 3.0, max_iter: int = 5,
                            align: bool = True):
    """The pipeline over a (frames, rows) mesh: ``step(stack)`` for a
    [N, H, W] tensor (or a Sharded of frames split over "frames").

    Alignment runs frame-sharded: frame 0 is broadcast, and the R
    shards of each frame block align its frames in R parts
    (``phase_correlate_stack``: K1, K2). With both axes and N divisible
    by |frames| one all-to-all takes frames to rows
    (``sharded_shift_clip_a2a``); otherwise the rows split over all
    axes from the stack itself (``sharded_shift_clip``), as the JAX
    package falls back. K3's slab entry clips each row shard; the
    stats, the auto-STF and the u8 STF run per shard on reductions.
    Returns a dict: combined and preview (Sharded rows), offsets [N, 2],
    confidences [N], rejected (0-d int64), stf [2] on the first shard's
    device.
    """
    all_axes = tuple(ax for ax in ("frames", "rows")
                     if ax in mesh.axis_names)
    two_axes = len(all_axes) == 2

    def step(stack) -> dict:
        frames = as_sharded(mesh, stack, 0, "frames")
        blocks = frames.blocks()
        n = sum(b.shape[0] for b in blocks)
        starts = [0]
        for b in blocks[:-1]:
            starts.append(starts[-1] + b.shape[0])
        if align and n > 1:
            ref = mesh.broadcast(blocks[0][0])
            r_sz = mesh.shape["rows"] if two_axes else 1

            def est(i, part, ref_i):
                f = mesh.index(i, "frames")
                r = mesh.index(i, "rows") if two_axes else 0
                k0 = starts[f]
                ids = torch.tensor_split(torch.arange(part.shape[0]),
                                         r_sz)[r]
                ids = ids[ids + k0 > 0]     # frame 0 is the reference
                if ids.numel() == 0:
                    return None
                t = part[int(ids[0]):int(ids[-1]) + 1]
                d = phase_correlate_stack(ref_i, t)
                return (ids + k0).to(part.device), torch.stack(d)

            off = _gather_offsets(mesh, on_shards(mesh, est, frames.parts,
                                                  ref), n)
            for o in off:       # each shard's own copy
                o[:, 0] = 0.0   # frame 0, the reference
        else:
            off = [torch.zeros((3, n), dtype=torch.float32,
                               device=mesh.device(i))
                   for i in range(mesh.size)]
        dys, dxs = off[0][0], off[0][1]
        if two_axes and n % mesh.shape["frames"] == 0:
            combined, rejected = sharded_shift_clip_a2a(
                mesh, frames, dys, dxs, "frames", "rows", sigma_low,
                sigma_high, max_iter)
        else:
            combined, rejected = sharded_shift_clip(
                mesh, stack if isinstance(stack, torch.Tensor)
                else frames.full(), dys, dxs, all_axes, sigma_low,
                sigma_high, max_iter)
        axes = combined.axes
        mn, mx, _total, count, med, mad = sharded_stats_core(
            mesh, combined.parts, axes, False)

        def stf(i, mn_i, mx_i, med_i, mad_i, cnt_i):
            sigma = torch.clamp(mad_i * 1.4826, min=1e-30)
            return torch.stack(auto_stf_traced(mn_i, mx_i, med_i, sigma,
                                               cnt_i))

        params = on_shards(mesh, stf, mn, mx, med, mad, count)
        preview = on_shards(mesh, lambda i, c, a, b, p: apply_stf_traced(
            c, a, b, p[0], p[1], as_u8=True), combined.parts, mn, mx,
            params)
        return {
            "combined": combined,
            "preview": Sharded(mesh, preview, 0, axes, combined.length),
            "offsets": torch.stack([dys, dxs], dim=1),
            "confidences": off[0][2],
            "rejected": rejected,
            "stf": params[0],
        }

    return step
