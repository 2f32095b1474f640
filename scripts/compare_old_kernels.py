#!/usr/bin/env python3
"""K3 (shift + clip), K7/K8 (drizzle finalize), K12 (triangle vote), K13
(star mask), K11 (window statistics) and K2 (refine crops) against an
earlier version of their CUDA sources, on one CUDA card.

    python3 scripts/compare_old_kernels.py --extract 86459f3  # git checkout
    python3 scripts/compare_old_kernels.py [--old build/old_kernels]
                                           [--kernels k3,k7,k12,k13,k11,k2]

``--extract REV`` writes ``csrc/shift_clip.cu``, ``csrc/drizzle_finalize.cu``,
``csrc/drizzle_finalize.cuh``, ``csrc/triangle_vote.cu``,
``csrc/star_mask.cu``, ``csrc/window_stats.cu`` and
``csrc/gather_crops.cu`` (and ``csrc/reg_select.cuh`` where REV has it) of
commit REV into the git-ignored ``build/old_kernels/src`` (it needs git,
so run it where the history is, then carry the directory with the
checkout). ``--old DIR`` takes the sources from ``DIR/src`` instead,
which also serves to hold a changed copy of the current sources against
them (a design to measure; ``DIR/src/REVISION`` names it). Without
``--extract``, the script builds those sources with nvcc into their own
library (``DIR/``, printing each kernel's registers, stack and spills),
builds the current sources through runtime/kernels.py, and runs both on
the same inputs, for the kernels ``--kernels`` names (all by default):

- K3 on the bench workload (16 x 5655 x 2206, offsets +-12 and zero),
  24 x 2048^2 with offsets +-200, and on quantised edge stacks of
  300 x 400 (ties, +-0, NaN, +-inf; integer and quarter-pixel offsets
  up to +-30) at 1..32 frames (every register instance), 48 and 100
  frames (the shared instance; PR 5's kernel stops at 128 frames) and,
  where the other sources take any frame count (the current entry
  point's arguments), 150 frames (the scratch instance);
- K7 at a 1024-row and a 64-row band of the drizzle bench (10 x 4096^2
  → 8192^2, 40 candidates), and K7 and K8 on quantised edge stacks of
  40 x 72 → 80 x 144 at depths 4..32, 40, 200 (every register and
  shared instance) and 300 (the global scratch);
- K12 on chip_smoke.py's 60-star triangle lists and on every
  ``vote_cases`` set (34 304 rows); the all-pairs entry of 50d146b is
  called as its wrapper called it (a zeroed table, the launch);
- K13 on the masked stretch's records of chip_smoke.py's 4096^2 field,
  on 4096 synthetic slots and on every ``star_mask_cases`` set; the
  entry of 50d146b gets its wrapper's torch binning (``old_bins``);
- K11 on the peaks of chip_smoke.py's two detection fields (4096^2,
  5655 x 2206) and on every ``window_cases`` set; the entry of 86459f3
  gets its wrapper's stack and cast (``old_window_stats``);
- K2 on the bench crops (15 x 512^2, int64 refine origins) and on every
  ``crop_cases`` set; the entry of 86459f3 gets its wrapper's int32
  casts (``old_crops``).

Each pair must agree bit for bit up to the sign of a zero (every plane:
image, rejected map, and K7's weight map; K12's votes exactly; K11's
npix exactly and its moments within rtol 1e-4 / atol 1e-3, as the sums
run in another order); the script fails otherwise. Then it times the
two versions in turns (old, new, new, old) with CUDA events — K3 and K7
at the bench shapes, K12 at the 60-star lists and where every r0 is
equal, K13 on the field's records and the synthetic slots, K12 and K13
each with its wrapper's work, K11 on the 4096^2 field and K2 on the
bench crops each with its wrapper's work, its C entry alone and its
device time (torch.profiler) — and prints the card's name and power
limit and one JSON line of the results. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = ("shift_clip.cu", "drizzle_finalize.cu", "drizzle_finalize.cuh",
           "reg_select.cuh", "triangle_vote.cu", "star_mask.cu",
           "window_stats.cu", "gather_crops.cu")
KERNELS = ("k3", "k7", "k12", "k13", "k11", "k2")
CSRC = "astroburst_tpu_torch/csrc"


def extract(rev: str, old_dir: Path) -> None:
    src = old_dir / "src"
    src.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        got = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                             cwd=ROOT, capture_output=True, text=True)
        if got.returncode != 0 and name.endswith(".cuh") and \
                name != "drizzle_finalize.cuh":
            continue   # a helper header that REV does not have yet
        got.check_returncode()
        (src / name).write_text(got.stdout)
    (src / "REVISION").write_text(rev + "\n")
    print(f"wrote {', '.join(SOURCES)} of {rev} into {src}")


def current_abi(old_dir: Path) -> bool:
    """Whether the other K3 takes the current entry point's arguments
    (the instance, the band and the scratch) rather than PR 5's."""
    return "int cap, int by" in (old_dir / "src" / "shift_clip.cu").read_text()


def slab_abi(old_dir: Path) -> bool:
    """Whether the other K3 also takes the slab entry's row offset,
    global first row and global height (the current entry point)."""
    return "int out_off" in (old_dir / "src" / "shift_clip.cu").read_text()


def binned_abi(old_dir: Path, name: str) -> bool:
    """Whether the other K12 or K13 has the entry of 50d146b: the
    all-pairs vote (split over blockIdx.y, no scratch) or the raster fed
    by a torch binning."""
    text = (old_dir / "src" / name).read_text()
    return "int split, int* votes" in text or "const int* order" in text


def old_vote(old, old_dir, va, dev):
    """The other K12 on [ref_ratios, ref_verts, tgt_ratios, tgt_verts]:
    a zeroed table and the launch, as the wrapper of 50d146b made them,
    or the current entry's scratch and launch."""
    import torch
    from astroburst_tpu_torch.alignment import vote_kernel as VK
    from astroburst_tpu_torch.runtime import kernels as K
    t_ref, t_tgt = va[0].shape[0], va[2].shape[0]
    if binned_abi(old_dir, "triangle_vote.cu"):
        votes = torch.zeros((64, 64), dtype=torch.int32, device=dev)
        st = old.abt_triangle_vote(
            va[0].data_ptr(), va[1].data_ptr(), t_ref, va[2].data_ptr(),
            va[3].data_ptr(), t_tgt, VK.TRIANGLE_TOLERANCE, 4,
            votes.data_ptr(), K.stream_handle(votes))
    else:
        votes = torch.empty((64, 64), dtype=torch.int32, device=dev)
        scratch = torch.empty(4 * (t_ref + t_tgt) + 2 * (VK._BUCKETS + 2),
                              dtype=torch.int32, device=dev)
        st = old.abt_triangle_vote(
            va[0].data_ptr(), va[1].data_ptr(), t_ref, va[2].data_ptr(),
            va[3].data_ptr(), t_tgt, VK.TRIANGLE_TOLERANCE, VK._GRID,
            scratch.data_ptr(), votes.data_ptr(), K.stream_handle(votes))
    if st != 0:
        raise RuntimeError(f"old abt_triangle_vote: CUDA error {st}")
    return votes


def old_bins(xs, ys, radii, h: int, w: int):
    """The wrapper work of K13 at 50d146b (_bin_stars of
    imaging/star_mask_kernel.py there): window anchors, and the star ids
    sorted stably by the 128^2 tile their window meets, with each tile's
    segment."""
    import torch
    from astroburst_tpu_torch.imaging.star_mask_kernel import (HALF, TILE,
                                                               _anchors)
    y0, x0 = _anchors(xs, ys, h, w)
    tiles_y, tiles_x = -(-h // TILE), -(-w // TILE)
    n_tiles = tiles_y * tiles_x
    ty_lo = torch.clamp(y0 - HALF, min=0) // TILE
    ty_hi = torch.clamp(y0 + HALF - 1, max=h - 1) // TILE
    tx_lo = torch.clamp(x0 - HALF, min=0) // TILE
    tx_hi = torch.clamp(x0 + HALF - 1, max=w - 1) // TILE
    sentinel = torch.full_like(ty_lo, n_tiles)
    t00 = ty_lo * tiles_x + tx_lo
    t01 = torch.where(tx_hi > tx_lo, ty_lo * tiles_x + tx_hi, sentinel)
    t10 = torch.where(ty_hi > ty_lo, ty_hi * tiles_x + tx_lo, sentinel)
    t11 = torch.where((tx_hi > tx_lo) & (ty_hi > ty_lo),
                      ty_hi * tiles_x + tx_hi, sentinel)
    tids = torch.where((radii > 0.0)[:, None],
                       torch.stack([t00, t01, t10, t11], dim=1),
                       n_tiles).reshape(-1)
    sorted_tids, order4 = torch.sort(tids, stable=True)
    order = torch.div(order4, 4, rounding_mode="floor").to(torch.int32)
    seg = torch.searchsorted(
        sorted_tids, torch.arange(n_tiles + 1, dtype=sorted_tids.dtype,
                                  device=tids.device)).to(torch.int32)
    return y0, x0, order.contiguous(), seg.contiguous()


def old_mask(old, old_dir, xs, ys, radii, h: int, w: int):
    """The other K13 with its wrapper's work: the binning and launch of
    50d146b, or the current entry's single launch."""
    import torch
    from astroburst_tpu_torch.runtime import kernels as K
    out = torch.empty((h, w), dtype=torch.float32, device=xs.device)
    if binned_abi(old_dir, "star_mask.cu"):
        y0, x0, order, seg = old_bins(xs, ys, radii, h, w)
        st = old.abt_star_mask(xs.data_ptr(), ys.data_ptr(), radii.data_ptr(),
                               y0.data_ptr(), x0.data_ptr(), order.data_ptr(),
                               seg.data_ptr(), 4.0, h, w, out.data_ptr(),
                               K.stream_handle(xs))
    else:
        st = old.abt_star_mask(xs.data_ptr(), ys.data_ptr(), radii.data_ptr(),
                               xs.shape[0], 4.0, h, w, out.data_ptr(),
                               K.stream_handle(xs))
    if st != 0:
        raise RuntimeError(f"old abt_star_mask: CUDA error {st}")
    return out


def in_turns(old_fn, new_fn, reps: int) -> dict:
    """Old, new, new, old, each the mean of ``reps`` calls."""
    from chip_smoke import cuda_ms
    t = [cuda_ms(old_fn, reps), cuda_ms(new_fn, reps),
         cuda_ms(new_fn, reps), cuda_ms(old_fn, reps)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


def compare_k12(old, old_dir, dev, check, times) -> None:
    """K12 old against new: equal votes on chip_smoke's 60-star lists and
    on every ``vote_cases`` set at TRI_CAP rows; the times of the 60-star
    lists and of the all-pairs worst case, each with its wrapper's work."""
    import math
    import torch
    from chip_smoke import vote_cases
    from astroburst_tpu_torch.alignment import affine as AF
    from astroburst_tpu_torch.alignment.vote_kernel import vote
    vrng = np.random.default_rng(23)   # chip_smoke.check_vote's lists
    stars_r = vrng.random((60, 2)) * 4000
    rot = np.array([[math.cos(0.007), -math.sin(0.007)],
                    [math.sin(0.007), math.cos(0.007)]])
    stars_t = stars_r @ rot.T + np.array([3.2, -2.1]) + vrng.normal(
        0, 0.05, (60, 2))
    (rv, rr), (tv, tr) = (AF.build_triangles(x) for x in (stars_r, stars_t))
    sets = {"stars_60": (*AF._pad_tris(rv, rr)[::-1],
                         *AF._pad_tris(tv, tr)[::-1])}
    sets.update(vote_cases(vrng, AF.TRI_CAP))
    for tag, arrs in sets.items():
        va = [torch.from_numpy(a).to(dev) for a in arrs]
        check(f"K12 {tag}", [vote(*va)], [old_vote(old, old_dir, va, dev)])
        if tag in ("stars_60", "all_equal_r0"):
            times[f"k12_{tag}"] = in_turns(
                lambda: old_vote(old, old_dir, va, dev),
                lambda: vote(*va), 20)


def compare_k13(old, old_dir, dev, check, times) -> None:
    """K13 old against new: the same bits on the masked stretch's records
    of chip_smoke's 4096^2 field, on 4096 synthetic slots and on every
    ``star_mask_cases`` set; the times of the first two, each with its
    wrapper's work."""
    import torch
    from chip_smoke import MS_SCALE, star_mask_cases, star_scene
    from astroburst_tpu_torch.analysis import star_detection as SD
    from astroburst_tpu_torch.imaging.masked_stretch import (
        MaskedStretchConfig, _mask_config, _paint_records)
    from astroburst_tpu_torch.imaging.star_mask_kernel import paint_mask
    h = w = 4096
    field = star_scene(h, w, 3000, 21, dev)[0] / MS_SCALE
    packed = SD._detect(field, SD._tile_size(h, w), 5.0, 4096)
    det = _paint_records(packed, _mask_config(MaskedStretchConfig()))[:3]
    srng = np.random.default_rng(26)
    k = 4096
    sets = {"detection": (*det, h, w), "synthetic": (*(
        torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
            srng.uniform(-200, w + 200, k), srng.uniform(-200, h + 200, k),
            np.where(srng.random(k) < 0.1, 0.0, srng.uniform(0, 40, k)))),
        h, w)}
    for tag, (cx, cy, cr, ch, cw) in star_mask_cases(srng, h, w, k).items():
        sets[tag] = (*(torch.as_tensor(a, device=dev) for a in (cx, cy, cr)),
                     ch, cw)
    for tag, (*rec, ch, cw) in sets.items():
        check(f"K13 {tag}", [paint_mask(*rec, 4.0, ch, cw)],
              [old_mask(old, old_dir, *rec, ch, cw)])
        if tag in ("detection", "synthetic"):
            times[f"k13_{tag}"] = in_turns(
                lambda: old_mask(old, old_dir, *rec, ch, cw),
                lambda: paint_mask(*rec, 4.0, ch, cw), 20)


@functools.cache
def crops_abi64(old_dir: Path) -> bool:
    """Whether the other K2 takes int64 origins (the current entry)
    rather than int32 (86459f3)."""
    return "const int* y0s" not in (old_dir / "src" /
                                    "gather_crops.cu").read_text()


def old_window_stats(old, img, pys, pxs, thr, bg_med, n_valid):
    """The other K11 with the work of 86459f3's wrapper: threshold and
    bg_med stacked into one tensor, n_valid cast (two torch ops), the
    output allocated, the launch. Both entries take the same pointers."""
    import torch
    from astroburst_tpu_torch.runtime import kernels as K
    params = torch.stack([thr.to(torch.float32).reshape(()),
                          bg_med.to(torch.float32).reshape(())])
    nv = n_valid.to(torch.int32).reshape(1)
    k = pys.shape[0]
    out = torch.empty((k, 9), device=img.device)
    h, w = img.shape
    st = old.abt_window_stats(img.data_ptr(), h, w, pys.data_ptr(),
                              pxs.data_ptr(), k, nv.data_ptr(),
                              params.data_ptr(), params[1:].data_ptr(),
                              out.data_ptr(), K.stream_handle(img))
    if st != 0:
        raise RuntimeError(f"old abt_window_stats: CUDA error {st}")
    return out


def old_crops(old, old_dir, stack, y0s, x0s, size_r, size_c, frame0):
    """The other K2 with its wrapper's work: 86459f3's casts of both
    origins to int32 (two launches), the output, the launch; or the
    current entry's single launch."""
    import torch
    from astroburst_tpu_torch.runtime import kernels as K
    _, h, w = stack.shape
    n_out = y0s.shape[0]
    out = torch.empty((n_out, size_r, size_c), device=stack.device)
    if not crops_abi64(old_dir):
        y0s, x0s = (a.to(torch.int32).contiguous() for a in (y0s, x0s))
    st = old.abt_gather_crops(stack.data_ptr(), y0s.data_ptr(),
                              x0s.data_ptr(), n_out, h, w, size_r, size_c,
                              frame0, out.data_ptr(), K.stream_handle(stack))
    if st != 0:
        raise RuntimeError(f"old abt_gather_crops: CUDA error {st}")
    return out


def device_in_turns(old_fn, new_fn, kernel: str, reps: int,
                    cold: bool = False) -> dict:
    """Old, new, new, old device times (torch.profiler) of ``kernel``,
    with a cold L2 before each call if ``cold``."""
    from chip_smoke import device_ms
    t = [device_ms(f, reps, kernel, cold)
         for f in (old_fn, new_fn, new_fn, old_fn)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


def compare_k11(old, dev, failures, times) -> None:
    """K11 old against new on the peaks of chip_smoke's two detection
    fields and on every ``window_cases`` set: npix equal, the rest
    within rtol 1e-4 / atol 1e-3 (the moment sums run in another
    order). Times on the 4096^2 field: each with its wrapper's work,
    the C entry alone on preallocated buffers, and the kernel's device
    time."""
    import torch
    from chip_smoke import detection_fields, window_cases
    from astroburst_tpu_torch.analysis import star_detection as SD
    from astroburst_tpu_torch.analysis.window_kernel import window_stats
    from astroburst_tpu_torch.runtime import kernels as K
    sets = {}
    for tag, (img, *_) in zip(("field_4096", "field_5655x2206"),
                              detection_fields(dev)):
        h, w = img.shape
        bg_med, bg_sig = SD._background(img, SD._tile_size(h, w))
        thr = bg_med + 5.0 * bg_sig
        pys, pxs, _, n_valid = SD._peaks(img, thr, SD.MAX_PEAKS)
        sets[tag] = (img, pys, pxs, thr, bg_med, n_valid)
    for tag, (p, pys, pxs, thr, bg, nv) in window_cases(
            np.random.default_rng(27)).items():
        sets[tag] = (torch.as_tensor(p, device=dev),
                     *(torch.as_tensor(a, device=dev) for a in (pys, pxs)),
                     *(torch.tensor(v, dtype=torch.float32, device=dev)
                       for v in (thr, bg)),
                     torch.tensor(nv, dtype=torch.int32, device=dev))
    for tag, a in sets.items():
        got, ref = window_stats(*a), old_window_stats(old, *a)
        ok = bool(torch.equal(got[:, 0], ref[:, 0]) and torch.allclose(
            got, ref, rtol=1e-4, atol=1e-3))
        verdict = "npix equal, moments within rtol 1e-4" if ok \
            else "DIFFERENT"
        print(f"  K11 {tag}: {verdict} (max|d| "
              f"{float((got - ref).abs().max()):.3e})", flush=True)
        if not ok:
            failures.append(f"K11 {tag}")
    a = sets["field_4096"]
    img, pys, pxs, thr, bg_med, n_valid = a
    h, w = img.shape
    out = torch.empty((pys.shape[0], 9), device=dev)

    def launch(lib):
        st = lib.abt_window_stats(img.data_ptr(), h, w, pys.data_ptr(),
                                  pxs.data_ptr(), pys.shape[0],
                                  n_valid.data_ptr(), thr.data_ptr(),
                                  bg_med.data_ptr(), out.data_ptr(),
                                  K.stream_handle(img))
        if st != 0:
            raise RuntimeError(f"abt_window_stats: CUDA error {st}")

    new = K.library().lib
    times["k11_wrapper"] = in_turns(lambda: old_window_stats(old, *a),
                                    lambda: window_stats(*a), 50)
    times["k11_launch_alone"] = in_turns(lambda: launch(old),
                                         lambda: launch(new), 50)
    for tag, cold in (("k11_device", False), ("k11_device_cold", True)):
        times[tag] = device_in_turns(lambda: launch(old), lambda: launch(new),
                                     "window_stats_kernel", 20, cold)


def compare_k2(old, old_dir, dev, check, times) -> None:
    """K2 old against new, bit-equal: the bench crops (15 x 512^2 from
    frames 1.. of chip_smoke's bench stack at the refine origins, int64
    as _refine_origin gives them) and every ``crop_cases`` set (with
    frame0 1 also from the view of frames 1..). Times on the bench
    crops: each with its wrapper's work, the C entry alone on
    preallocated buffers, and the kernel's device time."""
    import torch
    from chip_smoke import (H, N_FRAMES, W, bench_shifts, crop_cases,
                            make_frames)
    from astroburst_tpu_torch.alignment.phase_correlation import (
        REFINE_CROP_SIZE, _refine_origin)
    from astroburst_tpu_torch.ops.crop_kernel import gather_crops
    from astroburst_tpu_torch.runtime import kernels as K
    stack = torch.as_tensor(make_frames(N_FRAMES, H, W), device=dev)
    shifts = bench_shifts(N_FRAMES, H, W)
    cy = torch.as_tensor(H // 2 + shifts[1:, 0], device=dev)
    cx = torch.as_tensor(W // 2 + shifts[1:, 1], device=dev)
    y0s, x0s = _refine_origin(cy, cx, H, W, REFINE_CROP_SIZE)
    bench = (stack, y0s, x0s, 512, 512, 1)
    check("K2 bench crops 15 x 512^2", [gather_crops(*bench)],
          [old_crops(old, old_dir, *bench)])
    for tag, (s, cy0, cx0, size_r, size_c, frame0) in crop_cases(
            np.random.default_rng(28)).items():
        st = torch.as_tensor(s, device=dev)
        yo, xo = (torch.as_tensor(a, device=dev) for a in (cy0, cx0))
        for src, f0 in ((st, frame0),) + (((st[1:], 0),) if frame0 else ()):
            args = (src, yo, xo, size_r, size_c, f0)
            check(f"K2 {tag}{' (view)' if src is not st else ''}",
                  [gather_crops(*args)], [old_crops(old, old_dir, *args)])
    n_out = N_FRAMES - 1
    out = torch.empty((n_out, 512, 512), device=dev)
    y32, x32 = (a.to(torch.int32) for a in (y0s, x0s))
    abi64 = crops_abi64(old_dir)

    def launch(lib, cur):
        ya, xa = (y0s, x0s) if cur else (y32, x32)
        st = lib.abt_gather_crops(stack.data_ptr(), ya.data_ptr(),
                                  xa.data_ptr(), n_out, H, W, 512, 512, 1,
                                  out.data_ptr(), K.stream_handle(stack))
        if st != 0:
            raise RuntimeError(f"abt_gather_crops: CUDA error {st}")

    new = K.library().lib
    times["k2_wrapper"] = in_turns(lambda: old_crops(old, old_dir, *bench),
                                   lambda: gather_crops(*bench), 50)
    times["k2_launch_alone"] = in_turns(lambda: launch(old, abi64),
                                        lambda: launch(new, True), 50)
    for tag, cold in (("k2_device", False), ("k2_device_cold", True)):
        times[tag] = device_in_turns(lambda: launch(old, abi64),
                                     lambda: launch(new, True),
                                     "gather_crops_kernel", 20, cold)


def build_old(old_dir: Path):
    """nvcc the old sources (one process per .cu, in parallel) into
    old_dir/libold.so; returns (ctypes library, build log)."""
    from astroburst_tpu_torch.runtime import kernels as K
    src = old_dir / "src"
    cu = [src / n for n in SOURCES
          if n.endswith(".cu") and (src / n).is_file()]
    objs = [old_dir / f"{p.stem}.o" for p in cu]
    procs = [subprocess.Popen([K.nvcc(), *K.NVCC_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(cu, objs)]
    logs = []
    for p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old sources:\n{out}")
    lib_path = old_dir / "libold.so"
    subprocess.run([K.nvcc(), *K.LINK_FLAGS, "-o", str(lib_path),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.abt_shift_clip.argtypes = (
        list(K.SIGNATURES["abt_shift_clip"]) if slab_abi(old_dir) else
        [P, P, P, I, I, I, F, F, I, I, I, I, I, P, P, P, P]
        if current_abi(old_dir) else [P, P, P, I, I, I, F, F, I, P, P, P])
    lib.abt_drizzle_finalize_fused.argtypes = [P, P, P, I, I, I, I, I, I, F,
                                               F, I, P, P, P, P, P]
    lib.abt_drizzle_finalize.argtypes = [P, P, I, I, I, I, F, F, I, P, P, P,
                                         P, P]
    if (src / "triangle_vote.cu").is_file():   # 50d146b's entry or ours
        lib.abt_triangle_vote.argtypes = [P, P, I, P, P, I, F, I, P, P] \
            if binned_abi(old_dir, "triangle_vote.cu") \
            else list(K.SIGNATURES["abt_triangle_vote"])
    if (src / "window_stats.cu").is_file():   # one ABI in both
        lib.abt_window_stats.argtypes = list(K.SIGNATURES["abt_window_stats"])
    if (src / "gather_crops.cu").is_file():   # one ABI in both
        lib.abt_gather_crops.argtypes = list(K.SIGNATURES["abt_gather_crops"])
    if (src / "star_mask.cu").is_file():
        lib.abt_star_mask.argtypes = [P, P, P, P, P, P, P, F, I, I, P, P] \
            if binned_abi(old_dir, "star_mask.cu") \
            else list(K.SIGNATURES["abt_star_mask"])
    return lib, "".join(logs)


def same_bits(a, b) -> bool:
    """Equal bit for bit up to the sign of a zero (NaN equal to NaN)."""
    import torch
    if a.is_floating_point():
        a, b = a + 0.0, b + 0.0   # -0 + 0 = +0
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def edge_stack(rng, n: int, h: int, w: int) -> np.ndarray:
    """Values quantised to 4 (ties in every pixel) with +-0.0, NaN, +inf
    in half the frames of one pixel, -inf, a 5000 outlier, a pixel with
    no finite value and one with a single finite value."""
    e = np.round(rng.normal(100, 8, (n, h, w)) / 4.0).astype(np.float32) * 4
    e[rng.random(e.shape) < 0.03] = 0.0
    e[rng.random(e.shape) < 0.03] = -0.0
    e[rng.random(e.shape) < 0.02] = np.nan
    e[: n // 2, 5, 9] = np.inf
    e[1 % n, 20, 30] = -np.inf
    e[2 % n, 10, 10] = 5000.0
    e[:, 7, 7] = np.nan
    e[:-1, 8, 8] = np.nan
    return e


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=str(ROOT / "build" / "old_kernels"))
    ap.add_argument("--extract", metavar="REV")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="which to compare, of " + ",".join(KERNELS))
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels takes some of {KERNELS}")
    old_dir = Path(args.old)
    if args.extract:
        extract(args.extract, old_dir)
        return

    import torch
    if not torch.cuda.is_available():
        sys.exit("compare_old_kernels: no CUDA device")
    from chip_smoke import (DRZ_BAND, DRZ_BAND64, DRZ_HW, DRZ_N, DRZ_SEED,
                            H, N_FRAMES, W, cuda_ms, make_frames,
                            nvidia_smi_line, ptxas_summary,
                            wide_shift_frames)
    from astroburst_tpu_torch.dtypes import DrizzleKernel
    from astroburst_tpu_torch.runtime import kernels as K
    from astroburst_tpu_torch.runtime.device import cuda_device
    from astroburst_tpu_torch.stacking.drizzle import (
        _frame_candidates_raw, _masked_candidates, _outer)
    from astroburst_tpu_torch.stacking.drizzle_kernel import (
        drizzle_finalize, drizzle_finalize_fused)
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        _clip_plan, shift_clip_maps)

    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    dev = cuda_device()
    rev = (old_dir / "src" / "REVISION").read_text().strip()
    same_abi = current_abi(old_dir)
    t0 = time.perf_counter()
    new_log = K.library().build_log
    old, old_log = build_old(old_dir)
    print(f"[build] new and old ({rev}) libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {}
    for tag, log in (("new", new_log), ("old", old_log)):
        for name, regs, smem, stack_b, sst, sld in ptxas_summary(log):
            if name.startswith(("shift_clip", "drizzle_finalize",
                                "triangle_", "star_mask", "window_stats",
                                "gather_crops")):
                print(f"[build] {tag} {name}: {regs} registers, {smem} B "
                      f"smem, {stack_b} B stack, spills {sst}/{sld} B",
                      flush=True)
                ptxas[f"{tag} {name}"] = [regs, stack_b, sst, sld]

    def k3_old(stack, dys, dxs, lo=3.0, hi=3.0, iters=5):
        n, h, w = stack.shape
        zero = torch.zeros((), device=dev)
        dy = torch.where(dys.abs() < 1e-12, zero, dys).contiguous()
        dx = torch.where(dxs.abs() < 1e-12, zero, dxs).contiguous()
        out = torch.empty((h, w), device=dev)
        rej = torch.empty((h, w), dtype=torch.int32, device=dev)
        if not same_abi:
            st = old.abt_shift_clip(stack.data_ptr(), dy.data_ptr(),
                                    dx.data_ptr(), n, h, w, lo, hi, iters,
                                    out.data_ptr(), rej.data_ptr(),
                                    K.stream_handle(stack))
            if st != 0:
                raise RuntimeError(f"old abt_shift_clip: CUDA error {st}")
            return out, rej
        plan = _clip_plan(n, h, w)
        scratch = torch.empty((n, plan.band_rows, w), device=dev) \
            if plan.instance == "scratch" else None
        slab = (0, 0, h) if slab_abi(old_dir) else ()
        for y0 in range(0, h, plan.band_rows):
            st = old.abt_shift_clip(
                stack.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, h, w, lo,
                hi, iters, plan.cap, plan.block_rows, y0,
                min(plan.band_rows, h - y0), *slab, K.ptr(scratch),
                out.data_ptr(), rej.data_ptr(), K.stream_handle(stack))
            if st != 0:
                raise RuntimeError(f"old abt_shift_clip: CUDA error {st}")
        return out, rej

    def k7_old(cand, wys_t, wxs, n, ty, tx, cap, lo, hi, iters, cand_w=None):
        m, h, w = cand.shape
        depth = min(cap, m)
        scratch = torch.empty((depth, h, w), device=dev) \
            if depth > 256 else None
        img = torch.empty((h, w), device=dev)
        wgt = torch.empty((h, w), device=dev)
        rej = torch.empty((h, w), dtype=torch.int32, device=dev)
        if cand_w is None:
            st = old.abt_drizzle_finalize_fused(
                cand.data_ptr(), wys_t.data_ptr(), wxs.data_ptr(), n, ty, tx,
                h, w, cap, lo, hi, iters, K.ptr(scratch), img.data_ptr(),
                wgt.data_ptr(), rej.data_ptr(), K.stream_handle(cand))
        else:
            st = old.abt_drizzle_finalize(
                cand.data_ptr(), cand_w.data_ptr(), m, h, w, cap, lo, hi,
                iters, K.ptr(scratch), img.data_ptr(), wgt.data_ptr(),
                rej.data_ptr(), K.stream_handle(cand))
        if st != 0:
            raise RuntimeError(f"old drizzle finalize: CUDA error {st}")
        return img, wgt, rej

    failures = []
    times = {}

    def check(what, got, ref):
        ok = all(same_bits(a, b) for a, b in zip(got, ref))
        print(f"  {what}: {'same bits' if ok else 'DIFFERENT'}"
              f" (up to the sign of a zero)", flush=True)
        if not ok:
            failures.append(what)

    rng = np.random.default_rng(31)
    results = {"old_revision": rev, "card": smi, "ptxas": ptxas}
    # ---- K3 ----
    if "k3" in kernels:
        stack = torch.as_tensor(make_frames(N_FRAMES, H, W), device=dev)
        offs = rng.uniform(-12, 12, (2, N_FRAMES)).astype(np.float32)
        offs[:, 0] = 0.0
        dys, dxs = (torch.as_tensor(o, device=dev) for o in offs)
        zeros = torch.zeros(N_FRAMES, device=dev)
        check(f"K3 {N_FRAMES}x{H}x{W} +-12",
              shift_clip_maps(stack, dys, dxs)[:2], k3_old(stack, dys, dxs))
        check(f"K3 {N_FRAMES}x{H}x{W} zero offsets",
              shift_clip_maps(stack, zeros, zeros)[:2],
              k3_old(stack, zeros, zeros))
        for tag, (a, b) in (("k3_bench", (dys, dxs)),
                            ("k3_bench_zero", (zeros, zeros))):
            t = [cuda_ms(lambda: k3_old(stack, a, b), 10),
                 cuda_ms(lambda: shift_clip_maps(stack, a, b), 10),
                 cuda_ms(lambda: shift_clip_maps(stack, a, b), 10),
                 cuda_ms(lambda: k3_old(stack, a, b), 10)]
            times[tag] = {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}
        del stack
        frames, _ = wide_shift_frames(24, 2048, 200)
        big = torch.as_tensor(np.stack(frames), device=dev)
        del frames
        boffs = rng.uniform(-200, 200, (2, 24)).astype(np.float32)
        bdys, bdxs = (torch.as_tensor(o, device=dev) for o in boffs)
        check("K3 24x2048x2048 +-200", shift_clip_maps(big, bdys, bdxs)[:2],
              k3_old(big, bdys, bdxs))
        t = [cuda_ms(lambda: k3_old(big, bdys, bdxs), 10),
             cuda_ms(lambda: shift_clip_maps(big, bdys, bdxs), 10),
             cuda_ms(lambda: shift_clip_maps(big, bdys, bdxs), 10),
             cuda_ms(lambda: k3_old(big, bdys, bdxs), 10)]
        times["k3_24x2048"] = {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}
        del big
        for n in list(range(1, 33)) + [48, 100] + ([150] if same_abi else []):
            e = torch.as_tensor(edge_stack(rng, n, 300, 400), device=dev)
            eo = np.round(rng.uniform(-30, 30, (2, n)) * 4) / 4
            eo[:, 0] = 0.0
            eo[:, n // 3] = 0.0
            eo[:, n // 2] = np.round(eo[:, n // 2])
            edys, edxs = (torch.as_tensor(o, dtype=torch.float32, device=dev)
                          for o in eo)
            got = shift_clip_maps(e, edys, edxs, 2.5, 3.0, 5)
            check(f"K3 {n}x300x400 edge stack, {got[2].instance} instance",
                  got[:2], k3_old(e, edys, edxs, 2.5, 3.0, 5))
    # ---- K7 / K8 ----
    if "k7" in kernels:
        gen = torch.Generator(device=dev).manual_seed(DRZ_SEED)
        drng = np.random.default_rng(DRZ_SEED)
        dstack = torch.randn((DRZ_N, DRZ_HW, DRZ_HW), generator=gen,
                             device=dev) * 8.0 + 100.0
        dd = [torch.as_tensor(drng.uniform(-2, 2, DRZ_N), dtype=torch.float32,
                              device=dev) for _ in range(2)]
        r0 = 3 * DRZ_BAND
        for band in (DRZ_BAND, DRZ_BAND64):
            cand, wys, wxs, taps = _frame_candidates_raw(
                dstack, dd[0] - r0 / 2.0, dd[1], 2.0, 0.7,
                DrizzleKernel.SQUARE, band, 2 * DRZ_HW)
            wys_t = wys.T.contiguous()
            fa = (DRZ_N, taps, taps, max(2 * DRZ_N, 4), 3.0, 3.0, 5)
            check(f"K7 {tuple(cand.shape)}",
                  drizzle_finalize_fused(cand, wys_t, wxs, *fa),
                  k7_old(cand, wys_t, wxs, *fa))
            reps = 10 if band == DRZ_BAND else 50
            t = [cuda_ms(lambda: k7_old(cand, wys_t, wxs, *fa), reps),
                 cuda_ms(lambda: drizzle_finalize_fused(cand, wys_t, wxs, *fa),
                         reps),
                 cuda_ms(lambda: drizzle_finalize_fused(cand, wys_t, wxs, *fa),
                         reps),
                 cuda_ms(lambda: k7_old(cand, wys_t, wxs, *fa), reps)]
            times[f"k7_band{band}"] = {"old_ms": [t[0], t[3]],
                                       "new_ms": [t[1], t[2]]}
            del cand
        del dstack
        for n in (2, 4, 6, 8, 10, 12, 14, 16, 20, 100, 150):
            e = torch.as_tensor(edge_stack(rng, n, 40, 72), device=dev)
            ed = [torch.as_tensor(rng.uniform(-2, 2, n), dtype=torch.float32,
                                  device=dev) for _ in range(2)]
            cand, wys, wxs, taps = _frame_candidates_raw(
                e, ed[0], ed[1], 2.0, 1.0, DrizzleKernel.SQUARE, 80, 144)
            wys_t = wys.T.contiguous()
            fa = (n, taps, taps, max(2 * n, 4), 2.5, 3.0, 5)
            check(f"K7 {tuple(cand.shape)} edge stack, depth {fa[3]}",
                  drizzle_finalize_fused(cand, wys_t, wxs, *fa),
                  k7_old(cand, wys_t, wxs, *fa))
            _, cand_w = _masked_candidates(cand, _outer(
                wys.reshape(n, taps, 80), wxs.reshape(n, taps, 144)))
            check(f"K8 {tuple(cand.shape)} edge stack, depth {fa[3]}",
                  drizzle_finalize(cand, cand_w, *fa[3:]),
                  k7_old(cand, None, None, *fa, cand_w=cand_w))
    # ---- K12 ----
    if "k12" in kernels:
        compare_k12(old, old_dir, dev, check, times)
    # ---- K13 ----
    if "k13" in kernels:
        compare_k13(old, old_dir, dev, check, times)
    # ---- K11, K2 ----
    if "k11" in kernels:
        compare_k11(old, dev, failures, times)
    if "k2" in kernels:
        compare_k2(old, old_dir, dev, check, times)
    results["times"] = times
    results["failures"] = failures
    for tag, tt in times.items():
        print(f"[time] {smi}: {tag} old {tt['old_ms']} ms | new "
              f"{tt['new_ms']} ms", flush=True)
    print(json.dumps(results), flush=True)
    if failures:
        sys.exit(f"compare_old_kernels: {len(failures)} cases differ: "
                 f"{failures}")
    print("compare_old_kernels: every case has the same bits", flush=True)


if __name__ == "__main__":
    main()
