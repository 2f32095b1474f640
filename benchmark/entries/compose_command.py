"""Composing three filter mosaics into an RGB picture, as the UI does:
``astroburst_tpu_torch.api.compose_rgb_cmd(out_dir, r_path=, g_path=,
b_path=, **params)`` with an empty image cache, so each command decodes
its three files (the OS page cache stays warm). The command resamples
R to the largest grid, aligns G and B to it, takes the statistics,
white balance, STF and SCNR, keeps the pre-stretch planes in the
composite cache and writes the RGB preview PNG.

The three files are rendered on the card from ``--seed`` and written
once into the benchmark's cache (``core/rgb_fields.py``), with the
affine transforms that misregister G and B against R.

On the card the alignment has to go through the fused star chain, and
both targets have to come back aligned by stars. The transforms are read
where the host first holds them: a pass-through around
``alignment.fused_chain._interpret_info`` (the reading of the chain's one
info fetch) records each target's result while the run lasts. The
warm-up stops the run when the chain is not taken or a target falls back
to phase correlation: a port that cannot align these planes by stars
fails at once, with no result.

Compared with the plain reference (``reference/compose.py`` on the files
read by ``reference/fits_image.py``), for each kept command:

- ``transform_ref_px``: the largest displacement, over the four corners
  of the frame, between the program's G and B transforms and the
  reference's; ``transform_truth_px``: the same against the transforms
  the generator injected. The reference's transform of a target is the
  one nearest the program's of RANSAC's outcome and its other outcomes
  where errors within 0.1 px of the 3 px threshold fall the other way
  (``reference/compose.py:ransac``): float32 against float64 can move an
  error that far, and then a whole inlier set, so the comparison takes
  the reference's own result for that set, and makes its warped and
  colour stages again with it;
- ``not_by_stars``: the targets not aligned by the star chain (exact 0);
- ``header_mismatch``: the response's dimensions, ``resampled`` and the
  dimension info's target and original sizes (exact);
- ``stats_rel``: the largest gap of the six statistics, the response's
  (median, mean, min, max of each aligned plane) and those the
  composite cache holds for each white-balanced plane (min, max, mean,
  median, MAD, sigma): the median, mean, MAD and sigma relative to the
  reference's value (at least its channel's sigma), the min and the max
  relative to the channel's range, as the STF reads them. The min of a
  warped plane is a Catmull-Rom undershoot on a bright source's steep
  flank: a transform 1e-3 px away moves it by a few hundredths of a
  sigma, and the stretch by nothing;
- ``image_mean_sigma``: the mean gap of each pre-stretch composite plane
  (the cache keys ``__composite_orig_*``) over the pixels finite in both,
  in units of its reference sigma, the worst channel;
  ``image_off_share``: the share of its pixels more than one sigma off
  or finite in one plane only (a NaN border a pixel away), the worst
  channel;
- ``preview_off_share``: the share of the RGB PNG's values, decoded by
  the benchmark's own decoder, more than one level off.
"""

from __future__ import annotations

import importlib
import math
import os

import numpy as np
import torch

from benchmark.core import compare as C
from benchmark.core.entry import CommandEntry
from benchmark.core.rgb_fields import CHANNELS, rgb_files
from benchmark.reference.compose import compose, finish
from benchmark.reference.fits_image import read_sci_image
from benchmark.reference.png import decode_png

STAR_METHODS = ("affine", "rigid")
STATS_BRIEF = ("median", "mean", "min", "max")
STATS_FULL = ("min", "max", "mean", "median", "mad", "sigma")
ORIG_KEYS = ("__composite_orig_r", "__composite_orig_g",
             "__composite_orig_b")
CHAIN = "astroburst_tpu_torch.alignment.fused_chain"


class Entry(CommandEntry):
    def __init__(self, ctx):
        super().__init__(ctx)
        data = self.config["data"]
        self.paths, self.truth = rgb_files(self.config, ctx.seed,
                                           ctx.cache_root, ctx.device)
        self.rows, self.cols = data["sw_height"], data["sw_width"]
        self.mpx = (2 * data["sw_height"] * data["sw_width"]
                    + data["lw_height"] * data["lw_width"]) / 1e6
        self.chain = importlib.import_module(CHAIN)
        self.read_info = self.chain._interpret_info
        self.results = []

        def recorded(*args, **kwargs):
            out = self.read_info(*args, **kwargs)
            self.results.append(out[1])
            return out

        self.chain._interpret_info = recorded

    def command(self):
        self.results = []
        res = self.api.compose_rgb_cmd(
            self.out, r_path=self.paths["r"], g_path=self.paths["g"],
            b_path=self.paths["b"], device=self.device, **self.params)
        return res, [(r.method, r.transform.as_tuple())
                     for r in self.results]

    def warm_up(self) -> float:
        seconds = super().warm_up()
        methods = [r.method for r in self.results]
        if len(methods) != 2 or any(m not in STAR_METHODS for m in methods):
            raise RuntimeError(
                "the compose did not align G and B by the fused star "
                f"chain: {methods or 'the chain was not taken'}")
        return seconds

    def keep(self, res, index: int):
        cache = self.cache
        planes = [cache.get(k, self.device) for k in ORIG_KEYS]
        return super().keep(res, index), [
            (e.image, e.stats) if e is not None else None for e in planes]

    def close(self) -> None:
        self.chain._interpret_info = self.read_info
        super().close()

    def outputs(self, kept) -> dict:
        ((res, aligned), d), planes = kept
        png = os.path.join(d, os.path.basename(res["png_path"]))
        info = res.get("dimension_info") or {}
        return {
            "dimensions": list(res["dimensions"]),
            "resampled": bool(res.get("resampled")),
            "target": list(info.get("target") or ()),
            "originals": [list(info.get(f"original_{c}") or ())
                          for c in CHANNELS],
            "aligned": aligned,
            "stats": [res[f"stats_{c}"] for c in CHANNELS],
            "stats_wb": [None if p is None else
                         {k: getattr(p[1], k) for k in STATS_FULL}
                         for p in planes],
            "planes": [None if p is None else p[0] for p in planes],
            "preview": torch.from_numpy(decode_png(png).copy()),
        }

    def reference(self, precision: str) -> dict:
        planes = [torch.from_numpy(read_sci_image(self.paths[c])[0]).to(
            self.device) for c in CHANNELS]
        shapes = [[int(p.shape[1]), int(p.shape[0])] for p in planes]
        scnr = self.params.get("scnr_amount", 1.0)
        out = compose(*planes, precision, scnr)
        cols, rows = out["dimensions"]
        harmonized = out.pop("harmonized")
        return {
            "dimensions": out["dimensions"],
            "resampled": out["resampled"],
            "target": [cols, rows] if out["resampled"] else [],
            "originals": shapes if out["resampled"] else [[]] * 3,
            "aligned": [(out[c]["method"], out[c]["transform"])
                        for c in ("g", "b")],
            "edge": [out[c]["edge"] for c in ("g", "b")],
            "finish": lambda ts: colour(finish(*harmonized, ts, precision,
                                               scnr)),
            "finished": {},
            **colour(out),
        }

    def compare(self, got: dict, ref: dict) -> dict:
        corners = [(0.0, 0.0), (self.cols - 1.0, 0.0),
                   (0.0, self.rows - 1.0), (self.cols - 1.0, self.rows - 1.0)]
        truth = [self.truth["g"], self.truth["b"]]
        got_t = [t for _, t in got["aligned"]]
        ref, ref_t = at_edge(ref, got_t, corners)
        header = [got[k] == ref[k] for k in ("dimensions", "resampled",
                                             "target", "originals")]
        return {
            "transform_ref_px": corner_gap(got_t, ref_t, corners),
            "transform_truth_px": corner_gap(got_t, truth, corners),
            "not_by_stars": sum(1 for m, _ in got["aligned"]
                                if m not in STAR_METHODS)
            + abs(2 - len(got["aligned"])),
            "header_mismatch": header.count(False),
            "stats_rel": max(
                stats_gap(got["stats"], ref["stats"], ref["stats_scale"]),
                stats_gap(got["stats_wb"], ref["stats_wb"],
                          ref["stats_wb"])),
            "image_mean_sigma": max(
                finite_mean_gap(g, r) / max(s["sigma"], 1e-30)
                for g, r, s in zip(got["planes"], ref["planes"],
                                   ref["stats_wb"])),
            "image_off_share": max(
                C.share_over(g, r, max(s["sigma"], 1e-30))
                if g is not None else 1.0
                for g, r, s in zip(got["planes"], ref["planes"],
                                   ref["stats_wb"])),
            "preview_off_share": C.share_over(got["preview"],
                                              ref["preview"], 1.0),
        }


def at_edge(ref: dict, got_t: list, corners):
    """(the reference, its G and B transforms), with each target's
    transform the one nearest ``got_t`` of the reference's outcome and
    its other outcomes at RANSAC's threshold's edge; where one of those
    is taken, the reference's warped and colour stages are made again
    with it (once for each choice)."""
    ref_t = [t for _, t in ref["aligned"]]
    if len(got_t) != len(ref_t):
        return ref, ref_t
    pick = tuple(min(range(1 + len(e)),
                     key=lambda k: corner_gap([g], [([t] + e)[k]], corners))
                 for g, t, e in zip(got_t, ref_t, ref["edge"]))
    if not any(pick):
        return ref, ref_t
    ts = [([t] + e)[k] for t, e, k in zip(ref_t, ref["edge"], pick)]
    if pick not in ref["finished"]:
        ref["finished"][pick] = ref["finish"](ts)
    return {**ref, **ref["finished"][pick]}, ts


def colour(out: dict) -> dict:
    """The reference's colour stages as the comparison reads them."""
    return {"stats": [{k: s[k] for k in STATS_BRIEF} for s in out["stats"]],
            "stats_scale": out["stats"],
            "stats_wb": [{k: s[k] for k in STATS_FULL}
                         for s in out["stats_wb"]],
            "planes": out["planes"],
            "preview": out["preview"]}


def _map(t, x: float, y: float):
    a, b, tx, c, d, ty = t
    return a * x + b * y + tx, c * x + d * y + ty


def corner_gap(got: list, want: list, corners) -> float:
    """The largest distance between the two lists' transforms at the
    corners; infinite where a transform is missing."""
    if len(got) != len(want):
        return math.inf
    gap = 0.0
    for g, w in zip(got, want):
        for x, y in corners:
            (gx, gy), (wx, wy) = _map(g, x, y), _map(w, x, y)
            gap = max(gap, math.hypot(gx - wx, gy - wy))
    return gap if np.isfinite(gap) else math.inf


def stats_gap(got: list, ref: list, scale: list) -> float:
    """The largest |got - ref| over max(|ref|, the channel's sigma), or
    over the channel's range for the min and the max."""
    if any(g is None for g in got) or len(got) != len(ref):
        return math.inf
    gap = 0.0
    for g, r, s in zip(got, ref, scale):
        for k in r:
            if not math.isfinite(g[k]):
                return math.inf
            unit = (s["max"] - s["min"] if k in ("min", "max")
                    else max(abs(r[k]), s["sigma"]))
            gap = max(gap, abs(g[k] - r[k]) / max(unit, 1e-30))
    return gap


def finite_mean_gap(got, ref) -> float:
    """The mean |got - ref| over the pixels finite in both; infinite
    for a missing plane or another shape."""
    if got is None or got.shape != ref.shape:
        return math.inf
    got = got.to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    both = torch.isfinite(got) & torch.isfinite(ref)
    if not bool(both.any()):
        return math.inf
    return float(torch.abs(got - ref)[both].mean())
