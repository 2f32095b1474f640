"""The ``stack`` command on the set's FITS files, with an empty image
cache: ``astroburst_tpu_torch.api.stack(paths, out_dir, sigma_low,
sigma_high, max_iterations, align)``, which writes ``stacked.fits``
and ``stacked.png``.

Compared with the plain reference (frames read by the benchmark's own
FITS reader): the response's whole-pixel offsets, rejected count and
statistics, ``stacked.fits`` read back by the benchmark's reader, and
``stacked.png`` decoded by its own decoder.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.core import compare as C
from benchmark.core.entry import CommandEntry
from benchmark.core.fields import fits_files
from benchmark.reference import rounder
from benchmark.reference.align import phase_correlate
from benchmark.reference.fits import read_fits
from benchmark.reference.png import decode_png
from benchmark.reference.stack import (auto_stf, clip_in_rows, preview_u8,
                                       shift_frame, stats)

STATS = ("min", "max", "mean", "median", "mad", "sigma")


class Entry(CommandEntry):
    def __init__(self, ctx):
        super().__init__(ctx)
        data = self.config["data"]
        self.paths, _ = fits_files(self.config, ctx.seed, data["frames"],
                                   ctx.cache_root, ctx.device)
        self.mpx = data["frames"] * data["height"] * data["width"] / 1e6
        p = self.params
        self.clip = (p["sigma_low"], p["sigma_high"], p["max_iterations"])

    def command(self):
        return self.api.stack(self.paths, self.out, *self.clip,
                              self.params["align"], device=self.device)

    def outputs(self, kept) -> dict:
        res, d = kept
        image, _ = read_fits(os.path.join(d, "stacked.fits"))
        return {"offsets": res["offsets"],
                "rejected": res["rejected_pixels"],
                "stats": res["stats"],
                "image": torch.from_numpy(image).to(self.device),
                "preview": torch.from_numpy(
                    decode_png(os.path.join(d, "stacked.png")).copy())}

    def reference(self, precision: str) -> dict:
        q = rounder(precision)
        stack = q(torch.from_numpy(np.stack(
            [read_fits(p)[0] for p in self.paths])).to(self.device))
        if self.params["align"]:
            dys, dxs, _ = (v.tolist() for v in phase_correlate(stack, q))
        else:
            dys = dxs = [0.0] * stack.shape[0]
        shifted = torch.stack([q(shift_frame(stack[k], dys[k], dxs[k]))
                               for k in range(stack.shape[0])])
        del stack
        image, rejected = clip_in_rows(shifted, *self.clip)
        del shifted
        image = q(image)
        st = stats(image)
        return {"offsets": list(zip(dys, dxs)), "rejected": rejected,
                "stats": st, "image": image,
                "preview": preview_u8(image, st, auto_stf(st)).cpu()}

    def compare(self, got: dict, ref: dict) -> dict:
        sigma = ref["stats"]["sigma"]
        mismatch = sum(
            1 for (gy, gx), (ry, rx) in zip(got["offsets"], ref["offsets"])
            for g, r in ((gy, ry), (gx, rx))
            if round(g) != round(r) and abs(r - np.floor(r) - 0.5) > 1e-3)
        mismatch += abs(len(got["offsets"]) - len(ref["offsets"]))
        return {
            "offsets_mismatch": mismatch,
            "rejected_rel": C.rel_count(got["rejected"], ref["rejected"]),
            "stats_rel": max(C.rel(got["stats"][k], ref["stats"][k])
                             for k in STATS),
            "image_mean_sigma": C.mean_gap(got["image"], ref["image"],
                                           sigma),
            "image_off_share": C.share_over(got["image"], ref["image"],
                                            sigma),
            "preview_off_share": C.share_over(got["preview"],
                                              ref["preview"], 1.0),
        }
