"""Opening one FITS file, as the UI does, with an empty image cache:
``astroburst_tpu_torch.api.process_fits_full(path, out_dir)`` (decode,
statistics, auto-STF, the 512-bin display histogram, the header and
the preview PNG).

Compared with the plain reference (the file read by the benchmark's
own FITS reader): the response's statistics, STF parameters,
histogram and header, and the preview PNG decoded by the benchmark's
own decoder.
"""

from __future__ import annotations

import os

import torch

from benchmark.core import compare as C
from benchmark.core.entry import CommandEntry
from benchmark.core.fields import fits_files
from benchmark.reference import rounder
from benchmark.reference.fits import read_fits
from benchmark.reference.png import decode_png
from benchmark.reference.stack import auto_stf, histogram, preview_u8, stats

STATS = ("min", "max", "mean", "median", "mad", "sigma")
STF = ("shadow", "midtone", "highlight")
BINS = 512


class Entry(CommandEntry):
    def __init__(self, ctx):
        super().__init__(ctx)
        data = self.config["data"]
        paths, _ = fits_files(self.config, ctx.seed, 1, ctx.cache_root,
                              ctx.device)
        self.path = paths[0]
        self.mpx = data["height"] * data["width"] / 1e6

    def command(self):
        return self.api.process_fits_full(self.path, self.out,
                                          device=self.device)

    def outputs(self, kept) -> dict:
        res, d = kept
        png = os.path.join(d, os.path.basename(res["png_path"]))
        return {"stats": res["stats"], "stf": res["stf"],
                "bins": torch.tensor(res["histogram"]["bins"],
                                     dtype=torch.int64),
                "header": res["header"],
                "preview": torch.from_numpy(decode_png(png).copy())}

    def reference(self, precision: str) -> dict:
        q = rounder(precision)
        plane, header = read_fits(self.path)
        image = q(torch.from_numpy(plane).to(self.device))
        st = stats(image)
        stf = auto_stf(st)
        return {"stats": st, "stf": stf,
                "bins": histogram(image, st["min"], st["max"], BINS),
                "header": header,
                "preview": preview_u8(image, st, stf).cpu()}

    def compare(self, got: dict, ref: dict) -> dict:
        keys = set(got["header"]) | set(ref["header"])
        total = max(int(ref["bins"].sum()), 1)
        return {
            "stats_rel": max(C.rel(got["stats"][k], ref["stats"][k])
                             for k in STATS),
            "stf_max": max(abs(got["stf"][k] - ref["stf"][k]) for k in STF),
            "hist_moved_share": float((got["bins"] - ref["bins"]).abs()
                                      .sum()) / (2 * total),
            "header_mismatch": sum(1 for k in keys if got["header"].get(k)
                                   != ref["header"].get(k)),
            "preview_off_share": C.share_over(got["preview"],
                                              ref["preview"], 1.0),
        }
