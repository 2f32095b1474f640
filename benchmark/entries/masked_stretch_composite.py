"""The star-protected stretch of a resident colour composite, as the UI
runs it again while its settings are tuned:
``astroburst_tpu_torch.api.masked_stretch_composite_cmd(out_dir,
**params)`` on the composite the image cache holds: one star mask from
the planes' luminance (detection, the 3 px dedupe, the paint), each
channel's MTF loop under it, and the RGB preview PNG.

Set-up renders the three planes on the card from ``--seed`` and writes
them once into the benchmark's cache (``core/rgb_fields.py``; one grid,
no misregistration), then runs ``compose_rgb_cmd`` on them once with
the traffic's ``setup`` parameters (alignment off), which leaves the
white-balanced planes in the composite cache (KEY and ORIG, one tensor
each). The requests do not empty the cache: the composite stays
resident, as it does between two stretches in the application. Each
request writes into an empty output directory; a kept request's
directory is moved aside.

Compared with the plain reference (``reference/masked_stretch.py`` on
the files read by ``reference/fits_image.py``), for each kept command:

- ``stars_rel``: the gap of the stars masked, relative to the
  reference's count;
- ``coverage_gap``: the gap of the mask's coverage (a share of the
  pixels);
- ``iterations_mismatch``: the channels whose ``iterations_run``
  differs (exact 0);
- ``converged_mismatch``: the channels whose ``converged`` differs
  (exact 0);
- ``final_background_gap``: the largest gap of a channel's
  ``final_background`` (on the stretch's [0, 1] scale);
- ``preview_off_share``: the share of the RGB PNG's values, decoded by
  the benchmark's own decoder, more than one level off.
"""

from __future__ import annotations

import importlib
import os
import shutil

import torch

from benchmark.core import compare as C
from benchmark.core.entry import Entry as BaseEntry
from benchmark.core.rgb_fields import CHANNELS, rgb_files
from benchmark.reference.fits_image import read_sci_image
from benchmark.reference.masked_stretch import masked_stretch_shared
from benchmark.reference.png import decode_png


class Entry(BaseEntry):
    def __init__(self, ctx):
        super().__init__(ctx)
        data = self.config["data"]
        self.api = importlib.import_module("astroburst_tpu_torch.api")
        self.cache = importlib.import_module(
            "astroburst_tpu_torch.runtime.cache").GLOBAL_IMAGE_CACHE
        self.paths, _ = rgb_files(self.config, ctx.seed, ctx.cache_root,
                                  ctx.device)
        self.mpx = len(CHANNELS) * data["sw_height"] * data["sw_width"] / 1e6
        self.out = os.path.join(ctx.out_root, "current")
        self.cache.clear()
        self.api.compose_rgb_cmd(
            os.path.join(ctx.out_root, "compose"), r_path=self.paths["r"],
            g_path=self.paths["g"], b_path=self.paths["b"],
            device=self.device, **ctx.cell.traffic["setup"])
        shutil.rmtree(os.path.join(ctx.out_root, "compose"),
                      ignore_errors=True)

    def request(self):
        shutil.rmtree(self.out, ignore_errors=True)
        return self.api.masked_stretch_composite_cmd(
            self.out, device=self.device, **self.params)

    def keep(self, res, index: int):
        kept = os.path.join(self.ctx.out_root, f"kept-{index}")
        os.replace(self.out, kept)
        return res, kept

    def release(self) -> None:
        self.cache.clear()
        super().release()

    def close(self) -> None:
        shutil.rmtree(self.ctx.out_root, ignore_errors=True)

    def outputs(self, kept) -> dict:
        res, d = kept
        png = os.path.join(d, os.path.basename(res["png_path"]))
        return {
            "stars": res["stars_masked"],
            "coverage": res["mask_coverage"],
            "channels": [res["channels"][c] for c in CHANNELS],
            "preview": torch.from_numpy(decode_png(png).copy()),
        }

    def reference(self, precision: str) -> dict:
        planes = [torch.from_numpy(read_sci_image(self.paths[c])[0]).to(
            self.device) for c in CHANNELS]
        return masked_stretch_shared(*planes, precision)

    def compare(self, got: dict, ref: dict) -> dict:
        pairs = list(zip(got["channels"], ref["channels"]))
        return {
            "stars_rel": C.rel_count(got["stars"], ref["stars"]),
            "coverage_gap": abs(got["coverage"] - ref["coverage"]),
            "iterations_mismatch": sum(
                g["iterations_run"] != r["iterations_run"] for g, r in pairs)
            + abs(len(CHANNELS) - len(pairs)),
            "converged_mismatch": sum(
                bool(g["converged"]) != r["converged"] for g, r in pairs),
            "final_background_gap": max(
                abs(g["final_background"] - r["final_background"])
                for g, r in pairs),
            "preview_off_share": C.share_over(got["preview"], ref["preview"],
                                              1.0),
        }
