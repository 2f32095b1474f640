"""The drizzle of frames resident on the card:
``astroburst_tpu_torch.stacking.drizzle.drizzle_stack(frames,
DrizzleConfig(...))`` with the traffic's scale, pixfrac, kernel and
clip; a request ends with its rejected-count fetch.

Compared with the plain reference: the offsets, the image, the weight
map and the rejected count.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.core import compare as C
from benchmark.core.entry import Entry as Base
from benchmark.core.fields import render
from benchmark.reference import rounder
from benchmark.reference.align import phase_correlate
from benchmark.reference.drizzle import drizzle
from benchmark.reference.stack import stats

CONFIDENT = 2.0   # below it the program re-aligns a frame by its stars


class Entry(Base):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.drizzle = importlib.import_module(
            "astroburst_tpu_torch.stacking.drizzle")
        dtypes = importlib.import_module("astroburst_tpu_torch.dtypes")
        p = self.params
        if p["kernel"] != "square":
            raise ValueError("the reference drizzles with the square "
                             "kernel only")
        self.cfg = dtypes.DrizzleConfig(
            scale=p["scale"], pixfrac=p["pixfrac"],
            kernel=dtypes.DrizzleKernel.parse(p["kernel"]),
            sigma_low=p["sigma_low"], sigma_high=p["sigma_high"],
            sigma_iterations=p["iterations"])
        self.frames = render(self.config["data"], ctx.seed, ctx.device)
        self.images = list(self.frames)
        n, h, w = self.frames.shape
        self.mpx = n * h * w / 1e6

    def request(self):
        return self.drizzle.drizzle_stack(self.images, self.cfg,
                                          device=self.device)

    def outputs(self, kept) -> dict:
        return {"offsets": torch.tensor([[dy, dx] for dx, dy in
                                         kept.offsets], dtype=torch.float64),
                "image": kept.image, "weight": kept.weight_map,
                "rejected": kept.rejected_pixels}

    def reference(self, precision: str) -> dict:
        q = rounder(precision)
        p = self.params
        stack = q(self.frames)
        dys, dxs, conf = phase_correlate(stack, q)
        if float(conf[1:].min()) < CONFIDENT:
            raise RuntimeError("a frame's phase correlation is not "
                               "confident: the reference does not "
                               "re-align by stars")
        offsets = list(zip(dys.tolist(), dxs.tolist()))
        image, weight, rejected = drizzle(
            stack, offsets, p["scale"], p["pixfrac"], p["sigma_low"],
            p["sigma_high"], p["iterations"], q=q)
        return {"offsets": torch.tensor(offsets, dtype=torch.float64),
                "image": image, "weight": weight, "rejected": rejected,
                "sigma": stats(image)["sigma"],
                "weight_max": float(weight.max())}

    def compare(self, got: dict, ref: dict) -> dict:
        return {
            "offsets_max_px": C.max_gap(got["offsets"], ref["offsets"]),
            "image_max_sigma": C.max_gap(got["image"], ref["image"],
                                         ref["sigma"]),
            "image_mean_sigma": C.mean_gap(got["image"], ref["image"],
                                           ref["sigma"]),
            "weight_max_rel": C.max_gap(got["weight"], ref["weight"],
                                        ref["weight_max"]),
            "rejected_rel": C.rel_count(got["rejected"], ref["rejected"]),
        }
