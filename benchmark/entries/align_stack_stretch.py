"""Align → stack → stretch on frames resident on the card:
``astroburst_tpu_torch.parallel.pipeline.align_stack_stretch(stack,
sigma_low, sigma_high, max_iter)``. Each request ends in one fetch of
the offsets, the rejected count, the STF parameters and the data
range.

Compared with the plain reference: the offsets, the combined image,
the rejected count, the STF parameters, the data range and the u8
preview.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.core import compare as C
from benchmark.core.entry import Entry as Base
from benchmark.core.fields import render
from benchmark.reference import rounder
from benchmark.reference.align import phase_correlate
from benchmark.reference.stack import (auto_stf_f32, clip_in_rows,
                                       shift_frame, stats, stf_u8)


class Entry(Base):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.pipeline = importlib.import_module(
            "astroburst_tpu_torch.parallel.pipeline")
        self.frames = render(self.config["data"], ctx.seed, ctx.device)
        n, h, w = self.frames.shape
        self.mpx = n * h * w / 1e6
        p = self.params
        self.clip = (p["sigma_low"], p["sigma_high"], p["max_iterations"])

    def request(self):
        out = self.pipeline.align_stack_stretch(self.frames, *self.clip)
        host = torch.cat([out["offsets"].reshape(-1).double(),
                          out["rejected"].reshape(1).double(),
                          out["stf"].double(),
                          out["data_range"].double()]).cpu()
        return out, host

    def outputs(self, kept) -> dict:
        out, host = kept
        n = self.frames.shape[0]
        return {"offsets": host[:2 * n].reshape(n, 2),
                "rejected": int(host[2 * n]),
                "stf": host[2 * n + 1:2 * n + 3],
                "range": host[2 * n + 3:2 * n + 5],
                "image": out["combined"], "preview": out["preview"]}

    def reference(self, precision: str) -> dict:
        q = rounder(precision)
        stack = q(self.frames)
        dys, dxs, _ = phase_correlate(stack, q)
        hy, hx = dys.tolist(), dxs.tolist()
        shifted = torch.stack([q(shift_frame(stack[k], hy[k], hx[k]))
                               for k in range(stack.shape[0])])
        image, rejected = clip_in_rows(shifted, *self.clip)
        del shifted
        image = q(image)
        st = stats(image, pair=False)
        shadow, mid = auto_stf_f32(st, self.device)
        f32 = torch.float32
        dmin = torch.tensor(st["min"], dtype=f32, device=self.device)
        dmax = torch.tensor(st["max"], dtype=f32, device=self.device)
        inv_range = 1.0 / torch.clamp(dmax - dmin, min=1e-30)
        inv_clip = 1.0 / torch.clamp(1.0 - shadow, min=1e-15)
        return {"offsets": torch.stack([dys, dxs], 1).double().cpu(),
                "rejected": rejected,
                "stf": torch.stack([shadow, mid]).double().cpu(),
                "range": torch.tensor([st["min"], st["max"]],
                                      dtype=torch.float64),
                "sigma": st["sigma"], "image": image,
                "preview": stf_u8(image, dmin, inv_range, shadow, inv_clip,
                                  mid)}

    def compare(self, got: dict, ref: dict) -> dict:
        sigma = ref["sigma"]
        span = float(ref["range"][1] - ref["range"][0])
        return {
            "offsets_max_px": C.max_gap(got["offsets"], ref["offsets"]),
            "image_mean_sigma": C.mean_gap(got["image"], ref["image"],
                                           sigma),
            "image_off_share": C.share_over(got["image"], ref["image"],
                                            sigma),
            "rejected_rel": C.rel_count(got["rejected"], ref["rejected"]),
            "stf_max": C.max_gap(got["stf"], ref["stf"]),
            "range_rel": C.max_gap(got["range"], ref["range"], span),
            "preview_off_share": C.share_over(got["preview"],
                                              ref["preview"], 1.0),
        }
