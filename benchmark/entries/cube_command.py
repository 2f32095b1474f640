"""Opening a spectral cube with the eager command, as the UI does:
``astroburst_tpu_torch.api.process_cube_cmd(path, out_dir)`` on one
FITS file whose SCI extension is the cube, with the default frame step
(every depth // 16-th plane). Each command decodes the whole file from
the page cache, puts it on the card, takes its global statistics and
both collapses, and writes 18 PNGs: the mean, the median and the
sampled frames.

The cube is rendered on the card from ``--seed`` and written once a run
(``core/cube_fields.py``) into a directory of its own under the run's
output root, which the run removes at its end: 2 GiB sets do not pile
up in the benchmark's cache, and the write is a fixed part of the
set-up.

Compared with the plain reference (``reference/cube.py``, the file read
by ``reference/fits_cube.py``): the header numbers, the centre spectrum
and the PNGs decoded by the benchmark's own decoder. ``median_off_share``
is the share of the median collapse's pixels more than one level off;
``preview_off_share`` the same share in the worst of the other 17 PNGs
(the mean collapse and the frames), so that one wrong frame shows.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.core import compare as C
from benchmark.core.cube_fields import write_cube_file
from benchmark.core.entry import CommandEntry
from benchmark.reference.cube import process_cube
from benchmark.reference.fits_cube import read_cube
from benchmark.reference.png import decode_png

HEADER = ("dimensions", "frame_count", "classification", "wavelengths")


class Entry(CommandEntry):
    def __init__(self, ctx):
        super().__init__(ctx)
        data = self.config["data"]
        self.path = write_cube_file(self.config, ctx.seed,
                                    os.path.join(ctx.out_root, "cube"),
                                    ctx.device)
        self.mpx = data["depth"] * data["height"] * data["width"] / 1e6

    def command(self):
        return self.api.process_cube_cmd(self.path, self.out,
                                         device=self.device)

    def outputs(self, kept) -> dict:
        res, d = kept

        def png(path):
            return torch.from_numpy(decode_png(os.path.join(
                d, os.path.relpath(path, self.out))).copy())
        frames_dir = res["frames_dir"]
        names = sorted(os.listdir(os.path.join(
            d, os.path.relpath(frames_dir, self.out))))
        return {"dimensions": res["dimensions"],
                "frame_count": res["frame_count"],
                "classification": res["spectral_classification"],
                "wavelengths": res["wavelengths"],
                "center_spectrum": torch.tensor(res["center_spectrum"],
                                                dtype=torch.float32),
                "mean_u8": png(res["collapsed_path"]),
                "median_u8": png(res["collapsed_median_path"]),
                "frames_u8": [png(os.path.join(frames_dir, n))
                              for n in names]}

    def reference(self, precision: str) -> dict:
        cube, header = read_cube(self.path)
        return process_cube(torch.from_numpy(cube).to(self.device), header,
                            precision)

    def compare(self, got: dict, ref: dict) -> dict:
        previews = [(got["mean_u8"], ref["mean_u8"])] + list(zip(
            got["frames_u8"], ref["frames_u8"]))
        if len(got["frames_u8"]) != len(ref["frames_u8"]):
            previews.append((torch.zeros(1), torch.zeros(2)))
        return {
            "header_mismatch": sum(1 for k in HEADER if got[k] != ref[k]),
            "spectrum_max_rel": spectrum_rel(got["center_spectrum"],
                                             ref["center_spectrum"]),
            "median_off_share": C.share_over(got["median_u8"],
                                             ref["median_u8"], 1.0),
            "preview_off_share": max(C.share_over(g, r, 1.0)
                                     for g, r in previews),
        }


def spectrum_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| / |ref| over the spectrum; NaN where the
    reference has NaN is no gap, NaN or inf elsewhere an infinite one."""
    if got.shape != ref.shape:
        return math.inf
    g, r = got.double().numpy(), ref.double().numpy()
    same = (np.isnan(g) & np.isnan(r)) | (g == r)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(g - r) / np.maximum(np.abs(r), 1e-30)
    gap = np.where(same, 0.0, np.where(np.isfinite(gap), gap, math.inf))
    return float(gap.max()) if gap.size else 0.0
