"""What the entries (``benchmark/entries/<name>.py``) share.

An entry is made once per run; the harness calls ``warm_up`` (set-up),
``request`` (one request, which returns once its result is on the
host), ``keep`` (a sampled request's result, kept past the next
request), ``release`` (after the window: the program's state freed),
then ``reference``, ``outputs`` and ``compare`` for ``correct``, and
``close`` at the end.
"""

from __future__ import annotations

import importlib
import os
import shutil
import time

import torch

WARM_UPS = 2


class Entry:
    mpx = 0.0   # input megapixels of one request

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.params = ctx.cell.traffic.get("params", {})
        self.device = ctx.device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> float:
        """Run the cell's own request twice, keeping the first's result
        alive through the second as the window does; the seconds of the
        second."""
        seconds, held = 0.0, None
        for _ in range(WARM_UPS):
            self.sync()
            t = time.perf_counter()
            res = self.request()
            self.sync()
            seconds = time.perf_counter() - t
            held = res
        del held
        return seconds

    def keep(self, res, index: int):
        return res

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass


class CommandEntry(Entry):
    """A command of ``astroburst_tpu_torch.api`` on FITS files: each
    request empties the port's image cache first, so every command
    decodes (the OS page cache stays warm), and writes new files into an
    empty output directory under TMPDIR; a kept request's directory is
    moved aside.

    The last command's files are deleted before the next command, most
    often before the OS has written them back, and no command truncates
    a file in place (which makes some file systems start the writeback
    at once): a run's outputs then cost the machine's disk next to
    nothing."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.api = importlib.import_module("astroburst_tpu_torch.api")
        self.cache = importlib.import_module(
            "astroburst_tpu_torch.runtime.cache").GLOBAL_IMAGE_CACHE
        self.out = os.path.join(ctx.out_root, "current")

    def request(self):
        self.cache.clear()
        shutil.rmtree(self.out, ignore_errors=True)
        return self.command()

    def command(self):
        raise NotImplementedError

    def keep(self, res, index: int):
        kept = os.path.join(self.ctx.out_root, f"kept-{index}")
        os.replace(self.out, kept)
        return res, kept

    def release(self) -> None:
        self.cache.clear()
        super().release()

    def close(self) -> None:
        shutil.rmtree(self.ctx.out_root, ignore_errors=True)
