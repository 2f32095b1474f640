"""stretch.masked.mtf.roofline_pct: the MTF loops' share of their bytes
roofline. The bytes are those the loops' work needs, per pixel: each
loop's normalisation 8 (the plane read, the working plane written),
each of its iterations' masked medians 8 (the working plane and the mask
read), each blend it keeps 12 (the working plane and the mask read, the
result written) and, only for a loop that ran out without stopping on
its test, a final median 8. A loop that stops keeps no blend of its last
iteration and needs no final median, since its last median is that of
the plane it returns. So a loop of i iterations needs 20 i - 4 bytes a
pixel when it stops and 20 i + 16 when it runs out. The port's counters
inside the window give the loops (``stretch.masked.loops``), their
iterations (``stretch.masked.iterations``) and those that ran out
(``stretch.masked.ran_out``), so a rewrite that does the same work reads
the same bytes. Over the card's published HBM rate, divided by the
device-busy time inside the ``stretch.masked.mtf`` spans."""

from benchmark.core import program_spans
from benchmark.core.peaks import PEAKS

program_spans.arm()


def op_bytes(data: dict, loops: int, iterations: int, ran_out: int) -> int:
    return data["sw_height"] * data["sw_width"] * (
        20 * iterations - 4 * loops + 20 * ran_out)


def read(run):
    win = program_spans.window(run)
    iv = win.intervals(["stretch.masked.mtf"]) if win is not None else None
    counts = [program_spans.count(run, "stretch.masked." + name)
              for name in ("loops", "iterations", "ran_out")]
    if iv is None or None in counts or run.device_kind not in PEAKS:
        return None
    starts, ends = iv
    busy = float(run.trace.busy_ns(starts, ends).sum()) * 1e-9
    if busy <= 0:
        return None
    least = op_bytes(run.cell.config["data"], *counts) \
        / PEAKS[run.device_kind]["hbm_bytes_per_s"]
    return 100.0 * least / busy
