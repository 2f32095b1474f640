"""io.png.deflate_mb_per_s: zlib's rate on the preview PNGs: the bytes
handed to zlib inside the window (the port's counter
``io.png.raw_bytes``), in 10^6 bytes, over the seconds of the port's
``io.png.deflate`` spans there."""

from benchmark.core import program_spans

program_spans.arm()


def read(run):
    seconds = program_spans.span_s(run, ["io.png.deflate"])
    raw = program_spans.count(run, "io.png.raw_bytes")
    if not seconds or raw is None:
        return None
    return raw / 1e6 / seconds
