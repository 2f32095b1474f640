"""io.decode_ms: milliseconds a command spends loading its files (FITS
decode by the host codec, the copy to the card, the statistics), from
spans around the cached loaders."""

from benchmark.core.layers import span_ms_per_request

SPANS = ["astroburst_tpu_torch.api.stacking:load_cached_many",
         "astroburst_tpu_torch.api.io:load_cached_full"]


def read(run):
    return span_ms_per_request(run, SPANS)
