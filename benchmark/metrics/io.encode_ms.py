"""io.encode_ms: milliseconds a command spends writing its outputs (the
FITS write and the preview PNG), from spans around the writers."""

from benchmark.core.layers import span_ms_per_request

SPANS = ["astroburst_tpu_torch.api.stacking:write_fits_mono",
         "astroburst_tpu_torch.api.helpers:save_stf_preview_png"]


def read(run):
    return span_ms_per_request(run, SPANS)
