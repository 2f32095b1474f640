"""The command API of the port (counterpart of astroburst_tpu.api, the
reference's Tauri commands): the same names, arguments, defaults and
response keys, plus a keyword-only ``device`` (default
``cuda_device()``). Ported so far: ``stack``.
"""

from astroburst_tpu_torch.api.stacking import stack

__all__ = ["stack"]
