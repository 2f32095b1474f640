"""Output-dir commands (counterpart of astroburst_tpu/api/output.py;
reference: src-tauri/src/cmd/output.rs). They touch only the output
directory; ``device`` is taken, as by every command of the port, and
resolved first (``cuda_device()`` raises where there is no card).
"""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch.runtime import output as out
from astroburst_tpu_torch.runtime.config import load_config
from astroburst_tpu_torch.runtime.device import device_or_cuda


def get_output_dir_info(output_dir: str = "", *,
                        device: Optional[torch.device] = None) -> dict:
    """cmd/output.rs:109."""
    device_or_cuda(device)
    directory = out.resolve_output_dir(output_dir)
    return out.output_dir_info(directory)


def cleanup_output_cmd(output_dir: str = "",
                       enforce_lru: Optional[bool] = None, *,
                       device: Optional[torch.device] = None) -> dict:
    """cmd/output.rs:122 — full cleanup, or size-capped LRU enforcement."""
    device_or_cuda(device)
    directory = out.resolve_output_dir(output_dir)
    if enforce_lru:
        max_bytes = load_config().output_max_bytes
        return out.enforce_output_lru(directory, max_bytes)
    return out.cleanup_output(directory)
