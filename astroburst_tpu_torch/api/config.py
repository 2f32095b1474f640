"""Config commands (counterpart of astroburst_tpu/api/config.py;
reference: src-tauri/src/cmd/config.rs).

They touch only the host's config files, but each takes a keyword-only
``device`` and resolves it first (``cuda_device()`` raises where there
is no card), as every command of the port does.
"""

from __future__ import annotations

from typing import Optional

import torch

from astroburst_tpu_torch import constants as C
from astroburst_tpu_torch.runtime import config as cfg
from astroburst_tpu_torch.runtime.device import device_or_cuda


def get_config(*, device: Optional[torch.device] = None) -> dict:
    """cmd/config.rs:8."""
    device_or_cuda(device)
    return cfg.load_config().to_dict()


def update_config(field: str, value, *,
                  device: Optional[torch.device] = None) -> dict:
    """cmd/config.rs:16 — field-level update."""
    device_or_cuda(device)
    return cfg.update_config_field(field, value).to_dict()


def save_api_key(key: str, service: Optional[str] = None, *,
                 device: Optional[torch.device] = None) -> dict:
    """cmd/config.rs:24."""
    device_or_cuda(device)
    svc = service or C.DEFAULT_API_KEY_SERVICE
    cfg.save_api_key(svc, key)
    return {C.RES_SAVED: True, C.RES_SERVICE: svc}


def get_api_key(service: Optional[str] = None, *,
                device: Optional[torch.device] = None) -> dict:
    """cmd/config.rs:33."""
    device_or_cuda(device)
    svc = service or C.DEFAULT_API_KEY_SERVICE
    key = cfg.get_api_key(svc)
    return {C.RES_SERVICE: svc, "api_key": key or ""}
