"""Device policy.

The port runs on one CUDA device. ``cuda_device`` returns it or
raises: nothing falls back to the CPU. Tests pass
``torch.device("cpu")`` explicitly, and every kernel wrapper then runs
its plain torch version (see ``runtime/kernels.py``).

TF32 is switched off here, once for the process: it keeps about three
decimal digits, which would break the repo's 1e-5 parity budget
(BASELINE.md). This module is imported by the package ``__init__``.
"""

from __future__ import annotations

from typing import Optional

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def cuda_device() -> torch.device:
    """The CUDA device the port runs on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "astroburst_tpu_torch needs a CUDA device and none is "
            "available; pass device=torch.device('cpu') explicitly to run "
            "the plain torch versions")
    return torch.device("cuda")


def device_or_cuda(device=None) -> torch.device:
    """``device`` as a torch.device, or ``cuda_device()`` when None."""
    return torch.device(device) if device is not None else cuda_device()


def tf32_disabled() -> bool:
    """True when neither matmul nor cuDNN may use TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32)


def as_f32(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """``x`` (a tensor or an array) as an f32 tensor on ``device``;
    by default a tensor's own device, else ``cuda_device()``."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else cuda_device()
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def as_f32_all(*xs, device: Optional[torch.device] = None):
    """Each of ``xs`` through ``as_f32`` onto one device: ``device``,
    else the first tensor's, else ``cuda_device()``."""
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                      None)
    return [as_f32(x, device) for x in xs]
