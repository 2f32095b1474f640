"""The run's environment, set before torch is imported.

Every build and kernel cache lives at a fixed path inside the
checkout, so only the first run of a cell in a checkout builds: the
port's own libraries already build under ``build/astroburst_tpu_torch/``;
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` point under
``build/`` too, in case a library the port uses compiles. ``USE_FLAX``
keeps ``transformers``, should anything load it, away from JAX.
"""

from __future__ import annotations

import os


def prepare(root: str) -> None:
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"
