"""App configuration, read side (its own copy of ``config_dir``,
``config_path`` and ``load_config`` of astroburst_tpu/runtime/config.py;
reference: src-tauri/src/infra/config.rs — a JSON config at the
platform config dir). The output-dir LRU command reads its byte cap
here; the config commands that write it are not ported yet.
"""

from __future__ import annotations

import json
import os

from astroburst_tpu_torch.dtypes import AppConfig


def config_dir() -> str:
    base = os.environ.get("ASTROBURST_CONFIG_DIR")
    if base:
        return base
    xdg = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    return os.path.join(xdg, "astroburst")


def config_path() -> str:
    return os.path.join(config_dir(), "config.json")


def load_config() -> AppConfig:
    path = config_path()
    if not os.path.exists(path):
        return AppConfig()
    try:
        with open(path) as f:
            return AppConfig.from_dict(json.load(f))
    except (json.JSONDecodeError, OSError, TypeError, ValueError):
        return AppConfig()
