"""App configuration store (its own copy of
astroburst_tpu/runtime/config.py; reference: src-tauri/src/infra/config.rs
— a JSON config at the platform config dir, field-level updates, API
keys in side files).

The files are the JAX package's: ``config.json`` and ``<service>.key``
in ``config_dir()``, so each package reads what the other wrote.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from astroburst_tpu_torch.dtypes import AppConfig

_LOCK = threading.Lock()


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


def save_config(cfg: AppConfig) -> None:
    """Atomic write: a ``.tmp`` file, then ``os.replace``."""
    with _LOCK:
        os.makedirs(config_dir(), exist_ok=True)
        tmp = config_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cfg.to_dict(), f, indent=2)
        os.replace(tmp, config_path())


def update_config_field(field: str, value) -> AppConfig:
    """Field-level update (config.rs:44); an unknown field is a
    KeyError."""
    cfg = load_config()
    if not hasattr(cfg, field):
        raise KeyError(f"unknown config field: {field}")
    setattr(cfg, field, value)
    save_config(cfg)
    return cfg


def _key_path(service: str) -> str:
    return os.path.join(config_dir(), f"{service}.key")


def save_api_key(service: str, key: str) -> None:
    """API keys live in side files of mode 0o600, not in the main config
    (config.rs:57-75)."""
    with _LOCK:
        os.makedirs(config_dir(), exist_ok=True)
        with open(_key_path(service), "w") as f:
            f.write(key)
        os.chmod(_key_path(service), 0o600)


def get_api_key(service: str) -> Optional[str]:
    path = _key_path(service)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()
