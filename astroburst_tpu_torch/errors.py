"""Errors the port raises (its own copy of astroburst_tpu/errors.py's
InvalidInput; reference: src-tauri/src/types/error.rs)."""


class InvalidInput(Exception):
    """Bad arguments to a command."""
