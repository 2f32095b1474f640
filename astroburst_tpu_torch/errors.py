"""Errors the port raises (its own copy of astroburst_tpu/errors.py;
reference: src-tauri/src/types/error.rs)."""


class AstroError(Exception):
    """Base error for astroburst_tpu_torch."""


class FitsError(AstroError):
    """Malformed or unsupported FITS data."""


class AsdfError(AstroError):
    """Malformed or unsupported ASDF data."""


class InvalidInput(AstroError):
    """Bad arguments to a command."""


class Cancelled(AstroError):
    """Operation cancelled via a ProgressHandle (error.rs:29)."""

    def __init__(self, msg: str = "operation cancelled"):
        super().__init__(msg)


class CacheMiss(AstroError):
    """Requested cache key not present."""


class SolveError(AstroError):
    """Plate solving failed."""
