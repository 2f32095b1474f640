"""Records the port uses (its own copy of the types in
astroburst_tpu/dtypes.py, reference: src-tauri/src/types/{image,
stacking}.rs; tests/test_torch_ops.py holds them equal). Scalar fields
are host floats; pixel data never lives in these records.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import List, Optional

from astroburst_tpu_torch import constants as C


# --- image statistics (types/image.rs:1-24) -------------------------------


@dataclass(frozen=True)
class ImageStats:
    min: float = 0.0
    max: float = 0.0
    median: float = 0.0
    mad: float = 0.0
    sigma: float = 0.0
    mean: float = 0.0
    valid_count: int = 0

    def to_dict(self) -> dict:
        return {
            C.RES_MIN: self.min,
            C.RES_MAX: self.max,
            C.RES_MEDIAN: self.median,
            C.RES_MAD: self.mad,
            C.RES_SIGMA: self.sigma,
            C.RES_MEAN: self.mean,
            "valid_count": self.valid_count,
        }


@dataclass(frozen=True)
class Histogram:
    """Value histogram (types/image.rs:26-32). bins are counts."""

    bins: List[int]
    bin_edges: List[float]
    min: float
    max: float

    def to_dict(self) -> dict:
        return {
            C.RES_BINS: list(self.bins),
            C.RES_BIN_EDGES: list(self.bin_edges),
            C.RES_MIN: self.min,
            C.RES_MAX: self.max,
        }


# --- STF (types/image.rs:34-64) --------------------------------------------


@dataclass(frozen=True)
class StfParams:
    shadow: float = 0.0
    midtone: float = 0.5
    highlight: float = 1.0

    def to_dict(self) -> dict:
        return {
            C.RES_SHADOW: self.shadow,
            C.RES_MIDTONE: self.midtone,
            C.RES_HIGHLIGHT: self.highlight,
        }


@dataclass(frozen=True)
class AutoStfConfig:
    target_bg: float = 0.25
    shadow_k: float = -2.8


# --- SCNR (types/image.rs:66-96) -------------------------------------------


class ScnrMethod(str, enum.Enum):
    AVERAGE_NEUTRAL = "average"
    MAXIMUM_NEUTRAL = "maximum"

    @staticmethod
    def parse(s: Optional[str]) -> "ScnrMethod":
        if s and s.lower().startswith("max"):
            return ScnrMethod.MAXIMUM_NEUTRAL
        return ScnrMethod.AVERAGE_NEUTRAL


@dataclass(frozen=True)
class ScnrConfig:
    method: ScnrMethod = ScnrMethod.AVERAGE_NEUTRAL
    amount: float = 1.0
    preserve_luminance: bool = False


class AlignMethod(str, enum.Enum):
    PHASE_CORRELATION = "phase_correlation"
    AFFINE = "affine"

    @staticmethod
    def parse(s: Optional[str]) -> "AlignMethod":
        if s and s.lower().startswith("aff"):
            return AlignMethod.AFFINE
        return AlignMethod.PHASE_CORRELATION


# --- compose (types/compose.rs) --------------------------------------------


class WhiteBalanceMode(str, enum.Enum):
    AUTO = "auto"
    MANUAL = "manual"
    NONE = "none"


@dataclass(frozen=True)
class WhiteBalance:
    mode: WhiteBalanceMode = WhiteBalanceMode.AUTO
    r: float = 1.0
    g: float = 1.0
    b: float = 1.0


@dataclass(frozen=True)
class RgbComposeConfig:
    """``linked_stf`` defaults to True here, as in the JAX package;
    ``compose_rgb_cmd`` passes False when the caller gives None."""
    white_balance: WhiteBalance = field(default_factory=WhiteBalance)
    align: bool = True
    align_method: AlignMethod = AlignMethod.PHASE_CORRELATION
    auto_stretch: bool = True
    linked_stf: bool = True
    stf_r: Optional[StfParams] = None
    stf_g: Optional[StfParams] = None
    stf_b: Optional[StfParams] = None
    scnr: Optional[ScnrConfig] = None
    auto_stf: AutoStfConfig = field(default_factory=AutoStfConfig)


class AlignmentMethod(str, enum.Enum):
    NONE = "none"
    PHASE_CORRELATION = "phase_correlation"
    AFFINE = "affine"
    # Zncc is vestigial in the reference (types/stacking.rs:31); it routes
    # to Affine (core/stacking/drizzle.rs:302-306).
    ZNCC = "zncc"

    @staticmethod
    def parse(s: Optional[str]) -> "AlignmentMethod":
        if not s:
            return AlignmentMethod.PHASE_CORRELATION
        t = s.lower()
        if t.startswith("aff") or t == "zncc":
            return AlignmentMethod.AFFINE
        if t == "none":
            return AlignmentMethod.NONE
        return AlignmentMethod.PHASE_CORRELATION


@dataclass(frozen=True)
class StackConfig:
    sigma_low: float = 3.0
    sigma_high: float = 3.0
    max_iterations: int = 5
    align: bool = True
    alignment_method: AlignmentMethod = AlignmentMethod.PHASE_CORRELATION


class DrizzleKernel(str, enum.Enum):
    SQUARE = "square"
    GAUSSIAN = "gaussian"
    LANCZOS3 = "lanczos3"

    @staticmethod
    def parse(s: Optional[str]) -> "DrizzleKernel":
        if not s:
            return DrizzleKernel.SQUARE
        t = s.lower()
        if t == C.KERNEL_GAUSSIAN:
            return DrizzleKernel.GAUSSIAN
        if t in (C.KERNEL_LANCZOS3, C.KERNEL_LANCZOS):
            return DrizzleKernel.LANCZOS3
        return DrizzleKernel.SQUARE


@dataclass(frozen=True)
class DrizzleConfig:
    scale: float = C.DEFAULT_DRIZZLE_SCALE
    pixfrac: float = C.DEFAULT_DRIZZLE_PIXFRAC
    kernel: DrizzleKernel = DrizzleKernel.SQUARE
    sigma_low: float = C.DEFAULT_DRIZZLE_SIGMA
    sigma_high: float = C.DEFAULT_DRIZZLE_SIGMA
    sigma_iterations: int = C.DEFAULT_DRIZZLE_SIGMA_ITERS
    align: bool = True
    alignment_method: AlignmentMethod = AlignmentMethod.PHASE_CORRELATION


# --- app config (types/config.rs) ------------------------------------------


@dataclass
class AppConfig:
    astrometry_api_key: str = ""
    astrometry_api_url: str = C.DEFAULT_ASTROMETRY_API_URL
    output_dir: str = ""
    plate_solve_timeout_secs: int = 120
    plate_solve_max_stars: int = 200
    auto_stretch_target_bg: float = 0.25
    auto_stretch_shadow_k: float = -2.8
    output_max_bytes: int = C.DEFAULT_OUTPUT_MAX_BYTES

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AppConfig":
        cfg = AppConfig()
        for f in dataclasses.fields(AppConfig):
            if f.name in d and d[f.name] is not None:
                setattr(cfg, f.name, f.type(d[f.name]) if not isinstance(
                    d[f.name], (int, float, str)) else d[f.name])
        return cfg
