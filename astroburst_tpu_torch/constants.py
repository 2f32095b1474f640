"""Constants the port uses (its own copy of the values in
astroburst_tpu/constants.py; tests/test_torch_ops.py holds them equal).
"""

# --- FITS layout ---------------------------------------------------------
BLOCK_SIZE = 2880
CARD_SIZE = 80

PADDING_THRESHOLD = 1e-7   # pixels <= this (or non-finite) are invalid
MAD_TO_SIGMA = 1.4826      # robust sigma = MAD * 1.4826

# --- progress event names -------------------------------------------------
EVENT_STACK_PROGRESS = "stack-progress"

# --- response keys of the ported commands (the public API contract) -------
RES_ELAPSED_MS = "elapsed_ms"
RES_DIMENSIONS = "dimensions"
RES_PNG_PATH = "png_path"
RES_FITS_PATH = "fits_path"
RES_MIN = "min"
RES_MAX = "max"
RES_MEDIAN = "median"
RES_MEAN = "mean"
RES_SIGMA = "sigma"
RES_MAD = "mad"
RES_STATS = "stats"
RES_SHADOW = "shadow"
RES_MIDTONE = "midtone"
RES_HIGHLIGHT = "highlight"
RES_FRAME_COUNT = "frame_count"
RES_REJECTED_PIXELS = "rejected_pixels"
RES_OFFSETS = "offsets"

# drizzle defaults (drizzle.rs)
DEFAULT_DRIZZLE_SCALE = 2.0
DEFAULT_DRIZZLE_PIXFRAC = 0.7
DEFAULT_DRIZZLE_SIGMA = 3.0
DEFAULT_DRIZZLE_SIGMA_ITERS = 5
KERNEL_GAUSSIAN = "gaussian"
KERNEL_LANCZOS3 = "lanczos3"
KERNEL_LANCZOS = "lanczos"

DEFAULT_OUTPUT_MAX_BYTES = 2 * 1024 * 1024 * 1024

# --- pinned cache keys (never evicted) ------------------------------------
WIZARD_CACHE_PREFIX = "__wizard_ch_"
STAR_MASK_KEY = "__star_mask"
