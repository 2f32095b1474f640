"""Constants the port uses (its own copy of the values in
astroburst_tpu/constants.py; tests/test_torch_ops.py holds them equal).
"""

# --- FITS layout ---------------------------------------------------------
BLOCK_SIZE = 2880
CARD_SIZE = 80

PADDING_THRESHOLD = 1e-7   # pixels <= this (or non-finite) are invalid
MAD_TO_SIGMA = 1.4826      # robust sigma = MAD * 1.4826
HISTOGRAM_BINS_DISPLAY = 512

DEFAULT_STEM = "bg"

# --- progress event names -------------------------------------------------
PROGRESS_EVENT = "background-progress"
EVENT_STACK_PROGRESS = "stack-progress"
EVENT_DRIZZLE_RGB_PROGRESS = "drizzle-rgb-progress"
EVENT_WAVELET_PROGRESS = "wavelet-progress"
EVENT_DECONV_PROGRESS = "deconv-progress"
PROGRESS_STEPS = 4

# --- response keys of the ported commands (the public API contract) -------
RES_ELAPSED_MS = "elapsed_ms"
RES_DIMENSIONS = "dimensions"
RES_OUTPUT_DIMS = "output_dims"
RES_INPUT_DIMS = "input_dims"
RES_ORIGINAL_DIMENSIONS = "original_dimensions"
RES_PNG_PATH = "png_path"
RES_FITS_PATH = "fits_path"
RES_OUTPUT_PATH = "output_path"
RES_CORRECTED_PNG = "corrected_png"
RES_MODEL_PNG = "model_png"
RES_CORRECTED_FITS = "corrected_fits"
RES_PATH = "path"
RES_WCS_UPDATES = "wcs_updates"
RES_FILE_PATH = "file_path"
RES_FILE_NAME = "file_name"
RES_MIN = "min"
RES_MAX = "max"
RES_DATA_MIN = "data_min"
RES_DATA_MAX = "data_max"
RES_MEDIAN = "median"
RES_MEAN = "mean"
RES_SIGMA = "sigma"
RES_MAD = "mad"
RES_TOTAL_PIXELS = "total_pixels"
RES_STATS = "stats"
RES_AUTO_STF = "auto_stf"
RES_STF = "stf"
RES_SHADOW = "shadow"
RES_MIDTONE = "midtone"
RES_HIGHLIGHT = "highlight"
RES_HISTOGRAM = "histogram"
RES_BINS = "bins"
RES_BIN_COUNT = "bin_count"
RES_BIN_EDGES = "bin_edges"
RES_SAMPLE_COUNT = "sample_count"
RES_RMS_RESIDUAL = "rms_residual"
RES_ITERATIONS_RUN = "iterations_run"
RES_STRETCH_FACTOR = "stretch_factor"
RES_SCALES_PROCESSED = "scales_processed"
RES_NOISE_ESTIMATE = "noise_estimate"
RES_SCNR_APPLIED = "scnr_applied"
RES_FRAMES = "frames"
RES_FRAME_COUNT = "frame_count"
RES_REJECTED_PIXELS = "rejected_pixels"
RES_OFFSETS = "offsets"
RES_SCALE = "scale"
RES_HAS_BIAS = "has_bias"
RES_HAS_DARK = "has_dark"
RES_HAS_FLAT = "has_flat"
RES_BITPIX = "bitpix"
RESAMPLED = "resampled"
CHANNELS = "channels"
COPY_WCS = "copy_wcs"
RES_FILE_SIZE_BYTES = "file_size_bytes"
RES_APPLY_STF = "apply_stf"
RES_COPY_METADATA = "copy_metadata"
RES_BIT_DEPTH = "bit_depth"
RES_LABEL = "label"
RES_CONVERGENCE = "convergence"
SUFFIX_DECONV = "deconv"

# --- cubes (api/cube.py) ----------------------------------------------------
RES_NAXIS1 = "naxis1"
RES_NAXIS2 = "naxis2"
RES_NAXIS3 = "naxis3"
RES_FRAME_INDEX = "frame_index"
RES_SPECTRUM = "spectrum"
RES_SPECTRAL_CLASSIFICATION = "spectral_classification"
RES_WAVELENGTHS = "wavelengths"
RES_X = "x"
RES_Y = "y"
RES_WIDTH = "width"
RES_HEIGHT = "height"
RES_KERNEL_SIZE = "kernel_size"
RES_AVERAGE_FWHM = "average_fwhm"
RES_AVERAGE_ELLIPTICITY = "average_ellipticity"
RES_SPREAD_PIXELS = "spread_pixels"
RES_STARS_USED = "stars_used"
RES_STARS_REJECTED = "stars_rejected"
RES_KERNEL = "kernel"
RES_STARS_MASKED = "stars_masked"
RES_MASK_COVERAGE = "mask_coverage"
RES_FINAL_BACKGROUND = "final_background"
RES_CONVERGED = "converged"
SUFFIX_MASKED_STRETCH = "masked_stretch"
RES_COMPOSITE_DIMS = "composite_dims"
RES_CURVES_APPLIED = "curves_applied"
RES_LEVELS_APPLIED = "levels_applied"
RES_STF_APPLIED = "stf_applied"

# --- compose (api/compose.py) ---------------------------------------------
MAX_DIMENSION_RATIO = 8.0
WB_MODE_MANUAL = "manual"
WB_MODE_NONE = "none"
LRGB_APPLIED = "lrgb_applied"
DIMENSIONS = "dimensions"
ALIGN_METHOD = "align_method"
RES_STATS_R = "stats_r"
RES_STATS_G = "stats_g"
RES_STATS_B = "stats_b"
RES_OFFSET_G = "offset_g"
RES_OFFSET_B = "offset_b"
RES_DIMENSION_INFO = "dimension_info"
RES_CHANNEL_COUNT = "channel_count"
RES_CONFIDENCE = "confidence"
RES_CHANNEL = "channel"
RES_OFFSET = "offset"
RES_R_FACTOR = "r_factor"
RES_G_FACTOR = "g_factor"
RES_B_FACTOR = "b_factor"
RES_BLEND_PRESET = "blend_preset"
RES_WB_APPLIED = "wb_applied"
RES_CACHE_KEYS = "cache_keys"
RES_PERSIST_TO_DISK = "persist_to_disk"

RES_HEADER = "header"
RES_CARDS = "cards"
RES_TOTAL_CARDS = "total_cards"
RES_CATEGORIES = "categories"
RES_KEY = "key"
RES_VALUE = "value"
RES_EXTENSIONS = "extensions"
RES_INDEX = "index"
RES_FILTER_DETECTION = "filter_detection"
RES_FILTERS = "filters"
RES_FILENAME_HINT = "filename_hint"
RES_PALETTE = "palette"
DEFAULT_ASTROMETRY_API_URL = "https://nova.astrometry.net"
DEFAULT_SCNR_AMOUNT = 1.0

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
COMPOSITE_KEY_R = "__composite_r"
COMPOSITE_KEY_G = "__composite_g"
COMPOSITE_KEY_B = "__composite_b"

COMPOSITE_ORIG_R = "__composite_orig_r"
COMPOSITE_ORIG_G = "__composite_orig_g"
COMPOSITE_ORIG_B = "__composite_orig_b"

STF_R = "stf_r"
STF_G = "stf_g"
STF_B = "stf_b"

WIZARD_CACHE_PREFIX = "__wizard_ch_"
STAR_MASK_KEY = "__star_mask"


def wizard_cache_key(bin_id: str, stage: str) -> str:
    return f"{WIZARD_CACHE_PREFIX}{bin_id}{stage}"


def wizard_aligned_key(bin_id: str) -> str:
    return wizard_cache_key(bin_id, "_aligned")


def wizard_cropped_key(bin_id: str) -> str:
    return wizard_cache_key(bin_id, "_cropped")
