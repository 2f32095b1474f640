"""Constants the port uses (its own copy of the values in
astroburst_tpu/constants.py; tests/test_torch_ops.py holds them equal).
"""

PADDING_THRESHOLD = 1e-7   # pixels <= this (or non-finite) are invalid
MAD_TO_SIGMA = 1.4826      # robust sigma = MAD * 1.4826

# drizzle defaults (drizzle.rs)
DEFAULT_DRIZZLE_SCALE = 2.0
DEFAULT_DRIZZLE_PIXFRAC = 0.7
DEFAULT_DRIZZLE_SIGMA = 3.0
DEFAULT_DRIZZLE_SIGMA_ITERS = 5
KERNEL_GAUSSIAN = "gaussian"
KERNEL_LANCZOS3 = "lanczos3"
KERNEL_LANCZOS = "lanczos"
