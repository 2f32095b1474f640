"""astroburst_tpu_torch — the PyTorch/CUDA port of astroburst_tpu.

The JAX package ``astroburst_tpu`` stays the reference; this package
reproduces its semantics on torch tensors. Plain tensor code is torch
(cuFFT through ``torch.fft``, ``torch.sort``, elementwise ops); every
Pallas kernel of the ported slice is a CUDA C++ kernel for Hopper
(``csrc/``, built with nvcc for ``sm_90a`` at first use and bound with
ctypes, see ``runtime/kernels.py``).

Ported slices: align → stack → stretch
(``parallel.pipeline.align_stack_stretch`` and
``stacking.combine.stack_images``), calibrate → drizzle → stretch
(``stacking.calibration``, ``stacking.drizzle.drizzle_stack``) and star
detection → affine alignment → warp (``analysis.detect_stars``,
``alignment.affine.align_channel_affine`` and ``warp_image``,
``alignment.pair.align_pair``; on the card the fused one-fetch chain
``alignment.fused_chain``), star mask → masked stretch
(``imaging.masked_stretch``, ``imaging.star_mask``) and the parity
drizzle (``stacking.drizzle.drizzle_exact_parity``). Every Pallas
kernel of the JAX package has its CUDA counterpart. Of the command API,
13 commands are ported (``api``): ``stack`` and the open-and-inspect
commands (``process_fits``, its histogram and header, the raw preview,
``apply_stf_render``, the header and output-dir commands), FITS, RGB
FITS and ASDF in (``io``), the images in the port's own image cache
(``runtime.cache``). Every FITS decode and the BITPIX 16 and -32 writes
run in the host codec (``native``: C++/OpenMP, built with g++ at first
use).

The package imports neither ``jax`` nor anything of ``astroburst_tpu``:
the constants, records, errors and io it needs are its own copies
(``constants``, ``dtypes``, ``errors``, ``ops.window``, ``io``), held
equal to the JAX package's by tests/test_torch_ops.py and
tests/test_torch_io.py.
"""

__version__ = "0.1.0"

from astroburst_tpu_torch.runtime import device as _device  # noqa: F401  (TF32 off)
