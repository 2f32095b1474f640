"""Host-side I/O: FITS decode and encode, file dispatch, PNG encode
(counterpart of astroburst_tpu/io; reference: src-tauri/src/infra/).

Decode runs on the host with numpy over a memory map; io/prefetch.py
puts the planes on the device through pinned host memory. ASDF input
is not ported yet (io/dispatcher.py refuses it).
"""

from astroburst_tpu_torch.io.dispatcher import (resolve_inputs,
                                                resolve_single_image)
from astroburst_tpu_torch.io.fits_reader import FitsImage, extract_image
from astroburst_tpu_torch.io.fits_writer import (write_fits_mono,
                                                 write_fits_rgb)
from astroburst_tpu_torch.io.header import HduHeader, HduInfo
from astroburst_tpu_torch.io.png import save_gray_png, save_rgb_png

__all__ = [
    "HduHeader", "HduInfo", "FitsImage", "extract_image",
    "write_fits_mono", "write_fits_rgb", "save_gray_png", "save_rgb_png",
    "resolve_single_image", "resolve_inputs",
]
