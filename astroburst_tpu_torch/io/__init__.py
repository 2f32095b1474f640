"""Host-side I/O: FITS and ASDF decode, file dispatch, PNG encode
(counterpart of astroburst_tpu/io; reference: src-tauri/src/infra/).

Decode runs on the host with numpy over a memory map; io/prefetch.py
puts the planes on the device through pinned host memory. ASDF files
are read by ``io.asdf`` (PyYAML, imported only when an ASDF tree is
parsed).
"""

from astroburst_tpu_torch.io.dispatcher import (resolve_inputs,
                                                resolve_single_image)
from astroburst_tpu_torch.io.fits_reader import (FitsCube, FitsImage,
                                                 FitsRgb, extract_cube,
                                                 extract_image,
                                                 extract_image_by_index,
                                                 list_extensions,
                                                 try_extract_rgb)
from astroburst_tpu_torch.io.fits_writer import (write_fits_mono,
                                                 write_fits_rgb)
from astroburst_tpu_torch.io.header import HduHeader, HduInfo
from astroburst_tpu_torch.io.png import (encode_gray_png, save_gray_png,
                                         save_rgb_png)

__all__ = [
    "HduHeader", "HduInfo", "FitsImage", "FitsRgb", "FitsCube",
    "extract_image", "extract_cube",
    "extract_image_by_index", "try_extract_rgb", "list_extensions",
    "write_fits_mono", "write_fits_rgb", "encode_gray_png", "save_gray_png",
    "save_rgb_png",
    "resolve_single_image", "resolve_inputs",
]
