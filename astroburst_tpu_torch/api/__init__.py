"""The command API of the port (counterpart of astroburst_tpu.api, the
reference's Tauri commands): the same names, arguments, defaults and
response keys, plus a keyword-only ``device`` (default
``cuda_device()``, which raises where there is no card). Ported so
far, 53 of the 60 registered commands: the stacking commands
(``stack``, ``calibrate``, ``run_pipeline_cmd``), the export commands
(``export_fits``, ``export_fits_rgb``, ``export_png``,
``export_rgb_png``, ``resample_fits_cmd``), the open-and-inspect
commands (``process_fits``, ``process_fits_full``,
``get_raw_pixels_preview``, ``apply_stf_render``,
``compute_histogram_cmd`` and its alias ``compute_histogram``, the
header commands and the output-dir commands), the stretch, tone and
denoise commands (``apply_arcsinh_stretch_cmd``, ``masked_stretch_cmd``,
``arcsinh_stretch_composite_cmd``, ``masked_stretch_composite_cmd``,
``apply_tone_composite_cmd``, ``wavelet_denoise_cmd``,
``extract_background_cmd``) and the detection and analysis commands
(``detect_stars``, ``detect_stars_composite``,
``analyze_subframes_cmd``, ``estimate_psf_cmd``), the compose commands
(``compose_rgb_cmd``, ``restretch_composite_cmd``,
``clear_composite_cache_cmd``, ``update_composite_channel_cmd``,
``blend_channels_cmd``, ``align_channels_cmd``, ``crop_channels_cmd``,
``export_aligned_channels_cmd``, ``calibrate_and_scnr_cmd``,
``compute_auto_wb_cmd``, ``reset_wb_cmd``), the FFT and deconvolution
commands (``compute_fft_spectrum``, ``deconvolve_rl_cmd``), the cube
commands (``process_cube_cmd``, ``process_cube_lazy_cmd``,
``get_cube_info``, ``get_cube_frame``, ``get_cube_spectrum``), the
deep-zoom pyramids (``generate_tiles``, ``generate_tiles_rgb``) and the
synthetic fixtures (``generate_synth_cmd``,
``generate_synth_stack_cmd``); and two that the reference does not
register, ``drizzle_stack_cmd`` and ``export_zip_bundle``.
"""

from astroburst_tpu_torch.api.analysis import (analyze_subframes_cmd,
                                               compute_fft_spectrum,
                                               compute_histogram_cmd,
                                               detect_stars,
                                               detect_stars_composite)
from astroburst_tpu_torch.api.compose import (
    align_channels_cmd, blend_channels_cmd, calibrate_and_scnr_cmd,
    clear_composite_cache_cmd, compose_rgb_cmd, compute_auto_wb_cmd,
    crop_channels_cmd, export_aligned_channels_cmd, reset_wb_cmd,
    restretch_composite_cmd, update_composite_channel_cmd)
from astroburst_tpu_torch.api.cube import (get_cube_frame, get_cube_info,
                                           get_cube_spectrum,
                                           process_cube_cmd,
                                           process_cube_lazy_cmd)
from astroburst_tpu_torch.api.export import (export_fits, export_fits_rgb,
                                             export_png, export_rgb_png,
                                             export_zip_bundle)
from astroburst_tpu_torch.api.io import (get_raw_pixels_preview,
                                         process_fits, process_fits_full)
from astroburst_tpu_torch.api.metadata import (detect_narrowband_filters,
                                               get_fits_extensions,
                                               get_full_header, get_header,
                                               get_header_by_hdu)
from astroburst_tpu_torch.api.output import (cleanup_output_cmd,
                                             get_output_dir_info)
from astroburst_tpu_torch.api.processing import (
    apply_arcsinh_stretch_cmd, apply_tone_composite_cmd,
    arcsinh_stretch_composite_cmd, deconvolve_rl_cmd, extract_background_cmd,
    masked_stretch_cmd, masked_stretch_composite_cmd, resample_fits_cmd,
    wavelet_denoise_cmd)
from astroburst_tpu_torch.api.psf import estimate_psf_cmd
from astroburst_tpu_torch.api.stacking import (calibrate, drizzle_stack_cmd,
                                               run_pipeline_cmd, stack)
from astroburst_tpu_torch.api.synth import (generate_synth_cmd,
                                            generate_synth_stack_cmd)
from astroburst_tpu_torch.api.visualization import (apply_stf_render,
                                                    generate_tiles,
                                                    generate_tiles_rgb)

# alias matching the reference's registered name
compute_histogram = compute_histogram_cmd

__all__ = [
    "process_fits", "process_fits_full", "get_raw_pixels_preview",
    "get_header", "get_full_header", "get_fits_extensions",
    "get_header_by_hdu", "detect_narrowband_filters",
    "compute_histogram", "compute_histogram_cmd",
    "apply_stf_render", "stack", "calibrate", "run_pipeline_cmd",
    "drizzle_stack_cmd", "export_fits", "export_fits_rgb", "export_png",
    "export_rgb_png", "resample_fits_cmd", "export_zip_bundle",
    "get_output_dir_info", "cleanup_output_cmd",
    "wavelet_denoise_cmd", "apply_arcsinh_stretch_cmd",
    "masked_stretch_cmd", "arcsinh_stretch_composite_cmd",
    "masked_stretch_composite_cmd", "apply_tone_composite_cmd",
    "extract_background_cmd", "detect_stars", "detect_stars_composite",
    "analyze_subframes_cmd", "estimate_psf_cmd",
    "compose_rgb_cmd", "restretch_composite_cmd",
    "clear_composite_cache_cmd", "update_composite_channel_cmd",
    "blend_channels_cmd", "align_channels_cmd", "crop_channels_cmd",
    "export_aligned_channels_cmd", "calibrate_and_scnr_cmd",
    "compute_auto_wb_cmd", "reset_wb_cmd",
    "compute_fft_spectrum", "deconvolve_rl_cmd", "process_cube_cmd",
    "process_cube_lazy_cmd", "get_cube_info", "get_cube_frame",
    "get_cube_spectrum", "generate_tiles", "generate_tiles_rgb",
    "generate_synth_cmd", "generate_synth_stack_cmd",
]
