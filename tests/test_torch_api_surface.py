"""PyTorch port: the command surface (A15). ``astroburst_tpu_torch.api``
serves all 60 commands the reference registers (lib.rs:116-177), each
with the JAX package's parameters, kinds and defaults plus a keyword-only
``device=None``; the port's constants are a superset of the JAX
package's, every shared name with an equal value. Exact comparisons
only: these are names and values, not numerics.
"""

import inspect

import pytest

from astroburst_tpu import api as japi
from astroburst_tpu import constants as jc
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import constants as tc

# a copy of tests/test_api_surface.py:16-38
REGISTERED_COMMANDS = [
    "process_fits", "process_fits_full", "get_raw_pixels_preview",
    "export_fits", "export_fits_rgb", "export_png", "export_rgb_png",
    "compose_rgb_cmd", "get_header", "get_full_header",
    "get_fits_extensions", "get_header_by_hdu", "detect_narrowband_filters",
    "compute_histogram", "compute_fft_spectrum", "detect_stars",
    "detect_stars_composite", "analyze_subframes_cmd", "apply_stf_render",
    "generate_tiles", "generate_tiles_rgb", "calibrate", "stack",
    "run_pipeline_cmd", "restretch_composite_cmd",
    "clear_composite_cache_cmd", "export_aligned_channels_cmd",
    "update_composite_channel_cmd", "blend_channels_cmd",
    "align_channels_cmd", "crop_channels_cmd", "calibrate_and_scnr_cmd",
    "compute_auto_wb_cmd", "reset_wb_cmd", "resample_fits_cmd",
    "deconvolve_rl_cmd", "extract_background_cmd", "wavelet_denoise_cmd",
    "apply_arcsinh_stretch_cmd", "masked_stretch_cmd",
    "arcsinh_stretch_composite_cmd", "masked_stretch_composite_cmd",
    "apply_tone_composite_cmd", "process_cube_cmd", "process_cube_lazy_cmd",
    "get_cube_info", "get_cube_frame", "get_cube_spectrum",
    "plate_solve_cmd", "get_wcs_info", "estimate_psf_cmd",
    "spcc_calibrate_cmd", "get_config", "update_config", "save_api_key",
    "get_api_key", "generate_synth_cmd", "generate_synth_stack_cmd",
    "get_output_dir_info", "cleanup_output_cmd",
]
UNREGISTERED = ["compute_histogram_cmd", "drizzle_stack_cmd",
                "export_zip_bundle"]


def test_all_60_registered_commands_are_exported():
    assert len(set(REGISTERED_COMMANDS)) == 60
    assert sorted(tapi.__all__) == sorted(REGISTERED_COMMANDS + UNREGISTERED)
    assert all(callable(getattr(tapi, name)) for name in tapi.__all__)


@pytest.mark.parametrize("name", REGISTERED_COMMANDS + UNREGISTERED)
def test_command_has_the_jax_signature_plus_device(name):
    got = list(inspect.signature(getattr(tapi, name)).parameters.values())
    want = list(inspect.signature(getattr(japi, name)).parameters.values())
    assert [p.name for p in got[:-1]] == [q.name for q in want]
    for p, q in zip(got[:-1], want):
        assert (p.kind, p.default) == (q.kind, q.default), (name, p.name)
    assert (got[-1].name, got[-1].kind, got[-1].default) == \
        ("device", inspect.Parameter.KEYWORD_ONLY, None)


def test_port_constants_are_a_superset_of_the_jax_package_s():
    names = [n for n in vars(jc) if n.isupper()]
    assert len(names) > 200
    missing = [n for n in names if not hasattr(tc, n)]
    assert not missing, missing
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n
        assert type(getattr(tc, n)) is type(getattr(jc, n)), n
