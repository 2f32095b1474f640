"""PyTorch port: narrowband filter discovery and palette suggestion
(``astroburst_tpu_torch.metadata``) against ``astroburst_tpu.metadata``
on the same headers and file names, and the categorised header browser
of ``get_full_header``. Host code only: every result equal.
"""

import numpy as np
import pytest
import torch

from astroburst_tpu import api as japi
from astroburst_tpu import metadata as jmeta
from astroburst_tpu.api import metadata as japi_meta
from astroburst_tpu.io.header import HduHeader as JHeader
from astroburst_tpu_torch import api as tapi
from astroburst_tpu_torch import metadata as tmeta
from astroburst_tpu_torch.api import metadata as tapi_meta
from astroburst_tpu_torch.io import write_fits_mono
from astroburst_tpu_torch.io.header import HduHeader
from astroburst_tpu_torch.metadata import header_discovery as thd
from astroburst_tpu.metadata import header_discovery as jhd
from astroburst_tpu_torch.runtime.cache import GLOBAL_IMAGE_CACHE

CPU = torch.device("cpu")

HEADERS = [
    [("FILTER", "H-alpha")],
    [("FILTER", "Ha_7nm")],
    [("FILTER1", "CLEAR"), ("FILTER2", "[OIII] 500.7")],
    [("INSTRUME", "SII camera")],
    [("OBJECT", "NGC 7000 O3")],
    [("MYFILT", "S2 3nm")],
    [("BANDNAME", "656nm")],
    [("LINEID", "[SII]")],
    [("WAVELEN", "6563.0")],
    [("CRVAL3", "502.0")],
    [("WAVELENG", "673.5")],
    [("WAVELEN", "550.0")],
    [("FILTER", "Luminance"), ("EXPTIME", "300")],
    [],
]

NAMES = ["m16_Ha.fits", "M16-OIII_001.fit", "ngc_s2_stack.fits",
         "frame_656.fits", "lum.fits", "x_H_ALPHA.fits", "502_d.fits"]


def _det(d):
    return None if d is None else d.to_dict()


@pytest.mark.parametrize("cards", HEADERS)
def test_detect_filter_matches_jax(cards):
    assert _det(tmeta.detect_filter(HduHeader(list(cards)))) == \
        _det(jmeta.detect_filter(JHeader(list(cards))))


@pytest.mark.parametrize("name", NAMES)
def test_detect_from_filename_matches_jax(name):
    assert _det(tmeta.detect_from_filename(name)) == \
        _det(jmeta.detect_from_filename(name))


@pytest.mark.parametrize("nm", [400.0, 495.0, 502.0, 510.1, 649.0, 656.3,
                                663.0, 665.0, 666.0, 673.0, 680.0, 6563.0,
                                5007.0, 6731.0])
def test_classify_wavelength_matches_jax(nm):
    t, j = thd.classify_wavelength_nm(nm), jhd.classify_wavelength_nm(nm)
    assert (t and t.value) == (j and j.value)


@pytest.mark.parametrize("palette", ["SHO", "HOO", "HOS", "NaturalColor",
                                     "Custom"])
def test_suggest_palette_matches_jax(palette):
    files = [(f"/d/{n}", cards) for n, cards in zip(
        NAMES, HEADERS[:len(NAMES)])]
    files += [("/d/extra_OIII.fits", [("FILTER", "OIII")]),
              ("/d/second_ha.fits", [("INSTRUME", "Ha cam")])]
    got = tmeta.suggest_palette_with_type(
        [(p, HduHeader(list(c))) for p, c in files],
        tmeta.PaletteType(palette))
    want = jmeta.suggest_palette_with_type(
        [(p, JHeader(list(c))) for p, c in files],
        jmeta.PaletteType(palette))
    assert got.to_dict() == want.to_dict()
    assert tmeta.suggest_palette([(p, HduHeader(list(c))) for p, c in
                                  files]).to_dict() == \
        jmeta.suggest_palette([(p, JHeader(list(c))) for p, c in
                               files]).to_dict()


@pytest.mark.parametrize("s", ["sho", "Hubble", "h_o_o", "HOS", "natural",
                               "Natural Color", "custom", "", "zzz"])
def test_palette_type_parse_matches_jax(s):
    got = tmeta.PaletteType.from_str_loose(s)
    want = jmeta.PaletteType.from_str_loose(s)
    assert (got.value, got.display_name) == (want.value, want.display_name)


def test_categorize_matches_jax():
    cards = [("SIMPLE", "T"), ("BITPIX", "-32"), ("NAXIS", "2"),
             ("CRPIX1", "10.5"), ("A_0_2", "1e-6"), ("BP_1_1", "2e-7"),
             ("DATE-OBS", "2024-01-01"), ("EXPTIME", "300"),
             ("TELESCOP", "JWST"), ("CCD-TEMP", "-10"), ("CAMERA", "x"),
             ("SENSORID", "7"), ("SWCREATE", "astroburst"),
             ("HISTORY1", "a"), ("COMMENTS", "b"), ("BZERO", "32768"),
             ("OBJECT", "M 16"), ("FOO", "bar"), ("EXTEND", "T"),
             ("CCDXBIN", "2")]
    assert tapi_meta._categorize(HduHeader(cards)) == \
        japi_meta._categorize(JHeader(cards))


def test_get_full_header_filter_and_hint(tmp_path, rng):
    """get_full_header on three files named for SHO with FILTER cards:
    the detection and the (complete) palette hint equal JAX's."""
    GLOBAL_IMAGE_CACHE.clear()
    for name, filt in (("m16_SII.fits", "'S2'"), ("m16_Ha.fits", "'Ha'"),
                       ("m16_OIII.fits", "'O III'")):
        p = str(tmp_path / name)
        write_fits_mono(p, rng.random((6, 7)).astype(np.float32),
                        HduHeader([("FILTER", filt), ("CCD-TEMP", "-5")]))
        got = tapi.get_full_header(p, device=CPU)
        want = japi.get_full_header(p)
        got.pop("elapsed_ms")
        want.pop("elapsed_ms")
        assert got == want
    GLOBAL_IMAGE_CACHE.clear()
