"""PyTorch port: the astrometry modules (``astrometry/wcs.py``,
``astrometry/plate_solve.py``, ``astrometry/spcc.py``) against the JAX
package's on the same seeded numpy inputs, on the CPU. The JAX
detection runs on its XLA route, as its own tests run it. No test
contacts a network: every HTTP request goes to a stand-in that
replaces ``urllib.request.urlopen``.

Tolerances, and why:

- WCS (``WcsTransform``, ``CelestialCoord``): bit-equal, NaN where JAX
  has NaN. Both are host f64 numpy with the same expressions in the
  same order. The same ``InvalidInput`` texts for missing keys.
- the SPCC scalars (Planck curves, white references, the Bp-Rp
  estimate, the Gaia ADQL, CSV parse and client, the regression):
  equal, with the same error texts.
- the SPCC chain given JAX's own stars (the port's detection replaced
  by JAX's on the same luminance, which is bit-equal: three f32
  products summed in order in both packages): the result bit-equal,
  since the window photometry runs JAX's f64 arithmetic on the same
  pixels.
- the SPCC chain end to end: the same kept stars in the same order,
  positions, fluxes, peaks and FWHMs within rel 1e-4 (the detection's
  bound, tests/test_torch_star_detection.py); the factors and the mean
  colour index within rel 1e-4, that bound carried through the
  aperture radius (1.5 FWHM) and the Bp-Rp estimate, whose slopes in
  flux/peak and FWHM are below 1. Measured here: at most 6.5e-10 on the
  factors and 8.7e-9 on the colour index (the 256² and 512² fields).
- the astrometry.net client: the requests (URLs, ``request-json``
  fields, multipart bodies, headers) and ``SolveResult.to_dict()``
  equal; the same ``SolveError`` texts.
"""

import io
import json
import urllib.error
import urllib.parse

import numpy as np
import pytest
import torch

from astroburst_tpu.analysis import star_detection as jsd
from astroburst_tpu.astrometry import plate_solve as jps
from astroburst_tpu.astrometry import spcc as jspcc
from astroburst_tpu.astrometry import wcs as jwcs
from astroburst_tpu.errors import InvalidInput as JInvalid
from astroburst_tpu.errors import SolveError as JSolveError
from astroburst_tpu.io.header import HduHeader as JHeader
from astroburst_tpu.ops.stats import compute_image_stats as jstats
from astroburst_tpu_torch.analysis.star_detection import DetectedStar
from astroburst_tpu_torch.astrometry import plate_solve as tps
from astroburst_tpu_torch.astrometry import spcc as tspcc
from astroburst_tpu_torch.astrometry import wcs as twcs
from astroburst_tpu_torch.errors import InvalidInput, SolveError
from astroburst_tpu_torch.io.header import HduHeader
from tests.test_gaia_tap import CANNED_CSV

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _cards(proj="TAN", crpix=(128.0, 128.0), extra=()):
    return [("CRPIX1", repr(crpix[0])), ("CRPIX2", repr(crpix[1])),
            ("CRVAL1", "150.0"), ("CRVAL2", "30.0"),
            ("CD1_1", "-0.0002"), ("CD1_2", "1.5E-6"),
            ("CD2_1", "-2.0E-6"), ("CD2_2", "0.0002"),
            ("CTYPE1", f"RA---{proj}"), ("CTYPE2", f"DEC--{proj}"),
            *extra]


def _both(cards):
    return (twcs.WcsTransform.from_header(HduHeader(cards)),
            jwcs.WcsTransform.from_header(JHeader(cards)))


def _same(a, b):
    """Bit-equal f64 arrays (NaN equal to NaN)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


# --- WCS -------------------------------------------------------------------


@pytest.mark.parametrize("proj", ["TAN", "SIN", "ARC", "CAR"])
def test_wcs_transforms_are_bit_equal_to_jax(proj):
    t, j = _both(_cards(proj))
    assert t.projection == proj and t.raw_params() == j.raw_params()
    rng = np.random.default_rng(5)
    xs, ys = rng.uniform(-300, 600, 400), rng.uniform(-300, 600, 400)
    xs[0], ys[0] = 127.0, 127.0            # the reference pixel itself
    ra_t, dec_t = t.pixel_to_world_batch(xs, ys)
    ra_j, dec_j = j.pixel_to_world_batch(xs, ys)
    assert _same(ra_t, ra_j) and _same(dec_t, dec_j)
    px_t, py_t = t.world_to_pixel_batch(ra_j, dec_j)
    px_j, py_j = j.world_to_pixel_batch(ra_j, dec_j)
    assert _same(px_t, px_j) and _same(py_t, py_j)
    for x, y in zip(xs[:20], ys[:20]):
        ct, cj = t.pixel_to_world(x, y), j.pixel_to_world(x, y)
        assert (ct.ra, ct.dec) == (cj.ra, cj.dec) and str(ct) == str(cj)
        assert _same(t.world_to_pixel(ct.ra, ct.dec),
                     j.world_to_pixel(cj.ra, cj.dec))
    assert t.pixel_scale_arcsec() == j.pixel_scale_arcsec()
    assert t.field_of_view(512, 300) == j.field_of_view(512, 300)


@pytest.mark.parametrize("crota", [None, "0.0", "37.5", "-120.0"])
def test_wcs_cdelt_crota2_fallback_is_bit_equal_to_jax(crota):
    cards = [("CRPIX1", "10.5"), ("CRPIX2", "20.25"), ("CRVAL1", "210.8"),
             ("CRVAL2", "54.3"), ("CDELT1", "-2.7777E-4"),
             ("CDELT2", "2.7777D-4")]
    if crota is not None:
        cards.append(("CROTA2", crota))
    t, j = _both(cards)
    assert t.projection == "TAN"
    assert _same(t.cd, j.cd) and t.raw_params() == j.raw_params()
    xs = np.linspace(-50, 250, 31)
    assert all(_same(a, b) for a, b in zip(
        t.pixel_to_world_batch(xs, xs[::-1]),
        j.pixel_to_world_batch(xs, xs[::-1])))
    assert t.pixel_scale_arcsec() == j.pixel_scale_arcsec()
    assert t.field_of_view(100, 80) == j.field_of_view(100, 80)


@pytest.mark.parametrize("ctype", [None, "RA---XYZ", "RA", "RA---SIN",
                                   "'RA---ARC'", "GLON-CAR"])
def test_wcs_projection_from_ctype1_matches_jax(ctype):
    cards = [c for c in _cards() if c[0] not in ("CTYPE1", "CTYPE2")]
    if ctype is not None:
        cards.append(("CTYPE1", ctype))
    t, j = _both(cards)
    assert t.projection == j.projection


def test_wcs_tan_point_90_degrees_away_is_nan_as_in_jax():
    t, j = _both(_cards("TAN"))
    ras = np.array([150.0, 240.0, 150.0, 60.0])
    decs = np.array([30.0, 0.0, -60.0, 0.0])   # three points 90° away
    got, want = t.world_to_pixel_batch(ras, decs), \
        j.world_to_pixel_batch(ras, decs)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert np.isnan(got[0][1:]).all() and np.isfinite(got[0][0])
    assert _same(t.world_to_pixel(240.0, 0.0), j.world_to_pixel(240.0, 0.0))


@pytest.mark.parametrize("cd", [("0", "0", "0", "0"),
                                ("1E-4", "2E-4", "2E-4", "4E-4")])
def test_wcs_singular_cd_gives_nan_as_in_jax(cd):
    cards = [c for c in _cards() if not c[0].startswith("CD")] + list(
        zip(("CD1_1", "CD1_2", "CD2_1", "CD2_2"), cd))
    t, j = _both(cards)
    got = t.world_to_pixel_batch([150.0, 150.1], [30.0, 30.1])
    assert all(_same(a, b) for a, b in zip(got, j.world_to_pixel_batch(
        [150.0, 150.1], [30.0, 30.1])))
    assert np.isnan(got[0]).all() and np.isnan(got[1]).all()


@pytest.mark.parametrize("drop", ["CRPIX1", "CRPIX2", "CRVAL1", "CRVAL2",
                                  "CD", "CDELT2"])
def test_wcs_missing_keys_raise_the_jax_texts(drop):
    cards = [c for c in _cards() if not c[0].startswith(drop)]
    if drop == "CDELT2":    # no CD matrix, CDELT1 alone
        cards = [c for c in cards if not c[0].startswith("CD")] + [
            ("CDELT1", "-2.7777E-4")]
    with pytest.raises(JInvalid) as want:
        jwcs.WcsTransform.from_header(JHeader(cards))
    with pytest.raises(InvalidInput) as got:
        twcs.WcsTransform.from_header(HduHeader(cards))
    assert str(got.value) == str(want.value)


def test_celestial_coord_display_matches_jax():
    rng = np.random.default_rng(8)
    for ra, dec in [(0.0, 0.0), (359.9999, -89.99), (83.8221, -5.3911),
                    (150.0, 30.0), *zip(rng.uniform(0, 360, 50),
                                        rng.uniform(-90, 90, 50))]:
        assert str(twcs.CelestialCoord(ra, dec)) == \
            str(jwcs.CelestialCoord(ra, dec))


# --- SPCC scalars ----------------------------------------------------------


def test_teff_and_planck_curves_equal_jax():
    for x in [-2.0, -0.5, -0.1, 0.0, 0.25, 0.5, 0.75, 1.0, 1.2, 1.5, 2.0,
              2.5, 3.7, 5.0, 9.0]:
        assert tspcc.bp_rp_to_teff(x) == jspcc.bp_rp_to_teff(x)
    for teff in [1.0, 50.0, 2800.0, 3500.0, 5500.0, 5778.0, 10000.0, 40000.0]:
        for lam in (460.0, 530.0, 640.0):
            assert tspcc.planck_intensity(teff, lam) == \
                jspcc.planck_intensity(teff, lam)
        assert tspcc.planck_rgb(teff) == jspcc.planck_rgb(teff)


@pytest.mark.parametrize("white", ["average_spiral", "g2v", "photopic",
                                   "custom", "unknown"])
def test_white_references_equal_jax(white):
    kw = dict(white_reference=white, custom_white=(0.91, 1.0, 1.137))
    t, j = tspcc.SpccConfig(**kw), jspcc.SpccConfig(**kw)
    assert tspcc.white_reference_rgb(t) == jspcc.white_reference_rgb(j)
    assert tspcc.white_reference_name(t) == jspcc.white_reference_name(j)


def test_bp_rp_estimate_equals_jax():
    rng = np.random.default_rng(3)
    for flux, peak, fwhm in zip(rng.uniform(0, 5e4, 60),
                                np.r_[0.0, rng.uniform(0, 3e3, 59)],
                                rng.uniform(0.5, 12.0, 60)):
        kw = dict(x=1.0, y=2.0, flux=float(flux), fwhm=float(fwhm),
                  eccentricity=0.1, peak=float(peak), npix=9, snr=40.0)
        assert tspcc.estimate_bp_rp_from_flux(DetectedStar(**kw)) == \
            jspcc.estimate_bp_rp_from_flux(jsd.DetectedStar(**kw))


def test_gaia_adql_and_csv_parse_equal_jax():
    for args in [(210.8, 54.3, 0.75), (0.0, -89.5, 1.0),
                 (359.99999999, 12.345678901, 0.0001234, 20, 15.5)]:
        assert tspcc.build_gaia_adql(*args) == jspcc.build_gaia_adql(*args)
    for text in (CANNED_CSV, "bp_rp,dec,ra\n0.5,10.0,20.0\n", "", "\n\n",
                 "RA, Dec ,BP_RP\n1,2,3\n4,5\n6,7,x\n"):
        assert tspcc.parse_gaia_tap_csv(text) == jspcc.parse_gaia_tap_csv(text)
    with pytest.raises(JInvalid) as want:
        jspcc.parse_gaia_tap_csv("foo,bar\n1,2\n")
    with pytest.raises(InvalidInput) as got:
        tspcc.parse_gaia_tap_csv("foo,bar\n1,2\n")
    assert str(got.value) == str(want.value)


class Reply(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _record(monkeypatch, answer):
    """Replace urlopen by ``answer(request) -> bytes`` (or an exception
    it raises); returns the list of (url, body, headers, timeout)."""
    seen = []

    def fake_urlopen(req, timeout=None):
        seen.append((req.full_url, req.data, dict(req.header_items()),
                     timeout))
        return Reply(answer(req))
    monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)
    return seen


def _unreachable(req):
    raise urllib.error.URLError("no route to host")


@pytest.mark.parametrize("reply", ["csv", "empty", "offline"])
def test_gaia_client_requests_and_errors_equal_jax(monkeypatch, reply):
    answer = {"csv": lambda req: CANNED_CSV.encode(),
              "empty": lambda req: b"ra,dec,bp_rp\n",
              "offline": _unreachable}[reply]
    seen = _record(monkeypatch, answer)
    out = []
    for mod, err in ((jspcc, JInvalid), (tspcc, InvalidInput)):
        try:
            out.append(mod.query_gaia_vizier(210.8, 54.3, 1.0))
        except err as e:
            out.append(("raised", str(e)))
    assert out[0] == out[1] and seen[0] == seen[1] and len(seen) == 2
    assert ("raised" in out[0]) == (reply != "csv")


def test_correction_factors_equal_jax():
    rng = np.random.default_rng(17)
    for n in (0, 1, 3, 40):
        rows = [{"bp_rp": float(rng.uniform(-0.6, 5.5)),
                 "r": float(rng.uniform(0, 1e4)),
                 "g": float(rng.uniform(0, 1e4)),
                 "b": float(rng.uniform(0, 1e4))} for _ in range(n)]
        if n == 40:
            rows[3].update(r=0.0, g=0.0, b=0.0)        # skipped: tm < 1e-10
            rows[5].update(r=1e-9)                     # mr below 1e-6
        for wr in ((1.0, 1.0, 1.0), jspcc.planck_rgb(5500.0)):
            assert tspcc.compute_correction_factors(rows, *wr) == \
                jspcc.compute_correction_factors(rows, *wr)


# --- SPCC chain ------------------------------------------------------------


def synthetic_field(hw, n_stars):
    """test_spcc_on_synthetic_field's field (the JAX package's synth
    generator, seed 12), at hw² with n_stars stars."""
    from astroburst_tpu.synth import (FieldConfig, NoiseParams, SynthConfig,
                                      generate)
    cfg = SynthConfig(
        field=FieldConfig(width=hw, height=hw, n_stars=n_stars, seed=12,
                          flux_min=5000, flux_max=30000),
        psf_fwhm=3.0,
        noise=NoiseParams(sky_background=10.0, readout_noise=1.0,
                          exposure_time=10.0, gain=1.0, bias_level=50.0))
    return np.array(generate(cfg)[0], np.float32)


FIELDS = {256: (40, 10.0), 512: (120, 20.0)}   # stars, min_snr


@pytest.fixture(scope="module", params=sorted(FIELDS))
def field(request):
    hw = request.param
    n, min_snr = FIELDS[hw]
    base = synthetic_field(hw, n)
    return hw, min_snr, (base * 1.2, base, base * 0.8), _cards(
        "TAN", (hw / 2, hw / 2))


def _jax_stars(monkeypatch):
    """The port's SPCC detects with JAX's detection on the same
    luminance."""
    monkeypatch.setattr(tspcc, "detect_stars",
                        lambda lum, sigma, plain=False:
                        jsd.detect_stars(lum.numpy(), sigma))


def _run(planes, cards, **cfg):
    j = jspcc.spcc_calibrate_rgb(*planes, JHeader(cards),
                                 jspcc.SpccConfig(**cfg))
    t = tspcc.spcc_calibrate_rgb(*planes, HduHeader(cards),
                                 tspcc.SpccConfig(**cfg), device=CPU)
    return t.to_dict(), j.to_dict()


def test_luminance_is_bit_equal_to_numpy(field):
    _, _, (r, g, b), _ = field
    got = tspcc.luminance(*(torch.from_numpy(p) for p in (r, g, b)))
    assert np.array_equal(got.numpy(), 0.2126 * r + 0.7152 * g + 0.0722 * b)


@pytest.mark.parametrize("white", ["average_spiral", "g2v"])
def test_spcc_given_jax_stars_is_bit_equal_to_jax(field, monkeypatch, white):
    _, min_snr, planes, cards = field
    _jax_stars(monkeypatch)
    got, want = _run(planes, cards, min_snr=min_snr, white_reference=white)
    assert got == want and want["stars_matched"] >= 3
    assert got["r_factor"] < got["b_factor"]


def test_window_photometry_equals_jax_aperture_flux(field):
    hw, _, planes, _ = field
    rng = np.random.default_rng(2)
    stars = [DetectedStar(x=float(x), y=float(y), flux=1.0, fwhm=float(f),
                          eccentricity=0.0, peak=1.0, npix=9, snr=50.0)
             for x, y, f in zip(rng.uniform(0, hw - 1, 40),
                                rng.uniform(0, hw - 1, 40),
                                rng.uniform(0.5, 9.0, 40))]
    stars[0].x, stars[0].y = 0.0, float(hw - 1)          # corners
    stars[1].x, stars[1].y = float(hw) - 1e-9, 0.0
    windows, half = tspcc.gather_windows(
        [torch.from_numpy(p) for p in planes], stars)
    for i, s in enumerate(stars):
        for c, p in enumerate(planes):
            assert tspcc.window_flux(windows[i, c], s, half, hw, hw) == \
                jspcc.aperture_flux(p, s.x, s.y, max(s.fwhm * 1.5, 3.0))


def _jax_kept(planes, min_snr, max_stars=200):
    """JAX's detection, quality filter and SNR sort
    (astroburst_tpu/astrometry/spcc.py:278-291) on the same luminance."""
    lum = 0.2126 * planes[0] + 0.7152 * planes[1] + 0.0722 * planes[2]
    h, w = lum.shape
    sat = jstats(lum).max * 0.90
    good = [s for s in jsd.detect_stars(lum, 5.0).stars
            if s.snr >= min_snr and s.peak < sat and 10.0 <= s.x < w - 10
            and 10.0 <= s.y < h - 10]
    good.sort(key=lambda s: -s.snr)
    return good[:max_stars]


def test_spcc_end_to_end_within_the_detection_bound(field):
    hw, min_snr, planes, cards = field
    lum = tspcc.luminance(*(torch.from_numpy(p) for p in planes))
    got = tspcc.select_stars(lum, tspcc.SpccConfig(min_snr=min_snr))
    want = _jax_kept(planes, min_snr)
    assert len(got) == len(want) >= 5
    for a, b in zip(got, want):
        for k in ("x", "y", "flux", "peak", "fwhm", "snr"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-4)
        assert a.npix == b.npix
    t, j = _run(planes, cards, min_snr=min_snr)
    for k in ("stars_total", "stars_matched", "white_ref_name",
              "catalog_name", "is_synthetic_catalog", "g_factor"):
        assert t[k] == j[k], k
    for k in ("r_factor", "b_factor", "avg_color_index"):
        assert t[k] == pytest.approx(j[k], rel=1e-4), k


def _gaia_csv(stars, cards, bp_rp, shift_deg=0.0):
    """A TAP reply listing ``stars``' sky positions (full precision) with
    the given Bp-Rp values."""
    ras, decs = jwcs.WcsTransform.from_header(JHeader(cards)) \
        .pixel_to_world_batch([s.x for s in stars], [s.y for s in stars])
    rows = [f"{float(ra) + shift_deg!r},{float(dec)!r},{float(c)!r},12.0"
            for ra, dec, c in zip(ras, decs, bp_rp)]
    return ("ra,dec,bp_rp,phot_g_mean_mag\n" + "\n".join(rows)).encode()


@pytest.mark.parametrize("reply", ["csv", "empty", "offline", "gate_off"])
def test_spcc_gaia_route_equals_jax(field, monkeypatch, reply):
    _, min_snr, planes, cards = field
    _jax_stars(monkeypatch)
    kept = _jax_kept(planes, min_snr)
    bp_rp = np.linspace(-0.2, 3.1, len(kept))
    answer = {"csv": lambda req: _gaia_csv(kept, cards, bp_rp),
              "empty": lambda req: b"ra,dec,bp_rp\n",
              "offline": _unreachable, "gate_off": _unreachable}[reply]
    seen = _record(monkeypatch, answer)
    if reply != "gate_off":
        monkeypatch.setenv("ASTROBURST_GAIA_TAP", "1")
    got, want = _run(planes, cards, min_snr=min_snr, catalog="gaia_dr3")
    assert got == want
    assert len(seen) == (0 if reply == "gate_off" else 2)
    if reply == "csv":
        assert not got["is_synthetic_catalog"]
        assert got["catalog_name"] == "Gaia DR3 (VizieR)"
        assert seen[0] == seen[1]
    else:
        builtin, _ = _run(planes, cards, min_snr=min_snr)
        assert got == builtin and got["is_synthetic_catalog"]


@pytest.mark.parametrize("case", ["no_wcs", "too_few_stars",
                                  "too_few_matches"])
def test_spcc_errors_have_the_jax_texts(field, monkeypatch, case):
    _, min_snr, planes, cards = field
    cfg = {"min_snr": min_snr}
    if case == "no_wcs":
        cards = [c for c in cards if c[0] != "CRVAL2"]
    elif case == "too_few_stars":
        cfg["min_snr"] = 1e9
    else:
        _jax_stars(monkeypatch)
        kept = _jax_kept(planes, min_snr)
        _record(monkeypatch, lambda req: _gaia_csv(
            kept, cards, np.ones(len(kept)), shift_deg=0.05))
        monkeypatch.setenv("ASTROBURST_GAIA_TAP", "1")
        cfg["catalog"] = "gaia_dr3"
    with pytest.raises(JInvalid) as want:
        jspcc.spcc_calibrate_rgb(*planes, JHeader(cards),
                                 jspcc.SpccConfig(**cfg))
    with pytest.raises(InvalidInput) as got:
        tspcc.spcc_calibrate_rgb(*planes, HduHeader(cards),
                                 tspcc.SpccConfig(**cfg), device=CPU)
    assert str(got.value) == str(want.value)


# --- astrometry.net client -------------------------------------------------


CALIBRATION = {"ra": 150.0123, "dec": 30.00456, "orientation": 179.87,
               "pixscale": 0.7201, "width_arcsec": 184.3,
               "height_arcsec": 92.15}
ANNOTATIONS = {"annotations": [
    {"type": "ngc", "names": ["NGC 3031", "M 81"], "pixelx": 812.5,
     "pixely": 401.25, "radius": 120.0},
    {"type": "bright", "names": ["HD 85532"], "pixelx": 12.0,
     "pixely": 1017.0},
    {"type": "hd", "names": [], "pixelx": 3, "pixely": 4, "radius": None}]}


def astrometry_service(job_status="success", login="success",
                       upload="success"):
    """The stand-in's replies, by URL path: login, upload, the
    submission's jobs, the job's status, info and annotations."""
    def answer(req):
        path = urllib.parse.urlsplit(req.full_url).path
        if path.endswith("/api/login"):
            return json.dumps({"status": login, "session": "s3ss"}).encode()
        if path.endswith("/api/upload"):
            return json.dumps({"status": upload, "subid": 77}).encode()
        if path.endswith("/api/submissions/77"):
            return json.dumps({"jobs": [None, 4242]}).encode()
        if path.endswith("/api/jobs/4242"):
            return json.dumps({"status": job_status}).encode()
        if path.endswith("/api/jobs/4242/info"):
            return json.dumps({"calibration": CALIBRATION,
                               "calibration_index": "index-5203-09",
                               "objects_in_field_count": 23}).encode()
        if path.endswith("/api/jobs/4242/annotations"):
            return json.dumps(ANNOTATIONS).encode()
        raise AssertionError(f"unexpected URL {req.full_url}")
    return answer


def _solve_both(tmp_path, monkeypatch, answer, **cfg):
    p = tmp_path / "upload.fits"
    p.write_bytes(bytes(range(256)) * 40)
    seen = _record(monkeypatch, answer)
    out = []
    for mod, err in ((jps, JSolveError), (tps, SolveError)):
        n = len(seen)
        try:
            r = mod.solve_astrometry_net(str(p), mod.SolveConfig(**cfg))
            out.append(r.to_dict())
        except err as e:
            out.append(("raised", str(e)))
        out.append(seen[n:])
    return out


@pytest.mark.parametrize("hints", [
    {}, {"ra_hint": 150.0, "dec_hint": 30.0},
    {"ra_hint": 10.5, "dec_hint": -5.25, "radius_hint": None,
     "scale_low": 0.5, "scale_high": 1.5},
    {"api_url": "http://localhost:8/astro/", "scale_low": 0.5}])
def test_solve_client_requests_and_result_equal_jax(tmp_path, monkeypatch,
                                                    hints):
    want, want_req, got, got_req = _solve_both(
        tmp_path, monkeypatch, astrometry_service(), api_key="k3y", **hints)
    assert got == want and got_req == want_req
    assert got["success"] and got["wcs_headers"] == {}
    assert got["annotations"][2]["radius"] is None
    assert [r[0].rsplit("/api/", 1)[1] for r in got_req] == [
        "login", "upload", "submissions/77", "jobs/4242",
        "jobs/4242/info", "jobs/4242/annotations"]
    body = got_req[1][1]
    assert body.endswith(bytes(range(256)) * 40
                         + b"\r\n--astroburstBoundary--\r\n")


@pytest.mark.parametrize("case", ["no_key", "login", "upload", "job",
                                  "timeout", "unreachable"])
def test_solve_client_errors_equal_jax(tmp_path, monkeypatch, case):
    cfg = {"api_key": "" if case == "no_key" else "k3y",
           "timeout_secs": 0 if case == "timeout" else 120}
    answer = astrometry_service(
        job_status="failure" if case == "job" else "success",
        login="error" if case == "login" else "success",
        upload="error" if case == "upload" else "success")
    if case == "unreachable":
        answer = _unreachable
    want, want_req, got, got_req = _solve_both(tmp_path, monkeypatch, answer,
                                               **cfg)
    assert got[0] == "raised" and got == want and got_req == want_req
