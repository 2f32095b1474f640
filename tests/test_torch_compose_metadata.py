"""PyTorch port: the compose wizard's pure-Python modules
(``metadata/presets``, ``wizard``, ``channel_mapper``), the port's own
copies, against the JAX package's on the same inputs: equal outputs
(no arithmetic beyond sorting and lookups, so no tolerance).
"""

import dataclasses

import pytest

from astroburst_tpu.metadata import channel_mapper as jcm
from astroburst_tpu.metadata import presets as jpre
from astroburst_tpu.metadata import wizard as jwz
from astroburst_tpu_torch import metadata as tmeta
from astroburst_tpu_torch.metadata import channel_mapper as tcm
from astroburst_tpu_torch.metadata import presets as tpre
from astroburst_tpu_torch.metadata import wizard as twz

BIN_ORDERS = [["sii", "ha", "oiii"], ["ha", "oiii"], ["r", "g", "b", "l"],
              ["oiii", "sii", "ha", "r"], ["l"], []]


def test_tables_equal_jax():
    assert tpre.DEFAULT_BINS == jpre.DEFAULT_BINS
    assert tpre.BLEND_PRESETS == jpre.BLEND_PRESETS
    assert tmeta.BLEND_PRESETS is tpre.BLEND_PRESETS
    assert tmeta.DEFAULT_BINS is tpre.DEFAULT_BINS
    assert twz.STEP_ORDER == jwz.STEP_ORDER
    assert twz.NARROWBAND_PRESETS == jwz.NARROWBAND_PRESETS
    assert tcm.JWST_FILTER_WAVELENGTH == jcm.JWST_FILTER_WAVELENGTH


@pytest.mark.parametrize("preset", sorted(jpre.BLEND_PRESETS))
@pytest.mark.parametrize("order", range(len(BIN_ORDERS)))
def test_resolve_preset_weights_equals_jax(preset, order):
    bins = BIN_ORDERS[order]
    assert tpre.resolve_preset_weights(preset, bins) == \
        jpre.resolve_preset_weights(preset, bins)


def test_unknown_preset_raises_in_both():
    with pytest.raises(KeyError):
        tpre.resolve_preset_weights("nope", ["ha"])
    with pytest.raises(KeyError):
        jpre.resolve_preset_weights("nope", ["ha"])


def _states(mod):
    """Wizard states covering the enablement rules: empty, one bin, two
    bins, stacks, aligned/cropped/background paths, a composite."""
    s0 = mod.initial_state()
    s1 = mod.initial_state()
    s1.bins["ha"] = ["ha_1.fits"]
    s2 = mod.initial_state()
    s2.bins.update(ha=["ha_1.fits", "ha_2.fits"], oiii=["o_1.fits"],
                   sii=["s_1.fits"])
    s2.stacked_paths = {"ha": "ha_stacked.fits"}
    s3 = dataclasses.replace(s2, aligned_paths={"ha": "a_ha", "oiii": "a_o"},
                             cropped_paths={"ha": "c_ha"},
                             background_paths={"oiii": "bg_o"},
                             composite_ready=True,
                             completed_steps={k: True for k in
                                              mod.STEP_ORDER})
    s4 = mod.initial_state()
    s4.bins.update(r=["r.fits"], g=["g.fits"], b=["b.fits"])
    s4.blend_preset = "rgb"
    s5 = mod.initial_state()
    s5.bins.update(g=["g.fits"], oiii=["o.fits"])
    s5.blend_preset = "rgb"
    return [s0, s1, s2, s3, s4, s5]


def _as_tuple(state):
    return tuple(sorted((k, repr(v)) for k, v in
                        dataclasses.asdict(state).items()))


@pytest.mark.parametrize("i", range(6))
def test_wizard_flow_equals_jax(i):
    ts, js = _states(twz)[i], _states(jwz)[i]
    assert _as_tuple(ts) == _as_tuple(js)
    for step in twz.STEP_ORDER + ["nope"]:
        assert _as_tuple(twz.invalidate_downstream(ts, step)) == \
            _as_tuple(jwz.invalidate_downstream(js, step)), step
        assert twz.next_enabled_step(ts, step) == \
            jwz.next_enabled_step(js, step), step
        assert twz.invalidate_from_step(ts.completed_steps, step) == \
            jwz.invalidate_from_step(js.completed_steps, step)
    assert [(s.enabled(ts), s.badge(ts) if s.badge else None)
            for s in twz.STEPS] == [(s.enabled(js), s.badge(js)
                                     if s.badge else None)
                                    for s in jwz.STEPS]
    for b in list(ts.bins) + ["nope"]:
        assert twz.resolve_channel_path(ts, b) == \
            jwz.resolve_channel_path(js, b)
    assert twz.resolve_any_channel_path(ts) == \
        jwz.resolve_any_channel_path(js)
    assert twz.resolve_rgb_paths(ts) == jwz.resolve_rgb_paths(js)
    dets = [{"filter": "Hα (656nm)", "path": "ha_1.fits"},
            {"filter": "Red", "path": "r.fits"}]
    for d in (None, dets):
        assert twz.is_narrowband_workflow(ts, d) == \
            jwz.is_narrowband_workflow(js, d)


MAPPER_CASES = {
    "three_jwst": [{"path": "a.fits", "filter": "F444W"},
                   {"path": "b.fits", "filter": "F200W"},
                   {"path": "c.fits", "filter": "F090W"}],
    "five_jwst": [{"path": f"{f}.fits", "filter": f} for f in
                  ("F150W", "F277W", "F356W", "F070W", "F410M")],
    "two_jwst": [{"path": "x.fits", "filter": "f356w "},
                 {"path": "y.fits", "filter": "F115W"}],
    "one_jwst_and_names": [{"path": "m_L_.fits", "filter": "F200W"},
                           {"path": "m_ha.fits"}, {"path": "m_oiii.fits"},
                           {"path": "m_sii.fits"}],
    "names_only": [{"path": "/d/target_r.fits"}, {"path": "/d/target_g.fits"},
                   {"path": "/d/target_b.fits"},
                   {"path": "/d/target_lum.fits"}],
    "names_field": [{"path": "1.fits", "name": "Red channel"},
                    {"path": "2.fits", "name": "GREEN"},
                    {"path": "3.fits", "name": "blue-ish"}],
    "unknown": [{"path": "q.fits", "filter": "F999W"}, {"path": "z.fits"}],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(MAPPER_CASES))
def test_auto_map_channels_equals_jax(case):
    files = MAPPER_CASES[case]

    def keyed(m):   # the same file objects: compare their paths
        return {k: v["path"] for k, v in m.items()}

    for fn in ("auto_map_by_metadata", "auto_map_by_filename",
               "auto_map_channels"):
        assert keyed(getattr(tcm, fn)(files)) == \
            keyed(getattr(jcm, fn)(files)), fn
    for f in files:
        assert tcm.filter_wavelength(f.get("filter")) == \
            jcm.filter_wavelength(f.get("filter"))
