"""The frozen copies in benchmark/reference/ against the port's plain
versions at tiny sizes on the CPU: bit for bit, so the copies are
faithful. (The reference itself imports nothing of the port; these
tests do, to hold it to the port's plain paths.)"""

import numpy as np
import pytest
import torch

from benchmark.core.fields import render
from benchmark.reference import rounder
from benchmark.reference import stack as R
from benchmark.reference.align import phase_correlate
from benchmark.reference.drizzle import drizzle

CPU = torch.device("cpu")
DATA = {"frames": 4, "height": 600, "width": 300, "stars": 60,
        "amp_min": 300.0, "amp_max": 2300.0, "psf_sigma": 1.5,
        "background": 120.0, "read_noise": 5.0, "dither_max": 12.0}


def bits(x):
    return torch.as_tensor(x).contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def frames():
    return render(DATA, 987654321987, CPU)


@pytest.mark.parametrize("hw", [(600, 300), (96, 64)])
def test_phase_correlation(frames, hw):
    from astroburst_tpu_torch.alignment.phase_correlation import (
        phase_correlate_stack)
    st = frames[:, :hw[0], :hw[1]].contiguous()
    dy, dx, conf = phase_correlate(st)
    pdy, pdx, pconf = phase_correlate_stack(st[0], st[1:], plain=True)
    for a, b in ((dy[1:], pdy), (dx[1:], pdx), (conf[1:], pconf)):
        assert torch.equal(bits(a), bits(b))


def test_shift_clip_stats_stf(frames):
    from astroburst_tpu_torch.imaging.stf import (apply_stf_traced,
                                                  auto_stf_traced)
    from astroburst_tpu_torch.ops.stats import stats_core
    from astroburst_tpu_torch.stacking.onepass_kernel import (
        shift_clip_onepass_plain)
    offs = [(0.0, 0.0), (3.25, -7.5), (-11.875, 0.4), (1e-13, 0.0)]
    dys = torch.tensor([o[0] for o in offs])
    dxs = torch.tensor([o[1] for o in offs])
    want, want_rej = shift_clip_onepass_plain(frames, dys, dxs, 3.0, 3.0, 5)
    shifted = torch.stack([R.shift_frame(frames[k], float(dys[k]),
                                         float(dxs[k])) for k in range(4)])
    got, rej = R.clip_in_rows(shifted, 3.0, 3.0, 5, rows=128)
    assert torch.equal(bits(got), bits(want)) and rej == int(want_rej)
    for pair in (False, True):
        mn, mx, total, count, med, mad = stats_core(got, pair)
        st = R.stats(got, pair=pair)
        assert (st["min"], st["max"], st["median"], st["mad"],
                st["count"]) == (float(mn), float(mx), float(med),
                                 float(mad), int(count))
    st = R.stats(got, pair=False)
    sigma = torch.clamp(torch.tensor(st["mad"]) * 1.4826, min=1e-30)
    shadow, mid = auto_stf_traced(torch.tensor(st["min"]),
                                  torch.tensor(st["max"]),
                                  torch.tensor(st["median"]), sigma,
                                  torch.tensor(st["count"]))
    rs, rm = R.auto_stf_f32(st, CPU)
    assert torch.equal(bits(shadow), bits(rs)) and torch.equal(bits(mid),
                                                               bits(rm))
    dmin, dmax = torch.tensor(st["min"]), torch.tensor(st["max"])
    want_u8 = apply_stf_traced(got, dmin, dmax, shadow, mid, as_u8=True)
    got_u8 = R.stf_u8(got, dmin, 1.0 / torch.clamp(dmax - dmin, min=1e-30),
                      rs, 1.0 / torch.clamp(1.0 - rs, min=1e-15), rm)
    assert torch.equal(got_u8, want_u8)


def test_command_stats_preview_histogram(frames):
    from astroburst_tpu_torch.imaging.stf import apply_stf_u8, auto_stf
    from astroburst_tpu_torch.ops.ipc import nearest_downsample
    from astroburst_tpu_torch.ops.stats import (compute_histogram,
                                                compute_image_stats)
    x = frames[0]
    st = compute_image_stats(x)
    ref = R.stats(x)
    assert (ref["min"], ref["max"], ref["median"], ref["mad"]) == (
        st.min, st.max, st.median, st.mad)
    assert ref["mean"] == pytest.approx(st.mean, rel=1e-6)
    stf = auto_stf(st)
    rstf = R.auto_stf(ref)
    assert (rstf["shadow"], rstf["midtone"]) == pytest.approx(
        (stf.shadow, stf.midtone), rel=1e-6)
    want = apply_stf_u8(nearest_downsample(x, 256), stf, st)
    assert torch.equal(R.preview_u8(x, ref, {"shadow": stf.shadow,
                                             "midtone": stf.midtone},
                                    256), want)
    h = compute_histogram(x, 512, st.min, st.max)
    assert R.histogram(x, st.min, st.max, 512).tolist() == h.bins


def test_drizzle(frames):
    from astroburst_tpu_torch.dtypes import DrizzleKernel
    from astroburst_tpu_torch.stacking.drizzle import _drizzle_kernel_exact
    st = frames[:, :96, :80].contiguous()
    offs = [(0.0, 0.0), (0.37, -0.61), (-1.22, 0.93), (2.5, 1.75)]
    d_ys = torch.tensor([-dy for dy, _ in offs])
    d_xs = torch.tensor([-dx for _, dx in offs])
    img, wgt, rej = _drizzle_kernel_exact(
        st, d_ys, d_xs, 2.0, 0.7, DrizzleKernel.SQUARE, 192, 160, 3.0, 3.0,
        5, plain=True)
    rimg, rwgt, rrej = drizzle(st, offs, 2.0, 0.7, 3.0, 3.0, 5)
    assert torch.equal(bits(rimg), bits(img))
    assert torch.equal(bits(rwgt), bits(wgt)) and rrej == int(rej)


def test_control_rounds_every_stage_to_bfloat16():
    x = torch.tensor([1.0 + 2 ** -10, 120.3])
    q = rounder("bf16")
    assert q(x).tolist() == [1.0, 120.5]
    assert rounder("f32")(x) is x
    with pytest.raises(ValueError):
        rounder("f16")


def test_render_is_the_same_for_a_seed_and_differs_between_seeds():
    a = render(DATA, 2 ** 31 + 5, CPU, frames=2)
    b = render(DATA, 2 ** 31 + 5, CPU, frames=2)
    c = render(DATA, 2 ** 31 + 6, CPU, frames=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert np.isfinite(a.numpy()).all()
