"""Row-sharded N-channel compose: blend → white balance → (linked) STF
(counterpart of astroburst_tpu/parallel/compose.py).

Reference semantics: ``compose/channel_blend.rs`` (Out_c = Σ_k
W[k, c]·Ch_k), ``compose/white_balance.rs:3-20`` (the channel with the
lowest MAD/median anchors the gains), ``compose/rgb.rs:209-322`` (pre-WB
stats pick the WB reference, post-WB stats drive the stretch; the
linked STF takes one (shadow, midtone) from the merged plane and
normalizes each channel by its own stats; v ≤ 1e-7 → black).

Every stage is elementwise or a reduction over the plane, so the
channels stay row-sharded from end to end: the stats come from
``pipeline.sharded_stats_core`` (``pmin``/``pmax``/``psum`` and the
exact median and MAD by bisection), and nothing is resharded or
gathered. As in the JAX function the gains and STF parameters stay on
the device in f32 (``compose/rgb.process_rgb`` takes them on the host
in f64).
"""

from __future__ import annotations

import torch

from astroburst_tpu_torch.constants import MAD_TO_SIGMA
from astroburst_tpu_torch.dtypes import AutoStfConfig
from astroburst_tpu_torch.imaging.stf import apply_stf_traced, auto_stf_traced
from astroburst_tpu_torch.parallel.mesh import (Mesh, Sharded, as_sharded,
                                                on_shards)
from astroburst_tpu_torch.parallel.pipeline import sharded_stats_core


def _traced_wb_auto(meds: torch.Tensor, mads: torch.Tensor) -> torch.Tensor:
    """Stability-reference gains on the device (white_balance.rs:3-20):
    meds, mads [3] → [3] factors, the reference channel exactly 1.0.
    Ties go to R, then B over G, as the host ``select_wb_reference``."""
    inf = torch.full_like(meds, float("inf"))
    stab = torch.where(meds > 1e-10, mads / torch.clamp(meds, min=1e-30),
                       inf)
    cond_r = (stab[0] <= stab[1]) & (stab[0] <= stab[2])
    ref_idx = torch.where(cond_r, 0, torch.where(stab[2] <= stab[1], 2, 1))
    m = torch.clamp(meds[ref_idx], min=1e-10)
    factors = m / torch.clamp(meds, min=1e-10)
    one = torch.ones_like(factors)
    return torch.where(torch.arange(3, device=meds.device) == ref_idx, one,
                       factors)


def make_sharded_compose(mesh: Mesh, rows_axis="rows", *,
                         wb_mode: str = "auto", linked_stf: bool = True,
                         stf_config: AutoStfConfig = AutoStfConfig(),
                         exact_pair: bool = False):
    """The blend + WB + auto-STF compose over a rows-sharded mesh.

    Returns ``compose(channels, weights, wb_manual)``:
      channels  [C, H, W] f32 (a tensor, placed here in row blocks, or a
                Sharded of rows (dim 1) over ``rows_axis``)
      weights   [C, 3] f32 blend matrix (channel_blend.rs:13-70)
      wb_manual [3] f32 gains, used only when wb_mode == "manual"
    → dict with rgb (Sharded [3, H, W], stretched), preview (Sharded u8),
      stf [3, 2] (shadow, midtone per channel; equal rows when linked)
      and wb [3], on the first shard's device.
    """
    if wb_mode not in ("auto", "manual", "none"):
        raise ValueError(f"wb_mode {wb_mode!r}")
    axes = mesh.axes(rows_axis)

    def compose(channels, weights, wb_manual) -> dict:
        chans = as_sharded(mesh, channels, 1, axes)
        w = mesh.broadcast(torch.as_tensor(weights, dtype=torch.float32))

        def blend(i, ch, wi):
            # a weighted sum over the channels in index order, as
            # compose/channel_blend.blend_channels forms it
            out = []
            for c in range(3):
                acc = ch[0] * wi[0, c]
                for k in range(1, ch.shape[0]):
                    acc = acc + ch[k] * wi[k, c]
                out.append(acc)
            return torch.stack(out)

        rgb = on_shards(mesh, blend, chans.parts, w)

        def stats(planes):
            mn, mx, _t, count, med, mad = sharded_stats_core(
                mesh, planes, axes, exact_pair)
            return mn, mx, count, med, mad

        if wb_mode == "auto":
            pre = [stats([p[k] for p in rgb]) for k in range(3)]
            wb = on_shards(mesh, lambda i, *v: _traced_wb_auto(
                torch.stack(v[:3]), torch.stack(v[3:])),
                *[s[3] for s in pre], *[s[4] for s in pre])
        elif wb_mode == "manual":
            wb = mesh.broadcast(torch.as_tensor(wb_manual,
                                                dtype=torch.float32))
        else:
            wb = [torch.ones(3, dtype=torch.float32, device=mesh.device(i))
                  for i in range(mesh.size)]
        rgb = on_shards(mesh, lambda i, p, g: p * g[:, None, None], rgb, wb)

        post = [stats([p[k] for p in rgb]) for k in range(3)]

        def stf(mn, mx, count, med, mad):
            def one(i, a, b, c, m, d):
                sigma = torch.clamp(d * MAD_TO_SIGMA, min=1e-30)
                return torch.stack(auto_stf_traced(
                    a, b, m, sigma, c, stf_config.target_bg,
                    stf_config.shadow_k))
            return on_shards(mesh, one, mn, mx, count, med, mad)

        if linked_stf:
            merged = on_shards(mesh, lambda i, p: (p[0] + p[1] + p[2]) * (
                1.0 / 3.0), rgb)
            linked = stf(*stats(merged))
            params = [linked] * 3
        else:
            params = [stf(*s) for s in post]

        def stretch(i, p):
            return torch.stack([apply_stf_traced(
                p[k], post[k][0][i], post[k][1][i], params[k][i][0],
                params[k][i][1]) for k in range(3)])

        out = on_shards(mesh, stretch, rgb)
        preview = on_shards(mesh, lambda i, o: torch.clamp(
            torch.round(o * 255.0), 0.0, 255.0).to(torch.uint8), out)
        h = chans.length
        return {
            "rgb": Sharded(mesh, out, 1, axes, h),
            "preview": Sharded(mesh, preview, 1, axes, h),
            "stf": torch.stack([p[0] for p in params]),
            "wb": wb[0],
        }

    return compose
