// The exact drizzle's per-pixel finalize, shared by K7/K8
// (drizzle_finalize.cu: candidates read from a [m, h, w] tensor) and K9
// (drizzle_gather.cu: candidates gathered from the stack in the kernel).
//
// What it computes, per output pixel over its m candidates in the
// reference's push order (frame, y-tap, x-tap; drizzle.rs:121-195):
//   - the first `cap` present pushes are kept: their weights summed in
//     push order (the weight map), their values sorted ascending;
//   - clip passes on the sorted window [lo, hi) while it holds >= 3
//     values: even-averaging median of the window, MAD as the same rank
//     pair of |v - med| over the window, sigma = max(MAD * 1.4826,
//     1e-10), cut values below med - sigma_low*sigma and above
//     med + sigma_high*sigma; a pass that cuts nothing ends the clip;
//   - image = mean of the survivors (summed ascending), else the mean of
//     all kept values, else 0; rejected = kept - survivors.
// The plain torch version is stacking/drizzle.py:_finalize_exact; the
// products, sums and bounds are written with __fmul_rn/__fadd_rn/
// __fsub_rn so nvcc cannot contract them to FMA, and every sum runs in
// the plain version's order, so the image, weight map and rejected map
// match it bit for bit.
//
// How a candidate is found is the caller's: `cands(k, v, wk)` returns
// whether push k is present (its weight wk > 1e-12 and its value v
// finite) and sets v and wk. A caller loads the value only after the
// weight passed, so a push of weight 0 is never read.
//
// Live values never exceed cap, so they sit in a per-thread array (stride
// 1) or, past the largest local array, in a pixel-minor column of a
// global scratch (stride h * w: value j of pixel o at scratch[j*h*w + o],
// so the threads of a warp touch neighbouring words at every step).
// Reading stops at the cap-th present push: later pushes change nothing.
// The values are insertion-sorted as they arrive; the MAD's deviations
// |v - med| over a sorted window fall then rise (V shape), so a
// two-pointer walk out from the median gives their k-th smallest without
// a second sort. A pixel leaves the clip loop at its own fixed point
// (fewer than 3 values, or a pass that cut nothing): every later pass
// would be the identity, so the early exit is exact.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace abt_drizzle {

constexpr float kMadToSigma = 1.4826f;
constexpr float kPresent = 1e-12f;

#define ABT_SV(j) sv[(size_t)(j) * stride]
template <class Cands>
__device__ __forceinline__ void finalize_pixel(
    float* sv, size_t stride, const Cands& cands, int m, int cap,
    float sigma_low, float sigma_high, int iterations, size_t o,
    float* __restrict__ img, float* __restrict__ wgt,
    int* __restrict__ rej) {
  // ---- presence, push-order cap, weight map, sorted live values ----
  int live = 0;
  float wsum = 0.0f;
  for (int k = 0; k < m; ++k) {
    float v, wk;
    if (!cands(k, v, wk)) continue;
    if (live == cap) break;  // every later push is past the cap
    wsum = __fadd_rn(wsum, wk);
    int j = live - 1;
    while (j >= 0 && ABT_SV(j) > v) {
      ABT_SV(j + 1) = ABT_SV(j);
      --j;
    }
    ABT_SV(j + 1) = v;
    ++live;
  }
  const int count0 = live;

  // ---- clip passes on the sorted window [lo, hi) ----
  int lo = 0;
  int hi = count0;
  for (int it = 0; it < iterations; ++it) {
    const int cnt = hi - lo;
    if (cnt < 3) break;  // inactive now and in every later pass
    const int k1 = (cnt - 1) / 2;
    const int k2 = cnt / 2;
    const float med =
        __fmul_rn(__fadd_rn(ABT_SV(lo + k1), ABT_SV(lo + k2)), 0.5f);
    // deviations fall over [lo, r) and rise over [r, hi): merge outwards
    int r = lo;
    while (r < hi && ABT_SV(r) < med) ++r;
    int l = r - 1;
    float d1 = 0.0f, d2 = 0.0f;
    for (int s = 0; s <= k2; ++s) {
      const float dl = l >= lo ? fabsf(__fsub_rn(ABT_SV(l), med)) : INFINITY;
      const float dr = r < hi ? fabsf(__fsub_rn(ABT_SV(r), med)) : INFINITY;
      float d;
      if (dl <= dr) {
        d = dl;
        --l;
      } else {
        d = dr;
        ++r;
      }
      if (s == k1) d1 = d;
      if (s == k2) d2 = d;
    }
    const float mad = __fmul_rn(__fadd_rn(d1, d2), 0.5f);
    const float sigma = fmaxf(__fmul_rn(mad, kMadToSigma), 1e-10f);
    const float vlo = __fsub_rn(med, __fmul_rn(sigma_low, sigma));
    const float vhi = __fadd_rn(med, __fmul_rn(sigma_high, sigma));
    int cut_lo = 0;
    while (lo + cut_lo < hi && ABT_SV(lo + cut_lo) < vlo) ++cut_lo;
    int cut_hi = 0;
    while (hi - 1 - cut_hi >= lo && ABT_SV(hi - 1 - cut_hi) > vhi) ++cut_hi;
    lo += cut_lo;
    hi -= cut_hi;
    if (cut_lo + cut_hi == 0) break;  // stopped: a fixed point
  }

  // ---- outputs ----
  const int final_cnt = hi - lo;
  float result = 0.0f;
  if (final_cnt > 0) {
    float s = 0.0f;
    for (int j = lo; j < hi; ++j) s = __fadd_rn(s, ABT_SV(j));
    result = __fdiv_rn(s, (float)final_cnt);
  } else if (count0 > 0) {
    float s = 0.0f;
    for (int j = 0; j < count0; ++j) s = __fadd_rn(s, ABT_SV(j));
    result = __fdiv_rn(s, (float)count0);
  }
  img[o] = result;
  wgt[o] = wsum;
  rej[o] = count0 - final_cnt;
}
#undef ABT_SV

// Largest per-thread live-value array; past it the global scratch.
constexpr int kMaxLocalCap = 256;

}  // namespace abt_drizzle
