// The exact drizzle's per-pixel finalize, shared by K7/K8
// (drizzle_finalize.cu: candidates read from a [m, h, w] tensor) and K9
// (drizzle_gather.cu: candidates gathered from the stack in the kernel).
// It stands for the per-pixel loop that the TPU kernels
// astroburst_tpu/stacking/drizzle_kernel.py:drizzle_finalize_fused and
// astroburst_tpu/stacking/drizzle_gather_kernel.py:
// drizzle_gather_finalize_parity run over (8, 128) VMEM tiles.
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
// match it bit for bit. How a candidate is found is the caller's: it
// says whether push k is present (its weight wk > 1e-12 and its value v
// finite) and sets v and wk; a caller loads the value only after the
// weight passed, so a push of weight 0 is never read. A pixel leaves
// the clip loop at its own fixed point (fewer than 3 values, or a pass
// that cut nothing): every later pass would be the identity, so the
// early exit is exact. Reading stops at the cap-th present push: later
// pushes change nothing.
//
// What bounds it on the H100: the per-pixel work, not the bytes (the
// candidates are read once, three planes written once). Two forms:
//
// finalize_pixel: the live values in memory at a stride — a column of a
// per-block shared buffer (K7/K8 and K9 at depths 33..256: s[j *
// blockDim + tid], so a warp's lanes always hit 32 different banks;
// blocks of 32 x shared_block_rows(depth), at most 64 KiB), or a
// pixel-minor column of a global scratch past 256 (stride h * w). The
// values are insertion-sorted as they arrive; the MAD's deviations over
// a sorted window fall then rise (V shape), so a two-pointer walk out
// from the median gives their k-th smallest. Every step indexes the
// column by a runtime value, which shared memory serves at its latency
// (a per-thread local array, an earlier form of K7, spilled through L1
// to L2 and set the kernel's time).
//
// RegLive<CAP> (K7/K8 and K9 at depths <= 32): the live values in a
// register array whose every subscript is a compile-time constant (all
// loops over it unrolled, reg_select.cuh), so it never touches local
// memory; the caller walks its pushes itself (push / full / finish):
//   - arrival: a present push is inserted by a median-of-three min/max
//     over all CAP slots (slots past `live` hold +inf);
//   - the median's two ranks and the MAD's two ranks are read by select
//     chains;
//   - the MAD: the window's deviations, +inf outside it, fall then rise,
//     a bitonic sequence, so one bitonic merge (log2 P half-cleaner
//     stages of min/max over P = next power of two >= CAP slots) sorts
//     them; f32 subtraction rounds symmetrically, so |v - med| equals
//     med - v below the median and the multiset is the walk's;
//   - the cuts count the window values below vlo and above vhi (the
//     window is sorted, so these are the walk's prefix and suffix);
//   - the sums add the window's values in index order with predicated
//     __fadd_rn, the plain version's order.
// Its cost is ~3 CAP operations a push and ~25 CAP a clip pass.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "reg_select.cuh"

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

// Deepest live-value column in shared memory; past it the global scratch.
constexpr int kMaxSharedCap = 256;

// Rows of a 32-wide block of a shared-memory instance at this depth, so
// that the block's columns (depth x threads floats) stay within 64 KiB.
__host__ __device__ constexpr int shared_block_rows(int depth) {
  return depth <= 64 ? 8 : (depth <= 128 ? 4 : 2);
}

// Bit i set for lo <= i < hi (0 <= lo, hi <= 32): one mask per pass, so
// each slot's window test is a bit test.
__device__ __forceinline__ unsigned window_bits(int lo, int hi) {
  const unsigned below_hi = hi >= 32 ? ~0u : (1u << hi) - 1u;
  const unsigned below_lo = lo >= 32 ? ~0u : (1u << lo) - 1u;
  return lo < hi ? below_hi & ~below_lo : 0u;
}

using abt_reg::reg_at;

// finalize_pixel with the live values in registers, depth min(cap, m)
// <= CAP: the caller calls push() for each present push in order while
// full() is false (a present push once full ends its walk: every later
// push is past the cap), then finish().
template <int CAP>
struct RegLive {
  float v[CAP];   // ascending; slots past `live` hold +inf
  int live = 0;
  int cap;
  float wsum = 0.0f;  // the kept pushes' weights, in push order

  __device__ __forceinline__ explicit RegLive(int cap_) : cap(cap_) {
#pragma unroll
    for (int i = 0; i < CAP; ++i) v[i] = INFINITY;
  }

  __device__ __forceinline__ bool full() const { return live == cap; }

  // insert x (abt_reg::sorted_insert: a median-of-three min/max over
  // all CAP slots; the +inf slots past `live` stay +inf but the first).
  // +-0 may swap places, which changes no output: the sums start at +0,
  // and a zero median gives the same deviations and bounds.
  __device__ __forceinline__ void push(float x, float wk) {
    wsum = __fadd_rn(wsum, wk);
    abt_reg::sorted_insert(v, x);
    ++live;
  }

  __device__ __forceinline__ void finish(float sigma_low, float sigma_high,
                                         int iterations, size_t o,
                                         float* __restrict__ img,
                                         float* __restrict__ wgt,
                                         int* __restrict__ rej) const {
    const int count0 = live;
    // ---- clip passes on the sorted window [lo, hi) ----
    int lo = 0;
    int hi = count0;
    for (int it = 0; it < iterations; ++it) {
      const int cnt = hi - lo;
      if (cnt < 3) break;  // inactive now and in every later pass
      const int k1 = (cnt - 1) / 2;
      const int k2 = cnt / 2;
      const float med = __fmul_rn(
          __fadd_rn(reg_at(v, lo + k1), reg_at(v, lo + k2)), 0.5f);
      // deviations, +inf outside the window: they fall, then rise, a
      // bitonic run that one bitonic merge sorts; the ranks wanted, k2 <=
      // CAP / 2, are among those it serves (abt_reg::bitonic_merge)
      const unsigned win = window_bits(lo, hi);
      float d[CAP];
#pragma unroll
      for (int i = 0; i < CAP; ++i)
        d[i] = (win >> i) & 1u ? fabsf(__fsub_rn(v[i], med)) : INFINITY;
      abt_reg::bitonic_merge(d);
      const float mad = __fmul_rn(__fadd_rn(reg_at(d, k1), reg_at(d, k2)),
                                  0.5f);
      const float sigma = fmaxf(__fmul_rn(mad, kMadToSigma), 1e-10f);
      const float vlo = __fsub_rn(med, __fmul_rn(sigma_low, sigma));
      const float vhi = __fadd_rn(med, __fmul_rn(sigma_high, sigma));
      // the array is sorted: values < vlo are a prefix [0, below), values
      // <= vhi a prefix [0, upto); their overlaps with the window are
      // the walk's cuts
      int below = 0;
      int upto = 0;
#pragma unroll
      for (int i = 0; i < CAP; ++i) {
        below += v[i] < vlo;
        upto += v[i] <= vhi;
      }
      const int cut_lo = (below < lo ? lo : below > hi ? hi : below) - lo;
      const int cut_hi = hi - (upto < lo ? lo : upto > hi ? hi : upto);
      lo += cut_lo;
      hi -= cut_hi;
      if (cut_lo + cut_hi == 0) break;  // stopped: a fixed point
    }

    // ---- outputs ----
    const int final_cnt = hi - lo;
    float result = 0.0f;
    if (final_cnt > 0 || count0 > 0) {
      const unsigned win = final_cnt > 0 ? window_bits(lo, hi)
                                         : window_bits(0, count0);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < CAP; ++i)
        if ((win >> i) & 1u) s = __fadd_rn(s, v[i]);
      result = __fdiv_rn(s, (float)(final_cnt > 0 ? final_cnt : count0));
    }
    img[o] = result;
    wgt[o] = wsum;
    rej[o] = count0 - final_cnt;
  }
};

}  // namespace abt_drizzle
