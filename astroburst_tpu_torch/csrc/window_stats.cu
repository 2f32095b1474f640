// K11: per-peak window statistics for star detection.
//
// Replaces the TPU kernel
//   astroburst_tpu/analysis/window_kernel.py:window_stats_pallas
// (DMA of an (8, 128)-aligned superset block per peak from a NaN-padded
// plane, lane rolls, one joint flood fill over 16 windows).
//
// What it computes, per peak g < n_valid (centre (py, px), image
// coordinates): the 41 x 41 window centred there, pixels outside the
// plane read as NaN; above = finite & > threshold; a flood fill from the
// centre, member_0 = {centre}, member_r = dilate3x3(member_{r-1}) & above
// (8-connected), for at most half = 20 rounds; then, with
// v = max(win - bg_med, 0) on members and 0 elsewhere, window-relative
// coordinates (yy, xx) in 0..40:
//   npix, flux = sum v, cy = sum yy*v / sf, cx = sum xx*v / sf
//   (sf = max(flux, 1e-30)), r2m = sum (dx^2 + dy^2) v, sxx = sum dx^2 v
//   / sf, syy, sxy likewise (dx = xx - cx, dy = yy - cy), pval = max v.
// Rows of peaks g >= n_valid (the dead tail of the descending peak list)
// are written as zeros. n_valid, threshold and bg_med are read on the
// device. The plain torch version is
// analysis/window_kernel.py:window_stats_plain (the XLA gather + fill +
// moments of star_detection.py:360-406); the sums run in another order,
// so the moments agree to f32 rounding (rel 1e-4, the JAX package's own
// tolerance between its two forms), the membership exactly. The fill
// stops early at its fixed point — every later round is the identity —
// and never runs more than `half` rounds, which bounds a winding
// component the same way the XLA form does.
//
// What bounds it on the H100: the bytes, ~7 MB of window pixels for 1024
// peaks (~2 us at 3.35 TB/s). The operations are fewer than that takes:
// the fill works on 64-bit row masks (~17 operations per row and round,
// at most 20 rounds), the moments ~15 per member pixel, ~4e7 in all
// (~0.7 us at 67 TFLOP/s). What a warp waits for is memory latency, so
// the design issues every load of a window before it uses any.
//
// Design: one warp per peak, kWarps peaks per block (small blocks, so
// that 1024 peaks spread over all 132 SMs; 2, 4 and 8 warps measured
// within 2% of each other on the H100). The warp stages its window
// once, in registers: lane l holds columns l and l + 32 (lanes 0..8) of
// all 41 rows, 82 values whose subscripts are compile-time constants
// (fully unrolled loops), so they never reach local memory. All 82 loads
// are issued before the first use; pixels outside the plane are set to
// NaN and never loaded. Membership is one 64-bit mask per window row
// (bits 0..40): two ballots per row give the above-threshold masks, and
// lane l keeps those of its own rows l and l + 32. A fill round takes the
// neighbouring rows from lanes l - 1 and l + 1 by four 64-bit shuffles,
// then shifts and ORs; no shared memory, no __syncwarp; __any_sync on
// "changed" ends the loop at the fixed point. The moments read the
// staged values: a first pass broadcasts each row's mask, replaces each
// staged value by v (0 off the members) and sums flux and the centroid
// numerators; the second pass sums the second moments from v alone.
// npix is the sum of the row masks' popcounts. No global memory is read
// after the stage.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWin = 41;
constexpr int kHalf = kWin / 2;
constexpr int kTail = kWin - 32;   // rows / columns a lane holds past 32
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ u64 spread(u64 x) { return x | (x << 1) | (x >> 1); }

__global__ void __launch_bounds__(kWarps * 32)
window_stats_kernel(const float* __restrict__ image, int h, int w,
                    const int* __restrict__ pys, const int* __restrict__ pxs,
                    int k, const int* __restrict__ n_valid,
                    const float* __restrict__ threshold_p,
                    const float* __restrict__ bg_med_p,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= k) return;
  float* o = out + (size_t)g * 9;
  if (g >= min(*n_valid, k)) {
    if (lane < 9) o[lane] = 0.0f;
    return;
  }
  const float thr = *threshold_p;
  const float bg = *bg_med_p;
  const int y0 = pys[g] - kHalf;
  const int x0 = pxs[g] - kHalf;

  // ---- stage: every load of the window before any use ----
  const int xa = x0 + lane;
  const int xb = x0 + 32 + lane;
  const bool in_a = xa >= 0 && xa < w;
  const bool in_b = lane < kTail && xb >= 0 && xb < w;
  float va[kWin], vb[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    const int y = y0 + r;
    const bool row_in = y >= 0 && y < h;
    const long long row = (long long)y * w;
    va[r] = row_in && in_a ? __ldg(image + row + xa) : NAN;
    vb[r] = row_in && in_b ? __ldg(image + row + xb) : NAN;
  }

  // ---- above-threshold masks of the lane's rows l and l + 32 ----
  u64 above_a = 0ull, above_b = 0ull;
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    const unsigned lo = __ballot_sync(kFull, isfinite(va[r]) && va[r] > thr);
    const unsigned hi = __ballot_sync(kFull, isfinite(vb[r]) && vb[r] > thr);
    const u64 m = (u64)lo | ((u64)hi << 32);
    if (r < 32) {
      if (lane == r) above_a = m;
    } else {
      if (lane == r - 32) above_b = m;
    }
  }

  // ---- bounded flood fill in registers: at most kHalf rounds, exit at
  // the fixed point. Rows 41..63 (lanes 9..31's b) stay empty.
  u64 mem_a = lane == kHalf ? (1ull << kHalf) : 0ull;
  u64 mem_b = 0ull;
  const int up = (lane + 31) & 31;
  const int dn = (lane + 1) & 31;
  for (int round = 0; round < kHalf; ++round) {
    const u64 ua = __shfl_sync(kFull, mem_a, up);   // row l - 1 (l = 0: 31)
    const u64 ub = __shfl_sync(kFull, mem_b, up);   // row l + 31
    const u64 da = __shfl_sync(kFull, mem_a, dn);   // row l + 1 (l = 31: 0)
    const u64 db = __shfl_sync(kFull, mem_b, dn);   // row l + 33 (l = 31: 32)
    const u64 na = spread((lane ? ua : 0ull) | mem_a | (lane < 31 ? da : db)) &
                   above_a;
    const u64 nb = spread((lane ? ub : ua) | mem_b | (lane < 31 ? db : 0ull)) &
                   above_b;
    const bool changed = na != mem_a || nb != mem_b;
    mem_a = na;
    mem_b = nb;
    if (!__any_sync(kFull, changed)) break;
  }

  // ---- moments from the staged window: lanes over columns ----
  const int npix = __reduce_add_sync(kFull, __popcll(mem_a) + __popcll(mem_b));
  const float fa = (float)lane;
  const float fb = (float)(lane + 32);
  float s_f = 0.0f, s_y = 0.0f, s_x = 0.0f;
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    const u64 m = __shfl_sync(kFull, r < 32 ? mem_a : mem_b, r & 31);
    const float a = (m >> lane) & 1ull ? fmaxf(va[r] - bg, 0.0f) : 0.0f;
    const float b = (m >> (lane + 32)) & 1ull ? fmaxf(vb[r] - bg, 0.0f) : 0.0f;
    va[r] = a;
    vb[r] = b;
    s_f += a + b;
    s_y += (float)r * (a + b);
    s_x += fa * a + fb * b;
  }
  const float flux = warp_sum(s_f);
  const float sf = fmaxf(flux, 1e-30f);
  const float cy = warp_sum(s_y) / sf;
  const float cx = warp_sum(s_x) / sf;

  const float dxa = fa - cx;
  const float dxb = fb - cx;
  float s_r2 = 0.0f, s_xx = 0.0f, s_yy = 0.0f, s_xy = 0.0f, s_pk = 0.0f;
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    const float dy = (float)r - cy;
    const float a = va[r];
    const float b = vb[r];
    s_r2 += (dxa * dxa + dy * dy) * a + (dxb * dxb + dy * dy) * b;
    s_xx += dxa * dxa * a + dxb * dxb * b;
    s_yy += dy * dy * (a + b);
    s_xy += dxa * dy * a + dxb * dy * b;
    s_pk = fmaxf(s_pk, fmaxf(a, b));
  }
  const float r2m = warp_sum(s_r2);
  const float sxx = warp_sum(s_xx) / sf;
  const float syy = warp_sum(s_yy) / sf;
  const float sxy = warp_sum(s_xy) / sf;
  const float pval = warp_max(s_pk);
  if (lane == 0) {
    o[0] = (float)npix;
    o[1] = flux;
    o[2] = cy;
    o[3] = cx;
    o[4] = r2m;
    o[5] = sxx;
    o[6] = syy;
    o[7] = sxy;
    o[8] = pval;
  }
}

}  // namespace

// image [h, w] f32 (unpadded), pys/pxs [k] i32 peak centres; n_valid
// (i32), threshold and bg_med (f32): one-element device arrays, the
// 0-d tensors' own storage; out [k, 9] f32. Returns cudaGetLastError()
// after the launch.
extern "C" int abt_window_stats(const float* image, int h, int w,
                                const int* pys, const int* pxs, int k,
                                const int* n_valid, const float* threshold,
                                const float* bg_med, float* out,
                                void* stream) {
  if (k <= 0) return 0;
  const int blocks = (k + kWarps - 1) / kWarps;
  window_stats_kernel<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      image, h, w, pys, pxs, k, n_valid, threshold, bg_med, out);
  return static_cast<int>(cudaGetLastError());
}
