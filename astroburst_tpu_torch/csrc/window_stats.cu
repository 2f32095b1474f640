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
// (~0.7 us at 67 TFLOP/s). In practice it is latency: one warp per peak
// walks 41 rows in sequence.
//
// Design: one warp per peak, 8 peaks per block; no padded copy of the
// plane. Membership is one 64-bit mask per window row (bits 0..40):
// the above-threshold masks come from two warp ballots per row, a
// dilation round is shifts and ORs on the row masks (lane l owns rows l
// and l + 32), and the warp leaves the loop when no row changed. The
// moments read member pixels again (L1/L2-resident) with lanes across
// columns, and reduce by warp shuffles.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWin = 41;
constexpr int kHalf = kWin / 2;
constexpr int kWarps = 8;
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

__device__ __forceinline__ u64 spread(const u64* m, int r) {
  if (r < 0 || r >= kWin) return 0ull;
  const u64 x = m[r];
  return x | (x << 1) | (x >> 1);
}

__global__ void __launch_bounds__(kWarps * 32)
window_stats_kernel(const float* __restrict__ image, int h, int w,
                    const int* __restrict__ pys, const int* __restrict__ pxs,
                    int k, const int* __restrict__ n_valid,
                    const float* __restrict__ threshold_p,
                    const float* __restrict__ bg_med_p,
                    float* __restrict__ out) {
  __shared__ u64 s_above[kWarps][kWin];
  __shared__ u64 s_mem[kWarps][kWin];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
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
  u64* above = s_above[warp];
  u64* mem = s_mem[warp];

  // ---- above-threshold row masks: lanes over columns, two ballots ----
  const int xa = x0 + lane;
  const int xb = x0 + 32 + lane;
  const bool in_a = xa >= 0 && xa < w;
  const bool in_b = lane < kWin - 32 && xb >= 0 && xb < w;
  for (int r = 0; r < kWin; ++r) {
    const int y = y0 + r;
    const bool row_in = y >= 0 && y < h;
    const float va = row_in && in_a ? image[(size_t)y * w + xa] : NAN;
    const float vb = row_in && in_b ? image[(size_t)y * w + xb] : NAN;
    const unsigned lo = __ballot_sync(kFull, isfinite(va) && va > thr);
    const unsigned hi = __ballot_sync(kFull, isfinite(vb) && vb > thr);
    if (lane == 0) {
      above[r] = (u64)lo | ((u64)hi << 32);
      mem[r] = r == kHalf ? (1ull << kHalf) : 0ull;
    }
  }
  __syncwarp();

  // ---- bounded flood fill: at most kHalf rounds, exit at a fixed point
  const int ra = lane;
  const int rb = lane + 32;
  for (int round = 0; round < kHalf; ++round) {
    u64 na = 0ull, nb = 0ull;
    if (ra < kWin)
      na = (spread(mem, ra - 1) | spread(mem, ra) | spread(mem, ra + 1)) &
           above[ra];
    if (rb < kWin)
      nb = (spread(mem, rb - 1) | spread(mem, rb) | spread(mem, rb + 1)) &
           above[rb];
    const bool changed =
        (ra < kWin && na != mem[ra]) || (rb < kWin && nb != mem[rb]);
    __syncwarp();
    if (ra < kWin) mem[ra] = na;
    if (rb < kWin) mem[rb] = nb;
    __syncwarp();
    if (!__any_sync(kFull, changed)) break;
  }

  // ---- moments: lanes over columns ----
  const int ca = lane;
  const int cb = lane + 32;
  float s_n = 0.0f, s_f = 0.0f, s_y = 0.0f, s_x = 0.0f;
  for (int r = 0; r < kWin; ++r) {
    const u64 m = mem[r];
    const size_t row = (size_t)(y0 + r) * w;
    if ((m >> ca) & 1ull) {
      const float v = fmaxf(image[row + x0 + ca] - bg, 0.0f);
      s_n += 1.0f;
      s_f += v;
      s_y += (float)r * v;
      s_x += (float)ca * v;
    }
    if (cb < kWin && ((m >> cb) & 1ull)) {
      const float v = fmaxf(image[row + x0 + cb] - bg, 0.0f);
      s_n += 1.0f;
      s_f += v;
      s_y += (float)r * v;
      s_x += (float)cb * v;
    }
  }
  const float npix = warp_sum(s_n);
  const float flux = warp_sum(s_f);
  const float sf = fmaxf(flux, 1e-30f);
  const float cy = warp_sum(s_y) / sf;
  const float cx = warp_sum(s_x) / sf;

  float s_r2 = 0.0f, s_xx = 0.0f, s_yy = 0.0f, s_xy = 0.0f, s_pk = 0.0f;
  for (int r = 0; r < kWin; ++r) {
    const u64 m = mem[r];
    const size_t row = (size_t)(y0 + r) * w;
    const float dy = (float)r - cy;
    for (int half = 0; half < 2; ++half) {
      const int c = half ? cb : ca;
      if (c >= kWin || !((m >> c) & 1ull)) continue;
      const float v = fmaxf(image[row + x0 + c] - bg, 0.0f);
      const float dx = (float)c - cx;
      s_r2 += (dx * dx + dy * dy) * v;
      s_xx += dx * dx * v;
      s_yy += dy * dy * v;
      s_xy += dx * dy * v;
      s_pk = fmaxf(s_pk, v);
    }
  }
  const float r2m = warp_sum(s_r2);
  const float sxx = warp_sum(s_xx) / sf;
  const float syy = warp_sum(s_yy) / sf;
  const float sxy = warp_sum(s_xy) / sf;
  const float pval = warp_max(s_pk);
  if (lane == 0) {
    o[0] = npix;
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

// image [h, w] f32 (unpadded), pys/pxs [k] i32 peak centres, n_valid,
// threshold, bg_med: one-element device arrays (i32, f32, f32); out
// [k, 9] f32. Returns cudaGetLastError() after the launch.
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
