// K7 + K8: the exact drizzle's per-pixel finalize.
//
// Replaces the two TPU kernels
//   astroburst_tpu/stacking/drizzle_kernel.py:drizzle_finalize_fused
//     (K7: raw candidate values, w = wy * wx and finiteness in-kernel)
//   astroburst_tpu/stacking/drizzle_kernel.py:drizzle_finalize_pallas
//     (K8: values with materialized weights)
// with one templated kernel and two C entry points.
//
// What it computes, per output pixel (y, x) of [m, h, w] candidates in
// the reference's push order (frame, y-tap, x-tap; drizzle.rs:121-195):
//   - presence: K7 isfinite(v) && wy[y, f*ty+t] * wx[f*tx+u, x] > 1e-12,
//     K8 w[k, y, x] > 1e-12;
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
// products, sums and bounds here are written with __fmul_rn/__fadd_rn/
// __fsub_rn so nvcc cannot contract them to FMA, and every sum runs in
// the plain version's order, so image, weight map and rejected map match
// it bit for bit.
//
// What bounds it on the H100: bytes. Each candidate is read once
// (K7 at the bench band, 40 x 1024 x 8192 f32, is 1.34 GB, ~0.4 ms at
// 3.35 TB/s; K8 reads the weights as well), the outputs are 3 planes.
// The work per pixel is small: at most cap insertions, a few clip
// passes of O(cap) compares on a sorted array.
//
// Design: one thread owns one output pixel, blocks of 32 x 8 threads,
// so a warp reads 32 neighbouring floats of each candidate plane
// (coalesced). Live values never exceed cap = max(2n, 4), so they sit in
// a per-thread array sized by the template bound CAPMAX (32/64/128/256,
// picked from min(cap, m) by the entry point). Above 256 (more than 128
// frames) the live values go to a global scratch [depth, h, w] that the
// wrapper allocates, laid out pixel-minor — value j of pixel o at
// scratch[j * h * w + o] — so the threads of a warp touch neighbouring
// words at every step; the arithmetic and its order are the same, so
// that instance is bit-equal to the plain version too. It is slow (every
// insertion-sort move is a global access): runs past 128 frames are rare.
// Reading stops at the cap-th present push: later pushes can change
// nothing. The values are insertion-sorted as they arrive; the MAD's
// deviations |v - med| over a sorted window fall then rise (V shape), so
// a two-pointer walk out from the median gives their k-th smallest
// without a second sort. A pixel leaves the clip loop at its own fixed
// point (fewer than 3 values, or a pass that cut nothing): every later
// pass would be the identity, so the early exit is exact. The TPU
// kernel's bitonic networks existed because a TPU has no per-lane
// control flow. Building the candidates in the kernel (TPU kernel 9's
// idea) would remove their round trip through HBM; that is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMadToSigma = 1.4826f;
constexpr float kPresent = 1e-12f;

// One pixel's finalize. Its live value j is SV(j) = sv[j * stride]: a
// per-thread array (stride 1) or a pixel-minor column of the global
// scratch (stride h * w).
#define SV(j) sv[(size_t)(j) * stride]
template <bool FUSED>
__device__ __forceinline__ void finalize_pixel(
    float* sv, size_t stride, const float* __restrict__ cand_v,
    const float* __restrict__ cand_w, const float* __restrict__ wys_t,
    const float* __restrict__ wxs, int n, int taps_y, int taps_x, int m,
    int w, int cap, float sigma_low, float sigma_high, int iterations,
    int x, int y, size_t plane, size_t o, float* __restrict__ img,
    float* __restrict__ wgt, int* __restrict__ rej) {
  // ---- presence, push-order cap, weight map, sorted live values ----
  int live = 0;
  int order = 0;
  float wsum = 0.0f;
  const int per_frame = taps_y * taps_x;
  for (int k = 0; k < m; ++k) {
    const float v = cand_v[(size_t)k * plane + o];
    float wk;
    bool present;
    if (FUSED) {
      const int f = k / per_frame;
      const int r = k - f * per_frame;
      const int t = r / taps_x;
      const int u = r - t * taps_x;
      wk = __fmul_rn(wys_t[(size_t)y * (n * taps_y) + f * taps_y + t],
                     wxs[(size_t)(f * taps_x + u) * w + x]);
      present = isfinite(v) && wk > kPresent;
    } else {
      wk = cand_w[(size_t)k * plane + o];
      present = wk > kPresent;
    }
    if (!present) continue;
    if (++order > cap) break;  // every later push is past the cap
    wsum = __fadd_rn(wsum, wk);
    int j = live - 1;
    while (j >= 0 && SV(j) > v) {
      SV(j + 1) = SV(j);
      --j;
    }
    SV(j + 1) = v;
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
        __fmul_rn(__fadd_rn(SV(lo + k1), SV(lo + k2)), 0.5f);
    // deviations fall over [lo, r) and rise over [r, hi): merge outwards
    int r = lo;
    while (r < hi && SV(r) < med) ++r;
    int l = r - 1;
    float d1 = 0.0f, d2 = 0.0f;
    for (int s = 0; s <= k2; ++s) {
      const float dl = l >= lo ? fabsf(__fsub_rn(SV(l), med)) : INFINITY;
      const float dr = r < hi ? fabsf(__fsub_rn(SV(r), med)) : INFINITY;
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
    while (lo + cut_lo < hi && SV(lo + cut_lo) < vlo) ++cut_lo;
    int cut_hi = 0;
    while (hi - 1 - cut_hi >= lo && SV(hi - 1 - cut_hi) > vhi) ++cut_hi;
    lo += cut_lo;
    hi -= cut_hi;
    if (cut_lo + cut_hi == 0) break;  // stopped: a fixed point
  }

  // ---- outputs ----
  const int final_cnt = hi - lo;
  float result = 0.0f;
  if (final_cnt > 0) {
    float s = 0.0f;
    for (int j = lo; j < hi; ++j) s = __fadd_rn(s, SV(j));
    result = __fdiv_rn(s, (float)final_cnt);
  } else if (count0 > 0) {
    float s = 0.0f;
    for (int j = 0; j < count0; ++j) s = __fadd_rn(s, SV(j));
    result = __fdiv_rn(s, (float)count0);
  }
  img[o] = result;
  wgt[o] = wsum;
  rej[o] = count0 - final_cnt;
}

#undef SV

// Live values in a per-thread array of CAPMAX floats.
template <int CAPMAX, bool FUSED>
__global__ void __launch_bounds__(256)
drizzle_finalize_kernel(const float* __restrict__ cand_v,
                        const float* __restrict__ cand_w,
                        const float* __restrict__ wys_t,
                        const float* __restrict__ wxs, int n, int taps_y,
                        int taps_x, int m, int h, int w, int cap,
                        float sigma_low, float sigma_high, int iterations,
                        float* __restrict__ img, float* __restrict__ wgt,
                        int* __restrict__ rej) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * (size_t)w;
  const size_t o = (size_t)y * w + x;
  float sv[CAPMAX];
  finalize_pixel<FUSED>(sv, 1, cand_v, cand_w, wys_t, wxs, n, taps_y, taps_x,
                        m, w, cap, sigma_low, sigma_high, iterations, x, y,
                        plane, o, img, wgt, rej);
}

// Live values in the global scratch [min(cap, m), h, w]. The minimum of
// one block per SM lets ptxas use more than 32 registers: at the
// default it spilled the 64-bit scratch addressing.
template <bool FUSED>
__global__ void __launch_bounds__(256, 1)
drizzle_finalize_scratch_kernel(const float* __restrict__ cand_v,
                                const float* __restrict__ cand_w,
                                const float* __restrict__ wys_t,
                                const float* __restrict__ wxs, int n,
                                int taps_y, int taps_x, int m, int h, int w,
                                int cap, float sigma_low, float sigma_high,
                                int iterations, float* __restrict__ scratch,
                                float* __restrict__ img,
                                float* __restrict__ wgt,
                                int* __restrict__ rej) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * (size_t)w;
  const size_t o = (size_t)y * w + x;
  finalize_pixel<FUSED>(scratch + o, plane, cand_v, cand_w, wys_t, wxs, n,
                        taps_y, taps_x, m, w, cap, sigma_low, sigma_high,
                        iterations, x, y, plane, o, img, wgt, rej);
}

template <bool FUSED>
int launch(const float* cand_v, const float* cand_w, const float* wys_t,
           const float* wxs, int n, int taps_y, int taps_x, int m, int h,
           int w, int cap, float sigma_low, float sigma_high, int iterations,
           float* scratch, float* img, float* wgt, int* rej, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int depth = cap < m ? cap : m;
#define ABT_FINALIZE(CAPMAX)                                              \
  drizzle_finalize_kernel<CAPMAX, FUSED><<<grid, block, 0, s>>>(         \
      cand_v, cand_w, wys_t, wxs, n, taps_y, taps_x, m, h, w, cap,         \
      sigma_low, sigma_high, iterations, img, wgt, rej)
  if (depth <= 32)
    ABT_FINALIZE(32);
  else if (depth <= 64)
    ABT_FINALIZE(64);
  else if (depth <= 128)
    ABT_FINALIZE(128);
  else if (depth <= 256)
    ABT_FINALIZE(256);
  else if (scratch != nullptr)
    drizzle_finalize_scratch_kernel<FUSED><<<grid, block, 0, s>>>(
        cand_v, cand_w, wys_t, wxs, n, taps_y, taps_x, m, h, w, cap,
        sigma_low, sigma_high, iterations, scratch, img, wgt, rej);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef ABT_FINALIZE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7. cand_v [n*taps_y*taps_x, h, w] raw values, wys_t [h, n*taps_y],
// wxs [n*taps_x, w]; scratch [min(cap, m), h, w] f32 when min(cap, m) >
// 256, else unused (may be null). Returns cudaGetLastError() after the
// launch; min(cap, m) > 256 without a scratch is refused.
extern "C" int abt_drizzle_finalize_fused(const float* cand_v,
                                          const float* wys_t,
                                          const float* wxs, int n,
                                          int taps_y, int taps_x, int h,
                                          int w, int cap, float sigma_low,
                                          float sigma_high, int iterations,
                                          float* scratch, float* img,
                                          float* wgt, int* rej,
                                          void* stream) {
  return launch<true>(cand_v, nullptr, wys_t, wxs, n, taps_y, taps_x,
                      n * taps_y * taps_x, h, w, cap, sigma_low, sigma_high,
                      iterations, scratch, img, wgt, rej, stream);
}

// K8. cand_v, cand_w [m, h, w]; scratch as for K7. Same return
// convention.
extern "C" int abt_drizzle_finalize(const float* cand_v, const float* cand_w,
                                    int m, int h, int w, int cap,
                                    float sigma_low, float sigma_high,
                                    int iterations, float* scratch,
                                    float* img, float* wgt, int* rej,
                                    void* stream) {
  return launch<false>(cand_v, cand_w, nullptr, nullptr, 1, 1, 1, m, h, w,
                       cap, sigma_low, sigma_high, iterations, scratch, img,
                       wgt, rej, stream);
}
