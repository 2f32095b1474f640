// K7 + K8: the exact drizzle's per-pixel finalize.
//
// Replaces the two TPU kernels
//   astroburst_tpu/stacking/drizzle_kernel.py:drizzle_finalize_fused
//     (K7: raw candidate values, w = wy * wx and finiteness in-kernel)
//   astroburst_tpu/stacking/drizzle_kernel.py:drizzle_finalize_pallas
//     (K8: values with materialized weights)
// with one templated kernel and two C entry points.
//
// What it computes per output pixel, and how its live values are kept:
// drizzle_finalize.cuh (shared with K9, drizzle_gather.cu). Presence of
// push k = (f, t, u) of [m, h, w] candidates: K7 isfinite(v) &&
// wy[y, f*ty+t] * wx[f*tx+u, x] > 1e-12, K8 w[k, y, x] > 1e-12.
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
// wrapper allocates, laid out pixel-minor; the arithmetic and its order
// are the same, so that instance is bit-equal to the plain version too.
// It is slow (every insertion-sort move is a global access): runs past
// 128 frames are rare. The TPU kernel's bitonic networks existed because
// a TPU has no per-lane control flow. K9 builds the candidates in the
// kernel instead, which removes their round trip through HBM.

#include "drizzle_finalize.cuh"

namespace {

using abt_drizzle::finalize_pixel;
using abt_drizzle::kPresent;

// Push k of one pixel, read from the candidate tensor.
template <bool FUSED>
struct ListCands {
  const float* __restrict__ cand_v;
  const float* __restrict__ cand_w;
  const float* __restrict__ wys_t;
  const float* __restrict__ wxs;
  int n, taps_y, taps_x, w, x, y;
  size_t plane, o;

  __device__ __forceinline__ bool operator()(int k, float& v,
                                             float& wk) const {
    if (FUSED) {
      const int per_frame = taps_y * taps_x;
      const int f = k / per_frame;
      const int r = k - f * per_frame;
      const int t = r / taps_x;
      const int u = r - t * taps_x;
      wk = __fmul_rn(wys_t[(size_t)y * (n * taps_y) + f * taps_y + t],
                     wxs[(size_t)(f * taps_x + u) * w + x]);
      if (!(wk > kPresent)) return false;
      v = cand_v[(size_t)k * plane + o];
      return isfinite(v);
    }
    wk = cand_w[(size_t)k * plane + o];
    if (!(wk > kPresent)) return false;
    v = cand_v[(size_t)k * plane + o];
    return true;
  }
};

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
  const ListCands<FUSED> cands{cand_v, cand_w, wys_t, wxs, n, taps_y,
                               taps_x, w,      x,     y,   plane, o};
  float sv[CAPMAX];
  finalize_pixel(sv, 1, cands, m, cap, sigma_low, sigma_high, iterations, o,
                 img, wgt, rej);
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
  const ListCands<FUSED> cands{cand_v, cand_w, wys_t, wxs, n, taps_y,
                               taps_x, w,      x,     y,   plane, o};
  finalize_pixel(scratch + o, plane, cands, m, cap, sigma_low, sigma_high,
                 iterations, o, img, wgt, rej);
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
  else if (depth <= abt_drizzle::kMaxLocalCap)
    ABT_FINALIZE(abt_drizzle::kMaxLocalCap);
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
