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
// What bounds it on the H100: in principle bytes. Each candidate is read
// at most once (K7 at a 1024-row band of the drizzle bench, 40 x 1024 x
// 8192 f32, is 1.34 GB, ~0.4 ms at 3.35 TB/s; a pixel's walk stops at
// its cap-th present push, so at cap 20 about half of it is read; K8
// reads the weights as well), the outputs are 3 planes. The work per
// pixel is at most cap insertions and a few clip passes.
//
// Design: one thread owns one output pixel, blocks of 32 x 8 threads,
// so a warp reads 32 neighbouring floats of each candidate plane
// (coalesced). A pixel's live values never exceed depth = min(cap, m)
// (cap = max(2n, 4)); three instances by that depth, as K9's
// (drizzle_gather.cu), chosen in `launch`:
//   - depth <= 32: drizzle_finalize_kernel<CAP, FUSED>, CAP the depth
//     rounded up to a multiple of 4, the live values in registers
//     (RegLive, drizzle_finalize.cuh), at most 128 registers
//     (__launch_bounds__(256, 2)). The pushes are walked kBatch at a
//     time: the batch's weights, then the values of those whose weight
//     passed, are loaded before any is pushed, so a thread has kBatch
//     loads in flight instead of one (the walk is otherwise a chain of
//     dependent HBM round trips). A value read past the cap-th present
//     push is never used;
//   - depth 33..256: drizzle_finalize_shared_kernel, the live values in
//     a pixel-minor column of dynamic shared memory (finalize_pixel at
//     stride `threads`), blocks of 32 x shared_block_rows(depth);
//   - depth > 256 (more than 128 frames): drizzle_finalize_scratch_kernel,
//     the live values in a global scratch [depth, h, w] that the
//     wrapper allocates, laid out pixel-minor. It is slow (every
//     insertion-sort move is a global access): runs past 128 frames are
//     rare.
// Every instance keeps the push order, the arithmetic and its order, so
// each is bit-equal to the plain version. The TPU kernel's bitonic
// networks existed because a TPU has no per-lane control flow. K9 builds
// the candidates in the kernel instead, which removes their round trip
// through HBM.

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

#define ABT_FINALIZE_PARAMS                                               \
  const float *__restrict__ cand_v, const float *__restrict__ cand_w,     \
      const float *__restrict__ wys_t, const float *__restrict__ wxs,     \
      int n, int taps_y, int taps_x, int m, int h, int w, int cap,        \
      float sigma_low, float sigma_high, int iterations

constexpr int kBatch = 4;  // pushes whose loads a register walk overlaps

// Depth <= CAP <= 32: the live values in registers, the pushes k = (f *
// taps_y + t) * taps_x + u walked in order, kBatch at a time.
template <int CAP, bool FUSED>
__global__ void __launch_bounds__(256, 2)
drizzle_finalize_kernel(ABT_FINALIZE_PARAMS, float* __restrict__ img,
                        float* __restrict__ wgt, int* __restrict__ rej) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * (size_t)w;
  const size_t o = (size_t)y * w + x;
  const float* __restrict__ wy_row =
      FUSED ? wys_t + (size_t)y * (n * taps_y) : nullptr;
  abt_drizzle::RegLive<CAP> lv(cap);
  int f = 0, t = 0, u = 0;  // push k0 + i's frame and taps (FUSED)
  for (int k0 = 0; k0 < m && !lv.full(); k0 += kBatch) {
    float v[kBatch], wk[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = k0 + i;
      wk[i] = 0.0f;
      v[i] = 0.0f;
      if (k < m) {
        if (FUSED) {
          wk[i] = __fmul_rn(wy_row[f * taps_y + t],
                            wxs[(size_t)(f * taps_x + u) * w + x]);
          if (++u == taps_x) {
            u = 0;
            if (++t == taps_y) {
              t = 0;
              ++f;
            }
          }
        } else {
          wk[i] = cand_w[(size_t)k * plane + o];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (wk[i] > kPresent) v[i] = cand_v[(size_t)(k0 + i) * plane + o];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool present = wk[i] > kPresent && (!FUSED || isfinite(v[i]));
      if (present && !lv.full()) lv.push(v[i], wk[i]);
    }
  }
  lv.finish(sigma_low, sigma_high, iterations, o, img, wgt, rej);
}

// Depth 33..256: the live values in a pixel-minor column of dynamic
// shared memory, [depth][threads].
template <bool FUSED>
__global__ void __launch_bounds__(256)
drizzle_finalize_shared_kernel(ABT_FINALIZE_PARAMS,
                               float* __restrict__ img,
                               float* __restrict__ wgt,
                               int* __restrict__ rej) {
  extern __shared__ float s_live[];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * (size_t)w;
  const size_t o = (size_t)y * w + x;
  const ListCands<FUSED> cands{cand_v, cand_w, wys_t, wxs, n, taps_y,
                               taps_x, w,      x,     y,   plane, o};
  const int threads = blockDim.x * blockDim.y;
  finalize_pixel(s_live + threadIdx.y * blockDim.x + threadIdx.x,
                 (size_t)threads, cands, m, cap, sigma_low, sigma_high,
                 iterations, o, img, wgt, rej);
}

// Live values in the global scratch [min(cap, m), h, w]. The minimum of
// one block per SM lets ptxas use more than 32 registers: at the
// default it spilled the 64-bit scratch addressing.
template <bool FUSED>
__global__ void __launch_bounds__(256, 1)
drizzle_finalize_scratch_kernel(ABT_FINALIZE_PARAMS,
                                float* __restrict__ scratch,
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

#undef ABT_FINALIZE_PARAMS

template <bool FUSED>
int launch(const float* cand_v, const float* cand_w, const float* wys_t,
           const float* wxs, int n, int taps_y, int taps_x, int m, int h,
           int w, int cap, float sigma_low, float sigma_high, int iterations,
           float* scratch, float* img, float* wgt, int* rej, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int depth = cap < m ? cap : m;
  const bool shared = depth > 32 && depth <= abt_drizzle::kMaxSharedCap;
  const dim3 block(32, shared ? abt_drizzle::shared_block_rows(depth) : 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
#define ABT_FINALIZE_ARGS                                                  \
  cand_v, cand_w, wys_t, wxs, n, taps_y, taps_x, m, h, w, cap, sigma_low,  \
      sigma_high, iterations
  if (depth <= 32) {  // CAP = depth rounded up to a multiple of 4
#define ABT_REGS(CAP)                                                     \
  case CAP / 4:                                                           \
    drizzle_finalize_kernel<CAP, FUSED><<<grid, block, 0, s>>>(            \
        ABT_FINALIZE_ARGS, img, wgt, rej);                                \
    break
    switch ((depth + 3) / 4) {
      case 0:
      ABT_REGS(4);
      ABT_REGS(8);
      ABT_REGS(12);
      ABT_REGS(16);
      ABT_REGS(20);
      ABT_REGS(24);
      ABT_REGS(28);
      ABT_REGS(32);
    }
#undef ABT_REGS
  } else if (shared) {
    const size_t smem = (size_t)block.x * block.y * depth * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        drizzle_finalize_shared_kernel<FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    drizzle_finalize_shared_kernel<FUSED><<<grid, block, smem, s>>>(
        ABT_FINALIZE_ARGS, img, wgt, rej);
  } else if (scratch != nullptr) {
    drizzle_finalize_scratch_kernel<FUSED><<<grid, block, 0, s>>>(
        ABT_FINALIZE_ARGS, scratch, img, wgt, rej);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ABT_FINALIZE_ARGS
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
