// The exact banded drizzle in one launch: K7 with its candidates gathered
// in the kernel from per-row tap tables.
//
// Replaces no TPU kernel of its own. On the TPU the exact drizzle
// (astroburst_tpu/stacking/drizzle.py:_drizzle_kernel_exact) gathers one
// candidate tensor per band of output rows with XLA and finalizes it with
// astroburst_tpu/stacking/drizzle_kernel.py:drizzle_finalize_fused (K7).
// Done band by band on the card, that is per band some 40 small tap ops,
// an index copy that writes a [n*taps^2, band_rows, w] candidate tensor,
// K7 and the band's writes: about 10 000 launches and 10.7 GB of
// candidates a call at 10 x 4096^2 -> 8192^2.
//
// What it computes: for output pixel (y, x) of the padded grid (every band
// row, n_bands * band_rows of them), push k = (f, t, u) in the reference's
// order has weight wk = wys_t[y, f*taps+t] * wxs[f*taps+u, x] and value
// stack[f, iy[y, f*taps+t], ix[f*taps+u, x]]; it is present where wk >
// 1e-12 and the value is finite (K7's ListCands<true>). The tables are
// every band's own taps (stacking/drizzle.py:_band_row_tables: the row
// taps of every band from one batched _exact_taps call, laid out per
// output row; the x taps once), so the pushes, their order, the cap and
// the arithmetic of the finalize (drizzle_finalize.cuh) are K7's on the
// gathered candidates: the planes are bit-equal to K7 band by band. A
// value is read only after its weight passed; an index outside the plane
// is never present (the drizzle's tables clamp their indices into the
// plane, so it does not occur there), so no read leaves the stack.
//
// What bounds it on the H100: the per-pixel finalize on the ALU pipe, as
// K9 (drizzle_gather.cu), which walks the same pushes from per-parity
// shifts; the bytes are the stack read once (671 MB at the bench) and
// three planes written (805 MB). Over K9 each push reads one more table
// entry, the x index, from a [n*taps, w] table that L1 and L2 hold; the
// row tables are one [n*taps] row a block row, the same for a warp.
//
// Design: one thread owns one output pixel; blocks of 32 x 8 threads, so
// a warp covers 32 neighbouring columns of one row: its lanes share the
// row's weights and indices (one broadcast load each) and read the
// neighbouring x-tap entries and stack values (coalesced). Three
// instances by the depth min(cap, n*taps^2), as K7's and K9's:
//   - depth <= 32: drizzle_banded_kernel<CAP>, the live values in
//     registers (RegLive), at most 128 registers (__launch_bounds__(256,
//     2)); the pushes are walked kBatch at a time: the batch's weights
//     and addresses, then the values of those whose weight passed, are
//     loaded before any is pushed, so a thread has kBatch loads in flight
//     (K7's walk). A value read past the cap-th present push is never
//     used. nvcc for sm_90a: 48, 51, 55, 59, 63, 72, 80 and 85 registers
//     at CAP 4 .. 32, 0-byte stack frames, no spills;
//   - depth 33..256: drizzle_banded_shared_kernel, a pixel-minor column
//     of dynamic shared memory (finalize_pixel at stride `threads`),
//     blocks of 32 x shared_block_rows(depth); 32 registers;
//   - depth > 256: drizzle_banded_scratch_kernel, the live values in a
//     global scratch [depth, h, w], pixel-minor (K7's scratch layout); the
//     wrapper launches it over bands of rows so that the scratch stays
//     bounded; 42 registers.
// At the bench (depth 20) the kernel takes 14.0 ms on an H100 at 700 W,
// K9 12.0 ms, the band-by-band route it replaced 155 ms.
// chip_smoke.py's build phase prints each instance's registers, stack and
// spills from -Xptxas -v, and fails on a spill or on a register instance
// with a stack frame.

#include "drizzle_finalize.cuh"

namespace {

using abt_drizzle::finalize_pixel;
using abt_drizzle::kPresent;

// The pushes of output pixel (y, x), gathered from the stack through the
// tap tables; `wy_row` and `iy_row` are row y of wys_t and iy.
struct BandedCands {
  const float* __restrict__ stack;
  const float* __restrict__ wy_row;
  const int* __restrict__ iy_row;
  const float* __restrict__ wxs;
  const int* __restrict__ ix;
  int taps, in_h, in_w, w, x;

  // push (f, t, u): its weight, then (only where the weight passed and
  // the index lies inside the plane) its value
  __device__ __forceinline__ bool load(int f, int t, int u, float& v,
                                       float& wk) const {
    const int ft = f * taps + t;
    const size_t fu = (size_t)(f * taps + u) * w + x;
    wk = __fmul_rn(wy_row[ft], wxs[fu]);
    if (!(wk > kPresent)) return false;
    const int sy = iy_row[ft];
    const int sx = ix[fu];
    if (sy < 0 || sy >= in_h || sx < 0 || sx >= in_w) return false;
    v = stack[((size_t)f * in_h + sy) * in_w + sx];
    return isfinite(v);
  }

  // push k = (f * taps + t) * taps + u, for finalize_pixel
  __device__ __forceinline__ bool operator()(int k, float& v,
                                             float& wk) const {
    const int per_frame = taps * taps;
    const int f = k / per_frame;
    const int r = k - f * per_frame;
    const int t = r / taps;
    return load(f, t, r - t * taps, v, wk);
  }
};

#define ABT_BANDED_PARAMS                                                  \
  const float *__restrict__ stack, const int *__restrict__ iy,            \
      const float *__restrict__ wys_t, const int *__restrict__ ix,        \
      const float *__restrict__ wxs, int n, int taps, int in_h, int in_w, \
      int h, int w, int cap, float sigma_low, float sigma_high,           \
      int iterations

__device__ __forceinline__ BandedCands pixel_cands(
    const float* stack, const int* iy, const float* wys_t, const int* ix,
    const float* wxs, int n, int taps, int in_h, int in_w, int w, int y,
    int x) {
  const size_t row = (size_t)y * (n * taps);
  return BandedCands{stack, wys_t + row, iy + row, wxs, ix,
                     taps,  in_h,        in_w,     w,   x};
}

constexpr int kBatch = 4;  // pushes whose loads a register walk overlaps

// Depth <= CAP <= 32: the live values in registers, the pushes k = (f *
// taps + t) * taps + u walked in order, kBatch at a time.
template <int CAP>
__global__ void __launch_bounds__(256, 2)
drizzle_banded_kernel(ABT_BANDED_PARAMS, float* __restrict__ img,
                      float* __restrict__ wgt, int* __restrict__ rej) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const BandedCands c =
      pixel_cands(stack, iy, wys_t, ix, wxs, n, taps, in_h, in_w, w, y, x);
  const int m = n * taps * taps;
  abt_drizzle::RegLive<CAP> lv(cap);
  int f = 0, t = 0, u = 0;  // push k0 + i's frame and taps
  for (int k0 = 0; k0 < m && !lv.full(); k0 += kBatch) {
    float v[kBatch], wk[kBatch];
    const float* src[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      wk[i] = 0.0f;
      v[i] = 0.0f;
      src[i] = nullptr;
      if (k0 + i < m) {
        const int ft = f * taps + t;
        const size_t fu = (size_t)(f * taps + u) * w + x;
        wk[i] = __fmul_rn(c.wy_row[ft], wxs[fu]);
        const int sy = c.iy_row[ft];
        const int sx = ix[fu];
        if (sy >= 0 && sy < in_h && sx >= 0 && sx < in_w)
          src[i] = stack + ((size_t)f * in_h + sy) * in_w + sx;
        if (++u == taps) {
          u = 0;
          if (++t == taps) {
            t = 0;
            ++f;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (wk[i] > kPresent && src[i] != nullptr) v[i] = *src[i];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool present =
          wk[i] > kPresent && src[i] != nullptr && isfinite(v[i]);
      if (present && !lv.full()) lv.push(v[i], wk[i]);
    }
  }
  lv.finish(sigma_low, sigma_high, iterations, (size_t)y * w + x, img, wgt,
            rej);
}

// Depth 33..256: the live values in a pixel-minor column of dynamic
// shared memory, [depth][threads].
__global__ void __launch_bounds__(256)
drizzle_banded_shared_kernel(ABT_BANDED_PARAMS, float* __restrict__ img,
                             float* __restrict__ wgt,
                             int* __restrict__ rej) {
  extern __shared__ float s_live[];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const BandedCands cands =
      pixel_cands(stack, iy, wys_t, ix, wxs, n, taps, in_h, in_w, w, y, x);
  const int threads = blockDim.x * blockDim.y;
  finalize_pixel(s_live + threadIdx.y * blockDim.x + threadIdx.x,
                 (size_t)threads, cands, n * taps * taps, cap, sigma_low,
                 sigma_high, iterations, (size_t)y * w + x, img, wgt, rej);
}

// Depth > 256: the live values in the global scratch [depth, h, w],
// pixel-minor. One block an SM at least, as K7's scratch instance, so
// that ptxas may keep the 64-bit scratch addressing in registers.
__global__ void __launch_bounds__(256, 1)
drizzle_banded_scratch_kernel(ABT_BANDED_PARAMS,
                              float* __restrict__ scratch,
                              float* __restrict__ img,
                              float* __restrict__ wgt,
                              int* __restrict__ rej) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const BandedCands cands =
      pixel_cands(stack, iy, wys_t, ix, wxs, n, taps, in_h, in_w, w, y, x);
  const size_t o = (size_t)y * w + x;
  finalize_pixel(scratch + o, (size_t)h * w, cands, n * taps * taps, cap,
                 sigma_low, sigma_high, iterations, o, img, wgt, rej);
}

#undef ABT_BANDED_PARAMS

}  // namespace

// stack [n, in_h, in_w] f32 (raw: NaN/inf kept); iy [h, n*taps] i32 and
// wys_t [h, n*taps] f32: each output row's input row and weight of tap t
// of frame f at column f*taps+t; ix [n*taps, w] i32 and wxs [n*taps, w]
// f32: the same of each output column. scratch [min(cap, n*taps^2), h, w]
// f32 when that depth exceeds 256, else unused (may be null). img, wgt f32
// and rej i32 [h, w]. Returns cudaGetLastError() after the launch; a
// depth over 256 without a scratch is refused.
extern "C" int abt_drizzle_gather_banded(
    const float* stack, const int* iy, const float* wys_t, const int* ix,
    const float* wxs, int n, int taps, int in_h, int in_w, int h, int w,
    int cap, float sigma_low, float sigma_high, int iterations,
    float* scratch, float* img, float* wgt, int* rej, void* stream) {
  if (h <= 0 || w <= 0 || n <= 0 || taps <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n * taps * taps;
  const int depth = cap < m ? cap : m;
  const bool shared = depth > 32 && depth <= abt_drizzle::kMaxSharedCap;
  const dim3 block(32, shared ? abt_drizzle::shared_block_rows(depth) : 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
#define ABT_BANDED_ARGS                                                     \
  stack, iy, wys_t, ix, wxs, n, taps, in_h, in_w, h, w, cap, sigma_low,     \
      sigma_high, iterations
  if (depth <= 32) {  // CAP = depth rounded up to a multiple of 4
#define ABT_REGS(CAP)                                                       \
  case CAP / 4:                                                             \
    drizzle_banded_kernel<CAP><<<grid, block, 0, st>>>(ABT_BANDED_ARGS, img, \
                                                       wgt, rej);           \
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
        drizzle_banded_shared_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    drizzle_banded_shared_kernel<<<grid, block, smem, st>>>(ABT_BANDED_ARGS,
                                                            img, wgt, rej);
  } else if (scratch != nullptr) {
    drizzle_banded_scratch_kernel<<<grid, block, 0, st>>>(
        ABT_BANDED_ARGS, scratch, img, wgt, rej);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ABT_BANDED_ARGS
  return static_cast<int>(cudaGetLastError());
}
