// K1: coarse box-mean downsample of a frame stack, with the per-frame
// finite min/max/count of the phase-correlation validity gate.
//
// Replaces the TPU kernel
//   astroburst_tpu/alignment/coarse_kernel.py:coarse_downsample_stack
// (and the XLA form alignment/phase_correlation.py:_coarse_box_downsample).
//
// What it computes, on an UNPADDED contiguous [n, h, w] f32 stack with
// box (by, bx) and ds = (h / by, w / bx) (the largest divisible region;
// the caller picks by = ceil(h / max_dim), bx = ceil(w / max_dim)):
//   out[k, g, j] = scale * sum of the by x bx box at rows g*by.., cols
//                  j*bx.. of frame k, summed in f32 (scale = 1/(by*bx));
//   with_stats: per (frame, row group) block partial finite min, max and
//   count over ALL h x w pixels (the dropped remainder rows and columns
//   included), which the wrapper reduces per frame with torch, as
//   coarse_kernel.py:220-222 does.
// The TPU kernel casts the inputs to bf16 for the MXU
// (coarse_kernel.py:140); this one sums in f32. A non-finite pixel makes
// only its own box non-finite (the JAX band matmuls spread it to every
// box, since 0 * NaN = NaN).
//
// What bounds it on the H100: one read of the stack (798 MB at the
// bench shape, ~0.24 ms at 3.35 TB/s) and a 1/(by*bx)-sized write;
// about one add per byte, so HBM bandwidth bounds it.
//
// Design: one block of 256 threads per (row group g, frame k); a block
// walks its by rows once. Thread t sums boxes j = t, t + 256, ... of the
// group; a warp's reads cover 32 * bx neighbouring floats of a row
// across its bx column steps, so every fetched line is used out of L1.
// The stats fold rides on the same loads; the remainder columns (and,
// for the last group, the remainder rows) are folded in a short extra
// loop. The block's partials are reduced in shared memory and written
// to [n, ds_r] arrays: blocks run in no order, so nothing carries from
// one block to another.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void fold(float v, float& mn, float& mx,
                                     int& cnt) {
  if (isfinite(v)) {
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
    cnt += 1;
  }
}

__global__ void __launch_bounds__(kThreads)
coarse_box_kernel(const float* __restrict__ stack, int h, int w, int by,
                  int bx, int ds_r, int ds_c, float scale, int with_stats,
                  float* __restrict__ out, float* __restrict__ part_min,
                  float* __restrict__ part_max, int* __restrict__ part_cnt) {
  const int g = blockIdx.x;
  const int k = blockIdx.y;
  const float* f = stack + (size_t)k * (size_t)h * (size_t)w;
  const int r0 = g * by;
  float mn = INFINITY;
  float mx = -INFINITY;
  int cnt = 0;

  for (int j = threadIdx.x; j < ds_c; j += kThreads) {
    float s = 0.0f;
    for (int r = r0; r < r0 + by; ++r) {
      const float* row = f + (size_t)r * w + (size_t)j * bx;
      for (int c = 0; c < bx; ++c) {
        const float v = row[c];
        s += v;
        if (with_stats) fold(v, mn, mx, cnt);
      }
    }
    out[((size_t)k * ds_r + g) * ds_c + j] = s * scale;
  }
  if (!with_stats) return;

  // remainder columns of this group's rows
  for (int r = r0; r < r0 + by; ++r) {
    const float* row = f + (size_t)r * w;
    for (int c = ds_c * bx + threadIdx.x; c < w; c += kThreads)
      fold(row[c], mn, mx, cnt);
  }
  // remainder rows, folded by the last group
  if (g == ds_r - 1) {
    for (int r = ds_r * by; r < h; ++r) {
      const float* row = f + (size_t)r * w;
      for (int c = threadIdx.x; c < w; c += kThreads)
        fold(row[c], mn, mx, cnt);
    }
  }

  __shared__ float s_min[kThreads];
  __shared__ float s_max[kThreads];
  __shared__ int s_cnt[kThreads];
  s_min[threadIdx.x] = mn;
  s_max[threadIdx.x] = mx;
  s_cnt[threadIdx.x] = cnt;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_min[threadIdx.x] = fminf(s_min[threadIdx.x], s_min[threadIdx.x + stride]);
      s_max[threadIdx.x] = fmaxf(s_max[threadIdx.x], s_max[threadIdx.x + stride]);
      s_cnt[threadIdx.x] += s_cnt[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const size_t p = (size_t)k * ds_r + g;
    part_min[p] = s_min[0];
    part_max[p] = s_max[0];
    part_cnt[p] = s_cnt[0];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch. The part_* pointers are
// only read when with_stats is non-zero (they may be NULL otherwise).
extern "C" int abt_coarse_box(const float* stack, int n, int h, int w,
                              int by, int bx, int ds_r, int ds_c,
                              float scale, int with_stats, float* out,
                              float* part_min, float* part_max,
                              int* part_cnt, void* stream) {
  if (n <= 0 || ds_r <= 0 || ds_c <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ds_r, n);
  coarse_box_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, h, w, by, bx, ds_r, ds_c, scale, with_stats, out, part_min,
      part_max, part_cnt);
  return static_cast<int>(cudaGetLastError());
}
