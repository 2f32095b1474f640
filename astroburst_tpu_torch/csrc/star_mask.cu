// K13: the star-mask raster.
//
// Replaces the TPU kernel
//   astroburst_tpu/imaging/star_mask_kernel.py:paint_mask_pallas
// (one program per 128^2 tile of a padded plane, star records by scalar
// prefetch, then a slice of the unpadded plane).
//
// What it computes: mask[r, c] = max over stars s with radius > 0 and
// (r, c) inside the star's 96 x 96 window — rows [y0 - 48, y0 + 48),
// columns [x0 - 48, x0 + 48), with y0 = clip(round(y), 0, h) and
// x0 = clip(round(x), 0, w) — of the smoothstep soft disk
// (star_mask.rs:61-98): with d2 = (c - x)^2 + (r - y)^2, 1 inside
// radius, 1 - t^2 (3 - 2t) for t = (d2 - radius^2) / fade up to
// radius + softness, 0 beyond; 0 where no star paints. Each product, sum
// and difference is written with __fmul_rn/__fadd_rn/__fsub_rn (no FMA
// contraction) and t is an IEEE division, so every value is the plain
// version's (imaging/star_mask_kernel.py:paint_mask_plain) bit for bit,
// and a max over values >= 0 does not depend on the order.
//
// What bounds it on the H100: bytes. The output plane is written once
// (4096^2 f32, 67 MB: ~0.02 ms at 3.35 TB/s); the disk arithmetic,
// ~20 operations for each pixel of each star's window (3000 stars x
// 9216 pixels), is ~0.01 ms at the f32 peak.
//
// Design: the star -> tile binning is torch in the wrapper, as the TPU
// wrapper does it in XLA: a star's window meets at most 2 x 2 tiles of
// 128^2 of the UNPADDED plane, the (tile, star) entries are sorted
// stably by tile, and seg[t] .. seg[t + 1] are tile t's entries in
// ascending star order. One block of 32 x 8 threads per tile stages the
// tile's star records in shared memory, 256 at a time; each thread keeps
// the 16 x 4 pixels it owns (rows ty + 8i, columns tx + 32j: a warp
// writes 32 neighbouring floats) in registers and max-accumulates the
// disks whose window covers them. The plane is written straight to
// [h, w]: the TPU route's padded plane and its slice copy do not exist.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;
constexpr int kHalf = 48;  // half the 96-pixel window
constexpr int kBx = 32;
constexpr int kBy = 8;
constexpr int kRows = kTile / kBy;  // 16 rows a thread
constexpr int kCols = kTile / kBx;  // 4 columns a thread
constexpr int kChunk = kBx * kBy;   // star records staged per pass

__device__ __forceinline__ float soft_disk(float d2, float r2_inner,
                                           float r2_outer, float fade) {
  if (d2 <= r2_inner) return 1.0f;
  if (!(d2 <= r2_outer)) return 0.0f;
  const float t =
      fminf(fmaxf(__fdiv_rn(__fsub_rn(d2, r2_inner), fade), 0.0f), 1.0f);
  return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(t, t),
                                   __fsub_rn(3.0f, __fmul_rn(2.0f, t))));
}

__global__ void __launch_bounds__(kChunk)
star_mask_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ radii,
                 const int* __restrict__ y0s, const int* __restrict__ x0s,
                 const int* __restrict__ order, const int* __restrict__ seg,
                 float softness, int h, int w, float* __restrict__ out) {
  __shared__ float s_x[kChunk], s_y[kChunk], s_r2i[kChunk], s_r2o[kChunk],
      s_fade[kChunk];
  __shared__ int s_y0[kChunk], s_x0[kChunk];
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int oy = blockIdx.y * kTile + threadIdx.y;
  const int ox = blockIdx.x * kTile + threadIdx.x;
  const int tid = threadIdx.y * kBx + threadIdx.x;
  float acc[kRows][kCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[a][b] = 0.0f;

  const int beg = seg[tile];
  const int end = seg[tile + 1];
  for (int c0 = beg; c0 < end; c0 += kChunk) {
    const int cn = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is no longer read
    if (tid < cn) {
      const int s = order[c0 + tid];
      const float radius = radii[s];
      const float soft_radius = __fadd_rn(radius, softness);
      const float r2i = __fmul_rn(radius, radius);
      const float r2o = __fmul_rn(soft_radius, soft_radius);
      s_x[tid] = xs[s];
      s_y[tid] = ys[s];
      s_r2i[tid] = r2i;
      s_r2o[tid] = r2o;
      s_fade[tid] = fmaxf(__fsub_rn(r2o, r2i), 1e-10f);
      s_y0[tid] = y0s[s];
      s_x0[tid] = x0s[s];
    }
    __syncthreads();
    for (int i = 0; i < cn; ++i) {
      const float x = s_x[i], y = s_y[i];
      const float r2i = s_r2i[i], r2o = s_r2o[i], fade = s_fade[i];
      const int y0 = s_y0[i], x0 = s_x0[i];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int r = oy + a * kBy;
        if (r < y0 - kHalf || r >= y0 + kHalf) continue;
        const float dy = __fsub_rn((float)r, y);
        const float dy2 = __fmul_rn(dy, dy);
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          const int c = ox + b * kBx;
          if (c < x0 - kHalf || c >= x0 + kHalf) continue;
          const float dx = __fsub_rn((float)c, x);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
          acc[a][b] = fmaxf(acc[a][b], soft_disk(d2, r2i, r2o, fade));
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = oy + a * kBy;
    if (r >= h) break;
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const int c = ox + b * kBx;
      if (c < w) out[(size_t)r * w + c] = acc[a][b];
    }
  }
}

}  // namespace

// K13. xs, ys, radii [k] f32 (only stars with radius > 0 are binned);
// y0s, x0s [k] i32 window anchors; order [entries] i32 star ids sorted by
// tile; seg [tiles_y * tiles_x + 1] i32 segment offsets into order, with
// tiles of 128^2 over the [h, w] plane; out [h, w] f32, every pixel
// written. Returns cudaGetLastError() after the launch.
extern "C" int abt_star_mask(const float* xs, const float* ys,
                             const float* radii, const int* y0s,
                             const int* x0s, const int* order, const int* seg,
                             float softness, int h, int w, float* out,
                             void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kBx, kBy);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  star_mask_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, radii, y0s, x0s, order, seg, softness, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
