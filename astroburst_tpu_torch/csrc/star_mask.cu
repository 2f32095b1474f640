// K13: the star-mask raster.
//
// Replaces the TPU kernel
//   astroburst_tpu/imaging/star_mask_kernel.py:paint_mask_pallas
// (one program per 128^2 tile of a padded plane, the tile's star records
// by scalar prefetch of a segment table binned in XLA, then a slice of
// the unpadded plane).
//
// What it computes: mask[r, c] = max over stars s with radius > 0 and
// (r, c) inside the star's 96 x 96 window — rows [y0 - 48, y0 + 48),
// columns [x0 - 48, x0 + 48), with y0 = clip(round(y), 0, h) and
// x0 = clip(round(x), 0, w), round half to even — of the smoothstep soft
// disk (star_mask.rs:61-98): with d2 = (c - x)^2 + (r - y)^2, 1 inside
// radius, 1 - t^2 (3 - 2t) for t = (d2 - radius^2) / fade up to
// radius + softness, 0 beyond; 0 where no star paints. Each product, sum
// and difference is written with __fmul_rn/__fadd_rn/__fsub_rn (no FMA
// contraction) and t is an IEEE division, so every value is the plain
// version's (imaging/star_mask_kernel.py:paint_mask_plain) bit for bit,
// and a max over values >= 0 does not depend on the order.
//
// What bounds it on the H100: bytes. The output plane is written once
// (4096^2 f32, 67 MB: ~0.02 ms at 3.35 TB/s); the star records are 12 B
// each. The cull (every record against every tile, ~4e6 tests at 4096^2
// with 4096 slots) and the disks (each painted star's support box, ~25^2
// pixels on the masked stretch's records) are far below that at the f32
// peak.
//
// Design: one launch, no binning outside it. One block of 32 x 16 threads per
// 128^2 tile of the [h, w] plane culls the K records itself, in rounds of
// 512, one record a thread: radius > 0, and the star's window, the disk's
// support box and the tile meet. A survivor is appended to a list in shared
// memory by a warp ballot, one atomic add a warp and the ballot's prefix
// count; its rectangle (window, box and tile intersected) goes with it, one
// byte a side. The block paints the list once it holds 512 stars or the
// records end, so a tile met by many stars (a dense cluster: several lists)
// and a tile met by none (zeros) take the same path. The support box is
// conservative: rows floor(y - reach) - 1 .. ceil(y + reach) + 1 with reach =
// max(radius, radius + softness), and the same for columns. In f32 a pixel
// with d2 <= reach^2 can lie |r - y| <= reach (1 + 2^-22) away, and y -/+
// reach rounds by less than 2^-5 while |y| + reach < 2^20, so the box holds
// every pixel the disk paints; past 2^20 the box is not applied (the window
// alone bounds the star). The exact per-pixel tests stay in the paint. Each
// thread keeps the 8 x 4 pixels it owns (rows ty + 16i, columns tx + 32j: a
// warp writes 32 neighbouring floats) in registers — 64 registers a thread,
// so two blocks (32 warps) share an SM and hide each other's waits — skips
// its rows outside a survivor's rectangle (the same rows for the whole warp)
// and evaluates the disk only at its pixels inside it. The plane is written
// once, straight to [h, w].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;
constexpr int kHalf = 48;  // half the 96-pixel window
constexpr int kBx = 32;
constexpr int kBy = 16;
constexpr int kRows = kTile / kBy;  // 8 rows a thread
constexpr int kCols = kTile / kBx;  // 4 columns a thread
constexpr int kChunk = kBx * kBy;   // threads of a block, records a round
// survivor slots: fewer than kChunk wait unpainted, plus one round's
constexpr int kCap = 2 * kChunk;
constexpr float kBoxLimit = 1048576.0f;  // 2^20: |y| + reach for the box

__device__ __forceinline__ float soft_disk(float d2, float r2_inner,
                                           float r2_outer, float fade) {
  if (d2 <= r2_inner) return 1.0f;
  if (!(d2 <= r2_outer)) return 0.0f;
  const float t =
      fminf(fmaxf(__fdiv_rn(__fsub_rn(d2, r2_inner), fade), 0.0f), 1.0f);
  return __fsub_rn(1.0f, __fmul_rn(__fmul_rn(t, t),
                                   __fsub_rn(3.0f, __fmul_rn(2.0f, t))));
}

// The window anchor clip(round(p), 0, n): rintf rounds half to even, as
// torch.round; clipped before the cast.
__device__ __forceinline__ int anchor(float p, int n) {
  return static_cast<int>(fminf(fmaxf(rintf(p), 0.0f),
                                static_cast<float>(n)));
}

// The cull of one record against the tile whose first row and column are
// (t_r, t_c) and whose last ones inside the plane are (t_r1, t_c1): true
// when the star paints and its window, its support box and the tile
// meet; *rect is then the rectangle they share, relative to the tile,
// one byte each: first row, last row, first column, last column.
__device__ __forceinline__ bool cull(float x, float y, float radius,
                                     float softness, int h, int w, int t_r,
                                     int t_c, int t_r1, int t_c1,
                                     unsigned* rect) {
  if (!(radius > 0.0f)) return false;
  const int y0 = anchor(y, h);
  const int x0 = anchor(x, w);
  int r_lo = max(y0 - kHalf, t_r), r_hi = min(y0 + kHalf - 1, t_r1);
  int c_lo = max(x0 - kHalf, t_c), c_hi = min(x0 + kHalf - 1, t_c1);
  const float reach = fmaxf(radius, __fadd_rn(radius, softness));
  if (fabsf(y) + reach < kBoxLimit) {
    r_lo = max(r_lo, static_cast<int>(floorf(__fsub_rn(y, reach))) - 1);
    r_hi = min(r_hi, static_cast<int>(ceilf(__fadd_rn(y, reach))) + 1);
  }
  if (fabsf(x) + reach < kBoxLimit) {
    c_lo = max(c_lo, static_cast<int>(floorf(__fsub_rn(x, reach))) - 1);
    c_hi = min(c_hi, static_cast<int>(ceilf(__fadd_rn(x, reach))) + 1);
  }
  *rect = static_cast<unsigned>(r_lo - t_r) |
          (static_cast<unsigned>(r_hi - t_r) << 8) |
          (static_cast<unsigned>(c_lo - t_c) << 16) |
          (static_cast<unsigned>(c_hi - t_c) << 24);
  return r_lo <= r_hi && c_lo <= c_hi;
}

__global__ void __launch_bounds__(kChunk, 2)
star_mask_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ radii, int k, float softness,
                 int h, int w, float* __restrict__ out) {
  __shared__ float s_x[kCap], s_y[kCap], s_rad[kCap];
  __shared__ unsigned s_rect[kCap];
  __shared__ int s_count;
  const int tile_r = blockIdx.y * kTile;
  const int tile_c = blockIdx.x * kTile;
  const int tile_r1 = min(tile_r + kTile, h) - 1;  // inclusive, in the plane
  const int tile_c1 = min(tile_c + kTile, w) - 1;
  const int oy = tile_r + threadIdx.y;
  const int ox = tile_c + threadIdx.x;
  const int tid = threadIdx.y * kBx + threadIdx.x;
  const int lane = threadIdx.x;  // kBx = 32: one warp per thread row
  float acc[kRows][kCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[a][b] = 0.0f;
  if (tid == 0) s_count = 0;

  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int s = c0 + tid;
    const bool in = s < k;
    const float x = in ? xs[s] : 0.0f;
    const float y = in ? ys[s] : 0.0f;
    const float radius = in ? radii[s] : 0.0f;
    __syncthreads();  // s_count is set, and read by all, before appends
    unsigned rect = 0;
    const bool keep = cull(x, y, radius, softness, h, w, tile_r, tile_c,
                           tile_r1, tile_c1, &rect);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      s_x[slot] = x;
      s_y[slot] = y;
      s_rad[slot] = radius;
      s_rect[slot] = rect;
    }
    __syncthreads();
    const int n = s_count;
    if (n < kChunk && c0 + kChunk < k) continue;  // the same for the block
    for (int i = 0; i < n; ++i) {
      const float sx = s_x[i], sy = s_y[i], sr = s_rad[i];
      const unsigned box = s_rect[i];
      const int rl = tile_r + static_cast<int>(box & 0xffu);
      const int rh = tile_r + static_cast<int>((box >> 8) & 0xffu);
      const int cl = tile_c + static_cast<int>((box >> 16) & 0xffu);
      const int ch = tile_c + static_cast<int>(box >> 24);
      const float soft_radius = __fadd_rn(sr, softness);
      const float si = __fmul_rn(sr, sr);
      const float so = __fmul_rn(soft_radius, soft_radius);
      const float sf = fmaxf(__fsub_rn(so, si), 1e-10f);
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int r = oy + a * kBy;
        if (r < rl || r > rh) continue;  // the same for the whole warp
        const float dy = __fsub_rn(static_cast<float>(r), sy);
        const float dy2 = __fmul_rn(dy, dy);
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          const int c = ox + b * kBx;
          if (c < cl || c > ch) continue;
          const float dx = __fsub_rn(static_cast<float>(c), sx);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), dy2);
          acc[a][b] = fmaxf(acc[a][b], soft_disk(d2, si, so, sf));
        }
      }
    }
    __syncthreads();  // every thread has read n and the survivors
    if (tid == 0) s_count = 0;
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = oy + a * kBy;
    if (r >= h) break;
#pragma unroll
    for (int b = 0; b < kCols; ++b) {
      const int c = ox + b * kBx;
      if (c < w) out[static_cast<size_t>(r) * w + c] = acc[a][b];
    }
  }
}

}  // namespace

// K13. xs, ys, radii [k] f32 (finite positions; a star paints where its
// radius is > 0); out [h, w] f32, every pixel written, by one block per
// 128^2 tile. Returns cudaGetLastError() after the launch.
extern "C" int abt_star_mask(const float* xs, const float* ys,
                             const float* radii, int k, float softness,
                             int h, int w, float* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kBx, kBy);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  star_mask_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, radii, k, softness, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
