// K9: the exact drizzle with its candidates gathered in the kernel.
//
// Replaces the TPU kernel
//   astroburst_tpu/stacking/drizzle_gather_kernel.py:
//     drizzle_gather_finalize_parity
// (one pallas_call per output parity plane over a padded stack, the
// shifts baked in as constants, then an interleave of the S^2 planes).
//
// What it computes: for an INTEGER scale S and an output of exactly S
// times the input, output pixel (oy, ox) = (S*qy + py, S*qx + px) has
// candidate (f, t, u) = stack[f, qy + sy[f, py] + t, qx + sx[f, px] + u]
// with weight wy[oy, f*taps+t] * wx[f*taps+u, ox]: the banded route's
// gather (stacking/drizzle.py:_axis_taps_exact) collapses to one integer
// shift per (frame, parity), which stacking/drizzle.py:_plan_parity
// computes and verifies on the host. The finalize of those candidates is
// K7's (drizzle_finalize.cuh): the same presence rule, push order and
// arithmetic, so the planes are bit-equal to the plain version
// (stacking/drizzle_gather_kernel.py:drizzle_gather_finalize_plain).
//
// What bounds it on the H100: bytes. The stack is read once (10 x 4096^2
// f32 at the bench, 671 MB) and three [S*h, S*w] planes are written
// (805 MB at S = 2): ~0.44 ms at 3.35 TB/s. No candidate tensor exists:
// the banded route writes and reads m = n * taps^2 candidate planes of
// the full output (40 x 8192^2 f32, 10.7 GB at the bench) and gathers
// them with index copies.
//
// Design: one thread owns one output pixel of the FULL grid, blocks of
// 32 x 8, and writes the three planes straight into their interleaved
// places, so the interleave epilogue of the TPU route does not exist.
// The 32 threads of a warp cover 32 neighbouring output columns, i.e.
// 16 input columns of each of the S column parities, so each tap read
// is a few coalesced segments that the neighbouring warps and taps reuse
// from L1/L2. A candidate's weight is formed before its value is read,
// and a push of weight <= 1e-12 is skipped unread: an out-of-range tap
// has weight 0 (its index lies outside the plane, which the plan's
// weights carry), so the stack needs no padding and no read leaves it;
// an index outside the plane is refused in any case. The TPU kernel's
// block geometry (8 x 512 windows at (8, 128)-aligned origins, static
// residuals compiled per parity) has no counterpart: a thread computes
// its own indices. Past 128 frames the live values go to K7's global
// scratch layout.

#include "drizzle_finalize.cuh"

namespace {

using abt_drizzle::finalize_pixel;
using abt_drizzle::kPresent;

// Push k = (f, t, u) of output pixel (oy, ox), gathered from the stack.
struct GatherCands {
  const float* __restrict__ stack;
  const int* __restrict__ sy;
  const int* __restrict__ sx;
  const float* __restrict__ wys_t;
  const float* __restrict__ wxs;
  int n, taps, s, in_h, in_w, out_w, oy, ox, qy, qx, py, px;

  __device__ __forceinline__ bool operator()(int k, float& v,
                                             float& wk) const {
    const int per_frame = taps * taps;
    const int f = k / per_frame;
    const int r = k - f * per_frame;
    const int t = r / taps;
    const int u = r - t * taps;
    wk = __fmul_rn(wys_t[(size_t)oy * (n * taps) + f * taps + t],
                   wxs[(size_t)(f * taps + u) * out_w + ox]);
    if (!(wk > kPresent)) return false;
    const int iy = qy + sy[f * s + py] + t;
    const int ix = qx + sx[f * s + px] + u;
    if (iy < 0 || iy >= in_h || ix < 0 || ix >= in_w) return false;
    v = stack[((size_t)f * in_h + iy) * in_w + ix];
    return isfinite(v);
  }
};

__device__ __forceinline__ GatherCands pixel_cands(
    const float* stack, const int* sy, const int* sx, const float* wys_t,
    const float* wxs, int n, int taps, int s, int in_h, int in_w, int oy,
    int ox) {
  const int qy = oy / s;
  const int qx = ox / s;
  return GatherCands{stack, sy,   sx,   wys_t, wxs, n,  taps,
                     s,     in_h, in_w, in_w * s, oy, ox, qy,
                     qx,    oy - qy * s,     ox - qx * s};
}

// Live values in a per-thread array of CAPMAX floats.
template <int CAPMAX>
__global__ void __launch_bounds__(256)
drizzle_gather_kernel(const float* __restrict__ stack,
                      const int* __restrict__ sy, const int* __restrict__ sx,
                      const float* __restrict__ wys_t,
                      const float* __restrict__ wxs, int n, int taps, int s,
                      int in_h, int in_w, int cap, float sigma_low,
                      float sigma_high, int iterations,
                      float* __restrict__ img, float* __restrict__ wgt,
                      int* __restrict__ rej) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int out_w = in_w * s;
  if (ox >= out_w || oy >= in_h * s) return;
  const GatherCands cands = pixel_cands(stack, sy, sx, wys_t, wxs, n, taps,
                                        s, in_h, in_w, oy, ox);
  float sv[CAPMAX];
  finalize_pixel(sv, 1, cands, n * taps * taps, cap, sigma_low, sigma_high,
                 iterations, (size_t)oy * out_w + ox, img, wgt, rej);
}

// Live values in the global scratch [min(cap, m), S*h, S*w], pixel-minor
// (drizzle_finalize.cu's scratch instance).
__global__ void __launch_bounds__(256, 1)
drizzle_gather_scratch_kernel(const float* __restrict__ stack,
                              const int* __restrict__ sy,
                              const int* __restrict__ sx,
                              const float* __restrict__ wys_t,
                              const float* __restrict__ wxs, int n, int taps,
                              int s, int in_h, int in_w, int cap,
                              float sigma_low, float sigma_high,
                              int iterations, float* __restrict__ scratch,
                              float* __restrict__ img,
                              float* __restrict__ wgt,
                              int* __restrict__ rej) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int out_w = in_w * s;
  if (ox >= out_w || oy >= in_h * s) return;
  const GatherCands cands = pixel_cands(stack, sy, sx, wys_t, wxs, n, taps,
                                        s, in_h, in_w, oy, ox);
  const size_t plane = (size_t)in_h * s * out_w;
  const size_t o = (size_t)oy * out_w + ox;
  finalize_pixel(scratch + o, plane, cands, n * taps * taps, cap, sigma_low,
                 sigma_high, iterations, o, img, wgt, rej);
}

}  // namespace

// K9. stack [n, in_h, in_w] f32 (raw: NaN/inf kept); sy, sx [n, s] i32:
// the input row/column of tap 0 at q = 0 for each frame and output
// parity; wys_t [s*in_h, n*taps] and wxs [n*taps, s*in_w] f32: the tap
// weights of the full output grid. scratch [min(cap, n*taps^2), s*in_h,
// s*in_w] f32 when that depth exceeds 256, else unused (may be null).
// img, wgt f32 and rej i32 [s*in_h, s*in_w]. Returns cudaGetLastError()
// after the launch; a depth over 256 without a scratch is refused.
extern "C" int abt_drizzle_gather(const float* stack, const int* sy,
                                  const int* sx, const float* wys_t,
                                  const float* wxs, int n, int taps, int s,
                                  int in_h, int in_w, int cap,
                                  float sigma_low, float sigma_high,
                                  int iterations, float* scratch, float* img,
                                  float* wgt, int* rej, void* stream) {
  if (in_h <= 0 || in_w <= 0 || n <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((in_w * s + block.x - 1) / block.x,
                  (in_h * s + block.y - 1) / block.y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n * taps * taps;
  const int depth = cap < m ? cap : m;
#define ABT_GATHER(CAPMAX)                                                  \
  drizzle_gather_kernel<CAPMAX><<<grid, block, 0, st>>>(                    \
      stack, sy, sx, wys_t, wxs, n, taps, s, in_h, in_w, cap, sigma_low,    \
      sigma_high, iterations, img, wgt, rej)
  if (depth <= 32)
    ABT_GATHER(32);
  else if (depth <= 64)
    ABT_GATHER(64);
  else if (depth <= 128)
    ABT_GATHER(128);
  else if (depth <= abt_drizzle::kMaxLocalCap)
    ABT_GATHER(abt_drizzle::kMaxLocalCap);
  else if (scratch != nullptr)
    drizzle_gather_scratch_kernel<<<grid, block, 0, st>>>(
        stack, sy, sx, wys_t, wxs, n, taps, s, in_h, in_w, cap, sigma_low,
        sigma_high, iterations, scratch, img, wgt, rej);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef ABT_GATHER
  return static_cast<int>(cudaGetLastError());
}
