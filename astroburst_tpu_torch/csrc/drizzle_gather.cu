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
// What bounds it on the H100: in principle bytes. The stack is read
// once (10 x 4096^2 f32 at the bench, 671 MB) and three [S*h, S*w]
// planes are written (805 MB at S = 2): 0.441 ms at 3.35 TB/s. No
// candidate tensor exists: the banded route writes and reads m = n *
// taps^2 candidate planes of the full output (40 x 8192^2 f32, 10.7 GB
// at the bench) and gathers them with index copies. In practice the
// per-pixel finalize sets the time: the insertions and clip passes on
// each pixel's live values, min/max and select instructions of the
// SM's ALU pipe (about two thirds of it the pushes, one third the clip
// passes at the bench).
//
// Design: one thread owns one output pixel of the FULL grid and writes
// the three planes straight into their interleaved places, so the
// interleave epilogue of the TPU route does not exist. The 32 threads
// of a warp cover 32 neighbouring input columns of ONE output column
// parity (every S-th output column; blockIdx.x = column block * S +
// parity): its lanes share the parity's shifts and tap weights, so they
// find the same pushes present and take the same branches, and each tap
// read is one coalesced 128-byte row segment. A candidate's weight is
// formed before its value is read, and a push of weight <= 1e-12 is
// skipped unread: an out-of-range tap has weight 0 (its index lies
// outside the plane, which the plan's weights carry), so the stack needs
// no padding and no read leaves it; an index outside the plane is
// refused in any case. The TPU kernel's block geometry (8 x 512 windows
// at (8, 128)-aligned origins, static residuals compiled per parity)
// has no counterpart: a thread computes its own indices.
//
// Three instances by the depth min(cap, n*taps^2), the most live values
// a pixel holds (the bench: min(20, 40) = 20), chosen in
// abt_drizzle_gather:
//   - depth <= 32: drizzle_gather_kernel<CAP>, CAP the depth rounded up
//     to a multiple of 4, the live values in registers (RegLive in
//     drizzle_finalize.cuh: every subscript a compile-time constant, so
//     no stack frame and no local memory), the pushes taken by a
//     (frame, y-tap, x-tap) walk; blocks of 32 x 8, at most 128
//     registers (__launch_bounds__(256, 2)). nvcc 12.9 for sm_90a: 48,
//     48, 48, 56, 59, 69, 78 and 85 registers at CAP 4 .. 32, 0-byte
//     stack frames, no spills. Bound by the ALU pipe;
//   - depth 33..256: drizzle_gather_shared_kernel, the live values in a
//     pixel-minor column of dynamic shared memory, s[j * threads + tid]
//     (finalize_pixel at stride `threads`: every access of a warp falls
//     in 32 different banks), blocks of 32 x 8, 32 x 4 or 32 x 2 so
//     that a block holds at most 64 KiB; 32 registers, no stack, no
//     spills. Bound by the insertion sort's data-dependent shifts;
//   - depth > 256: drizzle_gather_scratch_kernel, K7's global scratch
//     layout ([depth, S*h, S*w], pixel-minor; C10); 46 registers, no
//     stack, no spills. Bound by the scratch's traffic through L2.
// chip_smoke.py's build phase prints each instance's registers, stack
// and spills from -Xptxas -v, and fails on a spill or on a register
// instance with a stack frame.

#include "drizzle_finalize.cuh"

namespace {

using abt_drizzle::finalize_pixel;
using abt_drizzle::kPresent;

// The pushes (f, t, u) of output pixel (oy, ox), gathered from the stack.
struct GatherCands {
  const float* __restrict__ stack;
  const int* __restrict__ sy;
  const int* __restrict__ sx;
  const float* __restrict__ wys_t;
  const float* __restrict__ wxs;
  int n, taps, s, in_h, in_w, out_w, oy, ox, qy, qx, py, px;

  // push (f, t, u): its weight, then (only where the weight passed and
  // the index lies inside the plane) its value
  __device__ __forceinline__ bool load(int f, int t, int u, float& v,
                                       float& wk) const {
    wk = __fmul_rn(wys_t[(size_t)oy * (n * taps) + f * taps + t],
                   wxs[(size_t)(f * taps + u) * out_w + ox]);
    if (!(wk > kPresent)) return false;
    const int iy = qy + sy[f * s + py] + t;
    const int ix = qx + sx[f * s + px] + u;
    if (iy < 0 || iy >= in_h || ix < 0 || ix >= in_w) return false;
    v = stack[((size_t)f * in_h + iy) * in_w + ix];
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

#define ABT_GATHER_PARAMS                                                  \
  const float *__restrict__ stack, const int *__restrict__ sy,            \
      const int *__restrict__ sx, const float *__restrict__ wys_t,        \
      const float *__restrict__ wxs, int n, int taps, int s, int in_h,    \
      int in_w, int cap, float sigma_low, float sigma_high,               \
      int iterations

// Output pixel of this thread: a warp covers 32 neighbouring columns of
// ONE column parity (blockIdx.x = column block * s + parity), so its
// lanes share the parity's shifts and weights and push alike.
__device__ __forceinline__ bool pixel_of(int s, int in_w, int out_h, int& oy,
                                         int& ox) {
  const int px = blockIdx.x % s;
  const int qx = (blockIdx.x / s) * blockDim.x + threadIdx.x;
  ox = qx * s + px;
  oy = blockIdx.y * blockDim.y + threadIdx.y;
  return qx < in_w && oy < out_h;
}

// The pushes of one output pixel in push order (frame, y-tap, x-tap),
// walked without divisions; each call moves on to the next present one
// and returns false once they run out.
struct GatherWalk {
  GatherCands c;
  int f = 0, t = 0, u = 0;

  __device__ __forceinline__ bool next(float& v, float& wk) {
    while (f < c.n) {
      const bool present = c.load(f, t, u, v, wk);
      if (++u == c.taps) {
        u = 0;
        if (++t == c.taps) {
          t = 0;
          ++f;
        }
      }
      if (present) return true;
    }
    return false;
  }
};

// Depth <= CAP <= 32: the live values in registers. At most 128
// registers (two blocks an SM), which keeps every instance out of local
// memory.
template <int CAP>
__global__ void __launch_bounds__(256, 2)
drizzle_gather_kernel(ABT_GATHER_PARAMS, float* __restrict__ img,
                      float* __restrict__ wgt, int* __restrict__ rej) {
  int oy, ox;
  if (!pixel_of(s, in_w, in_h * s, oy, ox)) return;
  GatherWalk walk{pixel_cands(stack, sy, sx, wys_t, wxs, n, taps, s, in_h,
                              in_w, oy, ox)};
  abt_drizzle::RegLive<CAP> lv(cap);
  float x, wk;
  while (walk.next(x, wk)) {
    if (lv.full()) break;  // a present push past the cap: done
    lv.push(x, wk);
  }
  lv.finish(sigma_low, sigma_high, iterations,
            (size_t)oy * (in_w * s) + ox, img, wgt, rej);
}

// Depth 33..256: the live values in a pixel-minor column of dynamic
// shared memory, [depth][threads].
__global__ void __launch_bounds__(256)
drizzle_gather_shared_kernel(ABT_GATHER_PARAMS, float* __restrict__ img,
                             float* __restrict__ wgt,
                             int* __restrict__ rej) {
  extern __shared__ float s_live[];
  int oy, ox;
  if (!pixel_of(s, in_w, in_h * s, oy, ox)) return;
  const int out_w = in_w * s;
  const GatherCands cands = pixel_cands(stack, sy, sx, wys_t, wxs, n, taps,
                                        s, in_h, in_w, oy, ox);
  const int threads = blockDim.x * blockDim.y;
  finalize_pixel(s_live + threadIdx.y * blockDim.x + threadIdx.x,
                 (size_t)threads, cands, n * taps * taps, cap, sigma_low,
                 sigma_high, iterations, (size_t)oy * out_w + ox, img, wgt,
                 rej);
}

// Depth > 256: the live values in the global scratch [depth, S*h, S*w],
// pixel-minor (drizzle_finalize.cu's scratch instance).
__global__ void __launch_bounds__(256, 1)
drizzle_gather_scratch_kernel(ABT_GATHER_PARAMS,
                              float* __restrict__ scratch,
                              float* __restrict__ img,
                              float* __restrict__ wgt,
                              int* __restrict__ rej) {
  int oy, ox;
  if (!pixel_of(s, in_w, in_h * s, oy, ox)) return;
  const int out_w = in_w * s;
  const GatherCands cands = pixel_cands(stack, sy, sx, wys_t, wxs, n, taps,
                                        s, in_h, in_w, oy, ox);
  const size_t plane = (size_t)in_h * s * out_w;
  const size_t o = (size_t)oy * out_w + ox;
  finalize_pixel(scratch + o, plane, cands, n * taps * taps, cap, sigma_low,
                 sigma_high, iterations, o, img, wgt, rej);
}

#undef ABT_GATHER_PARAMS

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n * taps * taps;
  const int depth = cap < m ? cap : m;
  const int out_h = in_h * s;
  const int out_w = in_w * s;
  // blocks of 32 x 8; the shared instance keeps a block at <= 64 KiB
  const dim3 block(32, depth <= 32 || depth > abt_drizzle::kMaxSharedCap
                           ? 8 : abt_drizzle::shared_block_rows(depth));
  const dim3 grid((in_w + block.x - 1) / block.x * s,
                  (out_h + block.y - 1) / block.y);
#define ABT_GATHER_ARGS                                                     \
  stack, sy, sx, wys_t, wxs, n, taps, s, in_h, in_w, cap, sigma_low,        \
      sigma_high, iterations
  if (depth <= 32) {  // CAP = depth rounded up to a multiple of 4
#define ABT_REGS(CAP)                                                       \
  case CAP / 4:                                                             \
    drizzle_gather_kernel<CAP><<<grid, block, 0, st>>>(ABT_GATHER_ARGS, img, \
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
  } else if (depth <= abt_drizzle::kMaxSharedCap) {
    const size_t smem = (size_t)block.x * block.y * depth * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        drizzle_gather_shared_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    drizzle_gather_shared_kernel<<<grid, block, smem, st>>>(ABT_GATHER_ARGS,
                                                            img, wgt, rej);
  } else if (scratch != nullptr) {
    drizzle_gather_scratch_kernel<<<grid, block, 0, st>>>(
        ABT_GATHER_ARGS, scratch, img, wgt, rej);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ABT_GATHER_ARGS
  return static_cast<int>(cudaGetLastError());
}
