// K3: fused Catmull-Rom shift + per-pixel sigma clip over a frame stack.
//
// Replaces the two TPU kernels
//   astroburst_tpu/stacking/onepass_kernel.py:_shift_clip_onepass_padded
//     (N <= 20, offsets clamped to +-16)
//   astroburst_tpu/stacking/fused_kernel.py:shift_clip_fused
//     (+ _preshift_integer; any N, offsets clamped to [-254, 253])
// with one kernel that takes any N and any offset (no clamp, as
// ops/resample.py:shift_bicubic and AstroBurst).
//
// What it computes, per output pixel (y, x) of an [n, h, w] stack:
//   for each frame k with offset (dy, dx):
//     - (dy, dx) == (0, 0) exactly: the raw pixel (align.rs identity;
//       the wrapper snaps |d| < 1e-12 to 0 first);
//     - the source centre (y + dy, x + dx) outside [-0.5, n - 0.5]: 0;
//     - else 4x4 Catmull-Rom taps on clamped source indices, summed in
//       shift_bicubic's separable order (for each of the 4 columns the
//       4-row sum, then the weighted column sum);
//   then the sigma clip of stacking/combine.py:sigma_clip_core over the
//   finite values: iteration 0 centres on the median with
//   sigma = max(MAD * 1.4826, 1e-10), both taken at sorted index cnt/2
//   (select-nth, no even averaging); later iterations on mean and sample
//   std, summed in frame order; asymmetric bounds; a pixel is active
//   while cnt >= 2 and the last pass removed something. The result is
//   the mean of the survivors (in frame order), else the last finite
//   centre, else 0. rejected[y, x] is the number of finite values that
//   did not survive. A pixel leaves the clip loop at its own fixed
//   point (a pass that removes nothing, or fewer than 2 values, leaves
//   every later pass the identity), so the early exit is exact (the TPU
//   kernel exits block-wide, clip_kernel.py:128-133).
//
// What bounds it on the H100: the stack is read once from HBM
// (16 x 5655 x 2206 f32 = 798 MB, ~0.24 ms at 3.35 TB/s), and each
// frame's 16 taps per pixel hit L1/L2 because neighbouring threads
// share rows. The rest is the per-pixel clip: arithmetic on the pixel's
// n values, which sets the time unless those values stay in registers.
//
// The slab entry (onepass_kernel.py:shift_clip_onepass_slab, for a row
// shard of parallel/pipeline.py; TPU: onepass_kernel.py:491) runs the
// same instances on [n, local_h + 2 halo, w]: output row r reads the
// slab rows around r + halo, the taps clamp to the slab (its halos hold
// the neighbours' rows, or replicas of the edge row at the image's
// edges), and the outside-source mask takes the global row grow0 + r
// against the global height gh. With halo >= ceil(max |dy|) + 2 no tap
// reaches past the slab, so the stitched slabs are bit-equal to the
// whole-stack launch.
//
// Design: one thread per output pixel, blocks of 32 x by threads so a
// warp reads 32 neighbouring floats of a row (coalesced). Nothing
// carries between blocks. Three instances, chosen by the wrapper's plan
// (stacking/onepass_kernel.py:_clip_plan) and checked here:
//   - n <= 32, shift_clip_kernel<CAP> (CAP = n rounded up to a multiple
//     of 4): the frame-order values in a register array, the keep flags
//     in a 32-bit mask. At iteration 0 a sorted copy of the finite
//     values is built by a median-of-three insertion (reg_select.cuh;
//     a non-finite value enters as +inf and changes nothing), the
//     median read at rank cnt/2 by a select tree, the deviations
//     |v - median| of that copy (they fall, then rise) sorted by one
//     bitonic merge and the MAD read at rank cnt/2; the copy is dead
//     after. Later passes sum the kept values in frame order, masked by
//     the keep bits. Every subscript is a compile-time constant, so no
//     value touches local memory; at most 128 registers
//     (__launch_bounds__(256, 2)). The value at a rank of a multiset
//     does not depend on how it was found, so this is bit for bit the
//     insertion sort's result, up to the sign of a zero (+-0 may swap
//     places in the min/max insertion);
//   - 33 <= n <= 128, shift_clip_shared_kernel: two pixel-minor columns
//     per thread in dynamic shared memory, s[k * threads + tid] (a
//     warp's lanes hit 32 different banks): the frame-order values (a
//     clipped value is overwritten by NaN, so "finite" is the keep flag)
//     and, at iteration 0, the finite values insertion-sorted, whose
//     median is read directly and whose MAD is the cnt/2-th step of a
//     two-pointer walk out from the median; blocks of 32 x 8, or 32 x 4
//     where 8 rows would pass 232,448 bytes (n > 113);
//   - n > 128, shift_clip_scratch_kernel: the frame-order column in a
//     global scratch [n, rows, w], pixel-minor, launched over bands of
//     `rows` output rows so the scratch stays bounded (the taps read the
//     whole stack, so a band changes nothing in the arithmetic). No
//     sorted copy: the median and the MAD are radix selects over the
//     column (16 passes a pixel, counters in shared memory), since an
//     insertion sort in global memory costs ~n^2/2 scratch reads and
//     writes a pixel. Bound by the scratch's traffic; runs past 128
//     frames are rare.
// shifted_value and every sum are written as before the redesign, so
// nvcc contracts the same products to FMA and the instances agree with
// each other and with the earlier one-instance kernel bit for bit, up
// to the sign of a zero. chip_smoke.py's build phase fails a register
// instance with a stack frame.

#include <cuda_runtime.h>
#include <math.h>

#include "reg_select.cuh"

namespace {

constexpr float kMadToSigma = 1.4826f;
constexpr int kMaxRegFrames = 32;      // register instances: CAP 4..32
constexpr int kMaxSharedFrames = 128;  // shared instance: 33..128
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float cr_weight(float t) {
  // Catmull-Rom, fused_kernel.py:_cr_weights / resample.py:catmull_rom
  const float a = fabsf(t);
  const float inner = a * a * (1.5f * a - 2.5f) + 1.0f;
  const float outer = a * (a * (2.5f - 0.5f * a) - 4.0f) + 2.0f;
  return a <= 1.0f ? inner : (a <= 2.0f ? outer : 0.0f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Frame f's value at slab row y, column x, shifted by (dy, dx): the
// taps clamp to the slab's rows [0, h); the outside-source mask takes
// the global row gy against the global height gh (a whole stack is its
// own slab: gy = y, gh = h).
__device__ float shifted_value(const float* __restrict__ f, int h, int w,
                               int y, int x, float dy, float dx, int gy,
                               int gh) {
  if (dy == 0.0f && dx == 0.0f) return f[(size_t)y * w + x];
  const float sy = (float)gy + dy;
  const float sx = (float)x + dx;
  if (!(sy >= -0.5f && sy <= (float)gh - 0.5f && sx >= -0.5f &&
        sx <= (float)w - 0.5f))
    return 0.0f;
  const float fky = floorf(dy);
  const float fkx = floorf(dx);
  const int ky = (int)fky;
  const int kx = (int)fkx;
  const float fy = dy - fky;
  const float fx = dx - fkx;
  float wy[4];
  size_t rows[4];
  int cols[4];
  float wx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wy[j] = cr_weight(fy - (float)(j - 1));
    wx[j] = cr_weight(fx - (float)(j - 1));
    rows[j] = (size_t)clampi(y + ky + j - 1, 0, h - 1) * (size_t)w;
    cols[j] = clampi(x + kx + j - 1, 0, w - 1);
  }
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = wy[0] * f[rows[0] + cols[i]];
    t = t + wy[1] * f[rows[1] + cols[i]];
    t = t + wy[2] * f[rows[2] + cols[i]];
    t = t + wy[3] * f[rows[3] + cols[i]];
    out = (i == 0) ? wx[0] * t : out + wx[i] * t;
  }
  return out;
}

// The clip loop of one pixel over its frames `fr` (count0 finite
// values), writing out[o] and rejected[o]. Frames provides
// median_mad(cnt, center, mad) (iteration 0, rank cnt/2 of the finite
// values and of their |v - center|), sum() and sum_sq(center) over the
// kept values in frame order, and clip(center, lo, hi) → the kept count.
template <class Frames>
__device__ __forceinline__ void clip_pixel(Frames& fr, int count0,
                                           float sigma_low, float sigma_high,
                                           int max_iter, size_t o,
                                           float* __restrict__ out,
                                           int* __restrict__ rejected) {
  int cnt = count0;
  bool stopped = false;
  bool have_center = false;
  float last_center = 0.0f;
  for (int it = 0; it < max_iter; ++it) {
    if (cnt < 2 || stopped) break;  // inactive now and in every later pass
    float center, sigma;
    if (it == 0) {
      float mad;
      fr.median_mad(cnt, center, mad);
      sigma = fmaxf(mad * kMadToSigma, 1e-10f);
    } else {
      const float cntf = (float)cnt;
      center = fr.sum() / cntf;
      sigma = fmaxf(sqrtf(fr.sum_sq(center) / fmaxf(cntf - 1.0f, 1.0f)),
                    1e-10f);
    }
    const float lo = -sigma_low * sigma;
    const float hi = sigma_high * sigma;
    const int new_cnt = fr.clip(center, lo, hi);
    last_center = center;
    have_center = true;
    stopped = (new_cnt == cnt);
    cnt = new_cnt;
  }
  float result;
  if (cnt > 0)
    result = fr.sum() / (float)cnt;
  else
    result = (have_center && isfinite(last_center)) ? last_center : 0.0f;
  out[o] = result;
  rejected[o] = count0 - cnt;
}

// n <= CAP frames in registers: values in frame order, keep bit k.
template <int CAP>
struct RegFrames {
  float v[CAP];
  unsigned keep = 0u;

  __device__ __forceinline__ bool kept(int k) const {
    return (keep >> k) & 1u;
  }

  __device__ __forceinline__ void median_mad(int cnt, float& center,
                                             float& mad) const {
    float s[CAP];  // the finite values ascending, +inf past them
#pragma unroll
    for (int i = 0; i < CAP; ++i) s[i] = INFINITY;
#pragma unroll
    for (int k = 0; k < CAP; ++k)  // at most k values held before frame k
      abt_reg::sorted_insert(s, kept(k) ? v[k] : INFINITY, k);
    center = abt_reg::reg_at(s, cnt / 2);
#pragma unroll
    for (int i = 0; i < CAP; ++i) s[i] = fabsf(s[i] - center);
    abt_reg::bitonic_merge(s);
    mad = abt_reg::reg_at(s, cnt / 2);
  }

  __device__ __forceinline__ float sum() const {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < CAP; ++k)
      if (kept(k)) s = s + v[k];
    return s;
  }

  __device__ __forceinline__ float sum_sq(float center) const {
    float s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < CAP; ++k)
      if (kept(k)) {
        const float d = v[k] - center;
        s2 = s2 + d * d;
      }
    return s2;
  }

  __device__ __forceinline__ int clip(float center, float lo, float hi) {
    unsigned next = 0u;
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      const float d = v[k] - center;
      if (kept(k) && (d >= lo) && (d <= hi)) next |= 1u << k;
    }
    keep = next;
    return __popc(next);
  }
};

// Frames in a pixel-minor column at a stride: V(k) the frame-order
// values (a clipped value is overwritten by NaN, so a value is kept iff
// it is finite). sum, sum_sq and clip walk V in frame order.
struct ColFrames {
  float* col;  // V(k) = col[k * stride]
  size_t stride;
  int n;

  __device__ __forceinline__ float& V(int k) const {
    return col[(size_t)k * stride];
  }

  __device__ __forceinline__ float sum() const {
    float s = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float x = V(k);
      if (isfinite(x)) s = s + x;
    }
    return s;
  }

  __device__ __forceinline__ float sum_sq(float center) const {
    float s2 = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float x = V(k);
      if (isfinite(x)) {
        const float d = x - center;
        s2 = s2 + d * d;
      }
    }
    return s2;
  }

  __device__ __forceinline__ int clip(float center, float lo, float hi) {
    int c = 0;
    for (int k = 0; k < n; ++k) {
      const float x = V(k);
      if (!isfinite(x)) continue;
      const float d = x - center;
      if ((d >= lo) && (d <= hi))
        ++c;
      else
        V(k) = NAN;
    }
    return c;
  }
};

// The shared instance: a second column S(j) = col[(n + j) * stride]
// holds the finite values insertion-sorted at iteration 0.
struct SortedColFrames : ColFrames {
  __device__ __forceinline__ float& S(int j) const {
    return col[(size_t)(n + j) * stride];
  }

  __device__ __forceinline__ void median_mad(int cnt, float& center,
                                             float& mad) const {
    int m = 0;
    for (int k = 0; k < n; ++k) {
      const float x = V(k);
      if (!isfinite(x)) continue;
      int j = m - 1;
      while (j >= 0 && S(j) > x) {
        S(j + 1) = S(j);
        --j;
      }
      S(j + 1) = x;
      ++m;
    }
    const int k2 = cnt / 2;
    center = S(k2);
    // deviations fall over [0, k2) and rise over [k2, cnt): merge
    // outwards; the k2-th smallest is the MAD
    int l = k2 - 1;
    int r = k2;
    float d = 0.0f;
    for (int s = 0; s <= k2; ++s) {
      const float dl = l >= 0 ? fabsf(S(l) - center) : INFINITY;
      const float dr = r < cnt ? fabsf(S(r) - center) : INFINITY;
      if (dl <= dr) {
        d = dl;
        --l;
      } else {
        d = dr;
        ++r;
      }
    }
    mad = d;
  }
};

// f32 -> u32 in the same order (-0 just below +0; NaN never enters).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The scratch instance: no sorted copy. The median and the MAD are
// found by a radix select over V, most significant 4-bit digit first:
// eight passes, each counting the digits of the keys that share the
// digits found so far in this thread's 16 counters hist[d * hstride]
// (shared memory, a warp's lanes in 32 banks). Sixteen reads of the
// column a pixel where an insertion sort takes ~n^2/2 reads and writes.
struct SelectColFrames : ColFrames {
  unsigned* hist;
  int hstride;

  // rank r (0-based, ascending) of key_of(x) over the finite V(k)
  template <class KeyOf>
  __device__ __forceinline__ unsigned select(int r, KeyOf key_of) const {
    unsigned prefix = 0u;
    for (int shift = 28; shift >= 0; shift -= 4) {
      const unsigned hi = shift == 28 ? 0u : 0xffffffffu << (shift + 4);
#pragma unroll
      for (int d = 0; d < 16; ++d) hist[d * hstride] = 0u;
      for (int k = 0; k < n; ++k) {
        const float x = V(k);
        if (!isfinite(x)) continue;
        const unsigned key = key_of(x);
        if ((key & hi) == prefix) hist[((key >> shift) & 15u) * hstride]++;
      }
      unsigned below = 0u;
      unsigned digit = 0u;
      for (; digit < 15u; ++digit) {
        const unsigned c = hist[digit * hstride];
        if (below + c > (unsigned)r) break;
        below += c;
      }
      r -= (int)below;
      prefix |= digit << shift;
    }
    return prefix;
  }

  __device__ __forceinline__ void median_mad(int cnt, float& center,
                                             float& mad) const {
    const float c = key_value(select(cnt / 2, [](float x) {
      return order_key(x);
    }));
    center = c;
    // |v - c| >= 0: its bits are already in order
    mad = __uint_as_float(select(cnt / 2, [c](float x) {
      return __float_as_uint(fabsf(x - c));
    }));
  }
};

#define ABT_CLIP_PARAMS                                                    \
  const float *__restrict__ stack, const float *__restrict__ dys,         \
      const float *__restrict__ dxs, int n, int h, int w,                 \
      float sigma_low, float sigma_high, int max_iter, int y0, int rows,  \
      int out_off, int grow0, int gh, float *__restrict__ out,            \
      int *__restrict__ rejected

// This thread's output pixel (y, x) of the band [y0, y0 + rows).
__device__ __forceinline__ bool pixel_of(int w, int y0, int rows, int& y,
                                         int& x) {
  x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  y = y0 + r;
  return x < w && r < rows;
}

// n <= CAP <= 32: every value in registers.
template <int CAP>
__global__ void __launch_bounds__(256, 2)
shift_clip_kernel(ABT_CLIP_PARAMS) {
  int y, x;
  if (!pixel_of(w, y0, rows, y, x)) return;
  const size_t plane = (size_t)h * (size_t)w;
  RegFrames<CAP> fr;
  int count0 = 0;
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    fr.v[k] = 0.0f;
    if (k < n) {
      const float val = shifted_value(stack + (size_t)k * plane, h, w,
                                      y + out_off, x, dys[k], dxs[k],
                                      y + grow0, gh);
      fr.v[k] = val;
      if (isfinite(val)) {
        fr.keep |= 1u << k;
        ++count0;
      }
    }
  }
  clip_pixel(fr, count0, sigma_low, sigma_high, max_iter,
             (size_t)y * w + x, out, rejected);
}

// The shifted values of this pixel into column V of `fr`; returns the
// finite count.
__device__ __forceinline__ int load_column(const ColFrames& fr,
                                           const float* __restrict__ stack,
                                           const float* __restrict__ dys,
                                           const float* __restrict__ dxs,
                                           int h, int w, int y, int x,
                                           int gy, int gh) {
  const size_t plane = (size_t)h * (size_t)w;
  int count0 = 0;
  for (int k = 0; k < fr.n; ++k) {
    const float val = shifted_value(stack + (size_t)k * plane, h, w, y, x,
                                    dys[k], dxs[k], gy, gh);
    fr.V(k) = val;
    count0 += isfinite(val) ? 1 : 0;
  }
  return count0;
}

// 33..128 frames: two columns of 2n floats per thread in dynamic shared
// memory, [2n][threads].
__global__ void __launch_bounds__(256)
shift_clip_shared_kernel(ABT_CLIP_PARAMS) {
  extern __shared__ float s_cols[];
  int y, x;
  if (!pixel_of(w, y0, rows, y, x)) return;
  const int threads = blockDim.x * blockDim.y;
  SortedColFrames fr{{s_cols + threadIdx.y * blockDim.x + threadIdx.x,
                      (size_t)threads, n}};
  const int count0 = load_column(fr, stack, dys, dxs, h, w, y + out_off,
                                 x, y + grow0, gh);
  clip_pixel(fr, count0, sigma_low, sigma_high, max_iter,
             (size_t)y * w + x, out, rejected);
}

// Past 128 frames: column V in the global scratch [n, rows, w] of this
// band, pixel-minor, and the select's counters in shared memory. The
// minimum of one block per SM lets ptxas use more than 32 registers for
// the 64-bit scratch addressing.
__global__ void __launch_bounds__(256, 1)
shift_clip_scratch_kernel(ABT_CLIP_PARAMS, float* __restrict__ scratch) {
  __shared__ unsigned s_hist[16 * 256];
  int y, x;
  if (!pixel_of(w, y0, rows, y, x)) return;
  const size_t band = (size_t)rows * (size_t)w;
  const int threads = blockDim.x * blockDim.y;
  SelectColFrames fr{{scratch + (size_t)(y - y0) * w + x, band, n},
                     s_hist + threadIdx.y * blockDim.x + threadIdx.x,
                     threads};
  const int count0 = load_column(fr, stack, dys, dxs, h, w, y + out_off,
                                 x, y + grow0, gh);
  clip_pixel(fr, count0, sigma_low, sigma_high, max_iter,
             (size_t)y * w + x, out, rejected);
}

#undef ABT_CLIP_PARAMS

}  // namespace

// K3 over output rows [y0, y0 + rows) of an [n, h, w] slab whose output
// is its rows [out_off, h - out_off) (a whole stack: out_off 0), output
// row r at global row grow0 + r of an image of gh rows (a whole stack:
// grow0 0, gh h), in the instance the wrapper's plan chose: cap > 0 the
// register instance of CAP = cap (a multiple of 4, n <= cap <= 32),
// blocks of 32 x 8; cap = 0 and scratch null the shared instance
// (33 <= n <= 128), blocks of 32 x by with 2n * 32 * by floats of shared
// memory; cap = 0 and scratch [n, rows, w] f32 the scratch instance
// (n > 128), blocks of 32 x 8.
// out f32 and rejected i32 [h - 2 out_off, w]. Returns cudaGetLastError()
// after the launch; a plan that does not hold n is refused
// (cudaErrorInvalidValue).
extern "C" int abt_shift_clip(const float* stack, const float* dys,
                              const float* dxs, int n, int h, int w,
                              float sigma_low, float sigma_high,
                              int max_iter, int cap, int by, int y0,
                              int rows, int out_off, int grow0, int gh,
                              float* scratch, float* out, int* rejected,
                              void* stream) {
  if (n < 1 || h < 1 || w < 1 || max_iter < 0 || y0 < 0 || rows < 1 ||
      out_off < 0 || y0 + rows > h - 2 * out_off || grow0 < 0 || gh < 1 ||
      by < 1 || 32 * by > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, by);
  const dim3 grid((w + block.x - 1) / block.x,
                  (rows + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ABT_CLIP_ARGS                                                      \
  stack, dys, dxs, n, h, w, sigma_low, sigma_high, max_iter, y0, rows,    \
      out_off, grow0, gh, out, rejected
  if (cap > 0) {
    if (cap % 4 != 0 || cap > kMaxRegFrames || n > cap || by != 8 ||
        scratch != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
#define ABT_REGS(CAP)                                                     \
  case CAP / 4:                                                           \
    shift_clip_kernel<CAP><<<grid, block, 0, s>>>(ABT_CLIP_ARGS);         \
    break
    switch (cap / 4) {
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
  } else if (scratch == nullptr) {
    const size_t smem = (size_t)2 * n * 32 * by * sizeof(float);
    if (n <= kMaxRegFrames || n > kMaxSharedFrames ||
        smem > (size_t)kMaxSharedBytes)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        shift_clip_shared_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    shift_clip_shared_kernel<<<grid, block, smem, s>>>(ABT_CLIP_ARGS);
  } else {
    if (n <= kMaxSharedFrames || by != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    shift_clip_scratch_kernel<<<grid, block, 0, s>>>(ABT_CLIP_ARGS, scratch);
  }
#undef ABT_CLIP_ARGS
  return static_cast<int>(cudaGetLastError());
}
