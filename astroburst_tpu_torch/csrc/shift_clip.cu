// K3: fused Catmull-Rom shift + per-pixel sigma clip over a frame stack.
//
// Replaces the two TPU kernels
//   astroburst_tpu/stacking/onepass_kernel.py:_shift_clip_onepass_padded
//     (N <= 20, offsets clamped to +-16)
//   astroburst_tpu/stacking/fused_kernel.py:shift_clip_fused
//     (+ _preshift_integer; any N, offsets clamped to [-254, 253])
// with one kernel that takes any N up to MAX_FRAMES and any offset (no
// clamp, as ops/resample.py:shift_bicubic and AstroBurst).
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
//   std; asymmetric bounds; a pixel is active while cnt >= 2 and the
//   last pass removed something. The result is the mean of the
//   survivors, else the last finite centre, else 0. rejected[y, x] is
//   the number of finite values that did not survive.
//
// What bounds it on the H100: the stack is read once from HBM
// (16 x 5655 x 2206 f32 = 798 MB, ~0.24 ms at 3.35 TB/s), and each
// frame's 16 taps per pixel hit L1/L2 because neighbouring threads
// share rows. The per-pixel clip is arithmetic plus two insertion
// sorts of n values in local memory, so the kernel is bound by
// instructions and local-memory traffic, not by HBM bytes.
//
// Design: one thread per output pixel, blocks of 32 x 8 threads so a
// warp reads 32 neighbouring floats of a row (coalesced). The clip
// state (values, keep flags, sort buffer) lives in per-thread arrays
// sized by the template bound MAXN (32/64/128, picked from n by the
// entry point). A pixel leaves the clip loop at its own fixed point: a
// pass that removes nothing, or fewer than 2 values, leaves every later
// pass the identity, so the early exit is exact (the TPU kernel exits
// block-wide, clip_kernel.py:128-133). Nothing carries between blocks.
// wgmma/TMA/tuning are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMadToSigma = 1.4826f;

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

__device__ float shifted_value(const float* __restrict__ f, int h, int w,
                               int y, int x, float dy, float dx) {
  if (dy == 0.0f && dx == 0.0f) return f[(size_t)y * w + x];
  const float sy = (float)y + dy;
  const float sx = (float)x + dx;
  if (!(sy >= -0.5f && sy <= (float)h - 0.5f && sx >= -0.5f &&
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

__device__ __forceinline__ void insertion_sort(float* a, int m) {
  for (int i = 1; i < m; ++i) {
    const float v = a[i];
    int j = i - 1;
    while (j >= 0 && a[j] > v) {
      a[j + 1] = a[j];
      --j;
    }
    a[j + 1] = v;
  }
}

template <int MAXN>
__global__ void __launch_bounds__(256)
shift_clip_kernel(const float* __restrict__ stack,
                  const float* __restrict__ dys,
                  const float* __restrict__ dxs, int n, int h, int w,
                  float sigma_low, float sigma_high, int max_iter,
                  float* __restrict__ out, int* __restrict__ rejected) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;

  float v[MAXN];
  bool keep[MAXN];
  float buf[MAXN];
  const size_t plane = (size_t)h * (size_t)w;

  int count0 = 0;
  for (int k = 0; k < n; ++k) {
    const float val =
        shifted_value(stack + (size_t)k * plane, h, w, y, x, dys[k], dxs[k]);
    v[k] = val;
    keep[k] = isfinite(val);
    count0 += keep[k] ? 1 : 0;
  }

  int cnt = count0;
  bool stopped = false;
  bool have_center = false;
  float last_center = 0.0f;

  for (int it = 0; it < max_iter; ++it) {
    if (cnt < 2 || stopped) break;  // inactive now and in every later pass
    float center, sigma;
    if (it == 0) {
      int m = 0;
      for (int k = 0; k < n; ++k)
        if (keep[k]) buf[m++] = v[k];
      insertion_sort(buf, m);
      center = buf[cnt / 2];
      m = 0;
      for (int k = 0; k < n; ++k)
        if (keep[k]) buf[m++] = fabsf(v[k] - center);
      insertion_sort(buf, m);
      sigma = fmaxf(buf[cnt / 2] * kMadToSigma, 1e-10f);
    } else {
      const float cntf = (float)cnt;
      float s = 0.0f;
      for (int k = 0; k < n; ++k)
        if (keep[k]) s = s + v[k];
      center = s / cntf;
      float s2 = 0.0f;
      for (int k = 0; k < n; ++k)
        if (keep[k]) {
          const float d = v[k] - center;
          s2 = s2 + d * d;
        }
      sigma = fmaxf(sqrtf(s2 / fmaxf(cntf - 1.0f, 1.0f)), 1e-10f);
    }
    const float lo = -sigma_low * sigma;
    const float hi = sigma_high * sigma;
    int new_cnt = 0;
    for (int k = 0; k < n; ++k)
      if (keep[k]) {
        const float d = v[k] - center;
        keep[k] = (d >= lo) && (d <= hi);
        new_cnt += keep[k] ? 1 : 0;
      }
    last_center = center;
    have_center = true;
    stopped = (new_cnt == cnt);
    cnt = new_cnt;
  }

  float result;
  if (cnt > 0) {
    float s = 0.0f;
    for (int k = 0; k < n; ++k)
      if (keep[k]) s = s + v[k];
    result = s / (float)cnt;
  } else {
    result = (have_center && isfinite(last_center)) ? last_center : 0.0f;
  }
  const size_t o = (size_t)y * w + x;
  out[o] = result;
  rejected[o] = count0 - cnt;
}

}  // namespace

// Returns cudaGetLastError() after the launch; n > 128 is refused.
extern "C" int abt_shift_clip(const float* stack, const float* dys,
                              const float* dxs, int n, int h, int w,
                              float sigma_low, float sigma_high,
                              int max_iter, float* out, int* rejected,
                              void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32)
    shift_clip_kernel<32><<<grid, block, 0, s>>>(
        stack, dys, dxs, n, h, w, sigma_low, sigma_high, max_iter, out,
        rejected);
  else if (n <= 64)
    shift_clip_kernel<64><<<grid, block, 0, s>>>(
        stack, dys, dxs, n, h, w, sigma_low, sigma_high, max_iter, out,
        rejected);
  else if (n <= 128)
    shift_clip_kernel<128><<<grid, block, 0, s>>>(
        stack, dys, dxs, n, h, w, sigma_low, sigma_high, max_iter, out,
        rejected);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
