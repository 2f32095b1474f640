// K2: one size_r x size_c crop per frame at per-frame origins.
//
// Replaces the TPU kernel
//   astroburst_tpu/ops/crop_kernel.py:gather_crops
// (one aligned HBM->VMEM DMA per frame for the phase-correlation refine
// crops, phase_correlation.py:400 and :488).
//
// What it computes: out[k, i, j] = stack[frame0 + k, y0 + i, x0 + j]
// with (y0, x0) = (y0s[k], x0s[k]) clamped into
// [0, h - size_r] x [0, w - size_c] (the TPU path's origins, from
// _refine_origin, are always in range; the clamp keeps every read
// inside the stack). The origins are int64, as _refine_origin makes
// them, and are read on the device: the host never waits for them and
// makes no cast.
//
// What bounds it on the H100: bytes. 15 crops of 512^2 f32 are 15.7 MB
// read and 15.7 MB written (~9.4 us at 3.35 TB/s); what a copy of that
// size needs is enough bytes in flight and few instructions per byte.
//
// Design: one warp per crop row, kWarps rows per block, blockIdx.y the
// crop; one thread of each block loads and clamps the crop's origins
// into shared memory. The warp writes the row in whole 16-byte pieces
// of the output (a head of 0..3 floats before the first 16-byte boundary
// and a ragged tail are scalar stores; with size_c % 4 == 0 and an
// aligned output there is neither), kUnroll pieces a lane with all their
// loads issued before the first store. The source row's alignment,
// (address / 4) mod 4, is uniform across the warp but changes from row
// to row: the bench frames are 2206 wide (a row stride of 8824 B, 8 mod
// 16) and the targets are stack[1:], whose base is 8 B off a 16-byte
// boundary as well. So each piece is read as the two aligned 16-byte
// chunks that hold it and realigned in registers (a warp-uniform
// switch), the second load mostly an L1 hit of the neighbouring lane's
// first. An aligned 16-byte chunk that holds one byte of the row lies
// in the row's page, so those reads never fault. Hopper's bulk copies
// do not apply: a TMA tensor map needs every global stride to be a
// multiple of 16 B, which 8824 B is not, and cp.async.bulk needs a
// 16-byte-aligned source.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float4 realign(float4 lo, float4 hi, int sh) {
  switch (sh) {
    case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    case 3: return make_float4(lo.w, hi.x, hi.y, hi.z);
    default: return lo;
  }
}

// Copy n floats from src to dst with the lanes of one warp.
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int n,
                                         int lane) {
  const int head = min((int)((4 - ((uintptr_t)dst >> 2)) & 3), n);
  const int body = (n - head) >> 2;          // whole 16-byte output pieces
  const int tail_at = head + 4 * body;
  const int tail = n - tail_at;              // 0..3
  const float* s = src + head;
  const int sh = (int)(((uintptr_t)s >> 2) & 3);   // warp-uniform
  const float4* sa = reinterpret_cast<const float4*>(s - sh);
  float4* d = reinterpret_cast<float4*>(dst + head);
  // the scalar head and tail: lanes 0..3 and 4..7
  const int e = lane < 4 ? lane : tail_at + lane - 4;
  const bool scalar = lane < 4 ? lane < head : lane < 4 + tail;
  const float x = scalar ? __ldg(src + e) : 0.0f;
  for (int q0 = 0; q0 < body; q0 += 32 * kUnroll) {
    float4 lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * 32 + lane;
      lo[u] = q < body ? __ldg(sa + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      hi[u] = q < body && sh ? __ldg(sa + q + 1) : lo[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * 32 + lane;
      if (q < body) d[q] = realign(lo[u], hi[u], sh);
    }
  }
  if (scalar) dst[e] = x;
}

__global__ void __launch_bounds__(kWarps * 32)
gather_crops_kernel(const float* __restrict__ stack,
                    const long long* __restrict__ y0s,
                    const long long* __restrict__ x0s, int h, int w,
                    int size_r, int size_c, int frame0,
                    float* __restrict__ out) {
  __shared__ long long s_origin;   // element offset of the crop's (0, 0)
  const int k = blockIdx.y;
  if (threadIdx.x == 0) {
    long long y0 = y0s[k];
    long long x0 = x0s[k];
    y0 = y0 < 0 ? 0 : (y0 > h - size_r ? h - size_r : y0);
    x0 = x0 < 0 ? 0 : (x0 > w - size_c ? w - size_c : x0);
    s_origin = ((long long)(frame0 + k) * h + y0) * w + x0;
  }
  __syncthreads();
  const float* src = stack + s_origin;
  float* dst = out + (size_t)k * size_r * size_c;
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < size_r;
       i += gridDim.x * kWarps)
    copy_row(src + (size_t)i * w, dst + (size_t)i * size_c, size_c, lane);
}

}  // namespace

// stack [N, h, w] f32; y0s, x0s [n_out] int64; out [n_out, size_r,
// size_c] f32. Returns cudaGetLastError() after the launch.
extern "C" int abt_gather_crops(const float* stack, const long long* y0s,
                                const long long* x0s, int n_out, int h, int w,
                                int size_r, int size_c, int frame0,
                                float* out, void* stream) {
  if (n_out <= 0 || n_out > 65535 || size_r < 1 || size_c < 1 ||
      size_r > h || size_c > w)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((size_r + kWarps - 1) / kWarps, n_out);
  gather_crops_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      stack, y0s, x0s, h, w, size_r, size_c, frame0, out);
  return static_cast<int>(cudaGetLastError());
}
