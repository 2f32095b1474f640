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
// inside the stack). The origins are read on the device, so the
// host never waits for them.
//
// What bounds it on the H100: bytes. 15 crops of 512^2 f32 are 15.7 MB
// read and 15.7 MB written (~10 us at 3.35 TB/s); at that size launch
// latency is of the same order.
//
// Design: a plain copy. Blocks of 32 x 8 threads; a warp reads 32
// neighbouring floats of one crop row (coalesced) and writes them to the
// same row of the output. grid.z walks the crops. The TPU kernel needed
// (8, 128)-aligned origins for its DMA; this kernel takes any origin.

#include <cuda_runtime.h>

namespace {

__global__ void gather_crops_kernel(const float* __restrict__ stack,
                                    const int* __restrict__ y0s,
                                    const int* __restrict__ x0s, int h,
                                    int w, int size_r, int size_c,
                                    int frame0, float* __restrict__ out) {
  const int k = blockIdx.z;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size_r || j >= size_c) return;
  int y0 = y0s[k];
  int x0 = x0s[k];
  y0 = y0 < 0 ? 0 : (y0 > h - size_r ? h - size_r : y0);
  x0 = x0 < 0 ? 0 : (x0 > w - size_c ? w - size_c : x0);
  const size_t src = ((size_t)(frame0 + k) * h + (size_t)(y0 + i)) * w +
                     (size_t)(x0 + j);
  out[((size_t)k * size_r + i) * size_c + j] = stack[src];
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int abt_gather_crops(const float* stack, const int* y0s,
                                const int* x0s, int n_out, int h, int w,
                                int size_r, int size_c, int frame0,
                                float* out, void* stream) {
  if (n_out <= 0 || n_out > 65535 || size_r > h || size_c > w)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((size_c + block.x - 1) / block.x,
                  (size_r + block.y - 1) / block.y, n_out);
  gather_crops_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, y0s, x0s, h, w, size_r, size_c, frame0, out);
  return static_cast<int>(cudaGetLastError());
}
