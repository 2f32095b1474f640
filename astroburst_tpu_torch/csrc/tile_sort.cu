// K10: per-tile ascending sort for the star-detection background.
//
// Replaces the TPU kernel
//   astroburst_tpu/analysis/tile_sort_kernel.py:sort_tiles_pallas
// (a VMEM bitonic network over one power-of-two tile per grid cell).
//
// What it computes: the NaN-padded plane [ty*step, tx*step] is cut into
// ty*tx tiles of step x step (row-major tile order); each tile's values
// are sorted ascending with the invalid ones (non-finite or <= 1e-7, the
// padding threshold) mapped to +inf, giving [ty*tx, step*step] f32, and
// the valid values of each tile are counted, [ty*tx] i32. The plain torch
// version is analysis/tile_sort_kernel.py:sort_tiles_plain (torch.sort of
// the masked tiles); the output is bit-equal to it: a valid value is a
// positive finite float, so its bit pattern orders as the float does and
// +inf (0x7f800000) tops them all, and sorting bit patterns moves values
// without touching them. Only the multiset of a tile matters, so the
// tile is read in any order and equal keys need no stable order.
//
// What bounds it on the H100: bytes, in principle — each pixel read once
// and written once (4096^2 f32: 134 MB, ~0.04 ms at 3.35 TB/s). In
// practice the sort's compare-exchange passes over shared memory and
// the block-wide barriers between them.
//
// Design: one block of 1024 threads per tile. A 256^2 tile is 256 KiB,
// more than the 227 KiB of shared memory a block may hold, so the tile
// is sorted in chunks of at most 16384 keys (64 KiB): each chunk is
// loaded into shared memory (padded with +inf to a power of two),
// bitonic-sorted there, and written to a global scratch; the sorted
// chunks are then merged pairwise in global memory (L2-resident: 256 KiB
// per tile) by merge-path co-ranking, each thread producing a contiguous
// run of the output, until one sorted run remains. A tile of at most
// 16384 values (step <= 128) is one chunk and goes straight to the
// output. Padding keys are +inf and sort last, so the first step*step
// keys of the padded run are the tile's sorted values. The valid count
// comes from the same load pass (warp reduction, one shared atomic per
// warp). Any step is accepted: the JAX code sent steps that are not
// powers of two to XLA's sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kInfKey = 0x7f800000u;  // +inf
constexpr float kPadding = 1e-7f;          // constants.PADDING_THRESHOLD

__device__ __forceinline__ uint32_t key_of(float v) {
  return (isfinite(v) && v > kPadding) ? __float_as_uint(v) : kInfKey;
}

// Ascending bitonic sort of s[0, n), n a power of two, by the whole block.
__device__ void bitonic_sort(uint32_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        const int l = i + j;
        const uint32_t a = s[i];
        const uint32_t b = s[l];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tile_sort_kernel(const float* __restrict__ plane, int tx, int step,
                 int width, int chunk, int n_chunks,
                 uint32_t* __restrict__ scratch, float* __restrict__ out,
                 int* __restrict__ counts) {
  extern __shared__ uint32_t s[];
  __shared__ int s_count;
  const int tile = blockIdx.x;
  const int ti = tile / tx;
  const int tj = tile - ti * tx;
  const int n = step * step;
  const int total = chunk * n_chunks;  // a power of two, >= n
  const float* base =
      plane + (size_t)ti * step * width + (size_t)tj * step;
  float* dst_out = out + (size_t)tile * n;
  uint32_t* run_a = scratch + (size_t)tile * 2 * total;
  uint32_t* run_b = run_a + total;
  if (threadIdx.x == 0) s_count = 0;

  int my_count = 0;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk has left shared memory
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int e = c * chunk + i;
      uint32_t key = kInfKey;
      if (e < n) {
        const int r = e / step;
        key = key_of(base[(size_t)r * width + (e - r * step)]);
        my_count += key != kInfKey;
      }
      s[i] = key;
    }
    __syncthreads();
    bitonic_sort(s, chunk);
    if (n_chunks == 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        dst_out[i] = __uint_as_float(s[i]);
    } else {
      for (int i = threadIdx.x; i < chunk; i += blockDim.x)
        run_a[(size_t)c * chunk + i] = s[i];
    }
  }

  my_count = __reduce_add_sync(0xffffffffu, my_count);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_count, my_count);

  // pairwise merges of sorted runs: run length `len` → 2 * len
  const uint32_t* src = run_a;
  uint32_t* dst = run_b;
  const int per = total / blockDim.x;  // outputs per thread
  for (int len = chunk; len < total; len *= 2) {
    __syncthreads();  // the previous level is written
    const bool last = 2 * len == total;
    const int start = threadIdx.x * per;
    const int pair = start / (2 * len);
    const int d = start - pair * 2 * len;  // output rank inside the pair
    const uint32_t* a = src + (size_t)pair * 2 * len;
    const uint32_t* b = a + len;
    // co-rank: how many of the first d outputs come from a (a first on
    // ties)
    int lo = d > len ? d - len : 0;
    int hi = d < len ? d : len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a[mid] <= b[d - 1 - mid])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo;
    int j = d - lo;
    const int o0 = pair * 2 * len + d;
    for (int t = 0; t < per; ++t) {
      uint32_t v;
      if (j >= len || (i < len && a[i] <= b[j]))
        v = a[i++];
      else
        v = b[j++];
      if (!last)
        dst[o0 + t] = v;
      else if (o0 + t < n)
        dst_out[o0 + t] = __uint_as_float(v);
    }
    const uint32_t* tmp = src;
    src = dst;
    dst = const_cast<uint32_t*>(tmp);
  }
  __syncthreads();
  if (threadIdx.x == 0) counts[tile] = s_count;
}

}  // namespace

// plane [ty*step, tx*step] f32 (width = tx*step); chunk a power of two
// <= 16384, n_chunks a power of two with chunk*n_chunks >= step*step and
// chunk == 16384 when n_chunks > 1; scratch [ty*tx, 2, chunk*n_chunks]
// u32 when n_chunks > 1 (else unused); out [ty*tx, step*step] f32,
// counts [ty*tx] i32. Returns cudaGetLastError() after the launch.
extern "C" int abt_tile_sort(const float* plane, int ty, int tx, int step,
                             int chunk, int n_chunks, void* scratch,
                             float* out, int* counts, void* stream) {
  if (ty <= 0 || tx <= 0) return 0;
  const size_t smem = (size_t)chunk * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sort_kernel<<<ty * tx, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      plane, tx, step, tx * step, chunk, n_chunks,
      static_cast<uint32_t*>(scratch), out, counts);
  return static_cast<int>(cudaGetLastError());
}
