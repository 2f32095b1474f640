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
// tile is read in any order.
//
// What bounds it on the H100: bytes — each pixel read once and written
// once (4096^2 f32: 134 MB, 0.040 ms at 3.35 TB/s). A 256^2 tile is 256
// KiB, more than one block's 227 KiB of shared memory, so a single block
// cannot hold it; sorting it in pieces and merging them through global
// memory (the chunked route below) costs barriers, serial merges and
// uncoalesced writes. The radix route reads and writes each byte once;
// what is left above the bound is each pass's ranking
// (__match_any_sync, 16 a thread), the scan over the warps and two
// cluster barriers a pass. nvcc 12.9 for sm_90a: 64 registers, no stack
// frame, no spills (the chunked route: 30).
//
// Design (tile_sort_kernel): one thread-block cluster per tile, the
// whole tile in the cluster's distributed shared memory, an LSD radix
// sort of the keys' bit patterns in 4 passes of 8 bits, the tile read
// once from the plane and written once. The tile plan
// (analysis/tile_sort_kernel.py:_tile_plan): 16 keys a thread, blocks of
// 256 or 512 threads, clusters of 1, 2, 4 or 8 blocks (all portable
// sizes), the smallest that holds the tile; a tile of at most 8192 keys
// (step <= 90) takes one block and no remote traffic, a 256^2 tile a
// cluster of 8 blocks of 8192 keys (two 32 KiB key buffers, a pass
// reading one and filling the other, and 16 KiB of per-warp digit
// counts each: 80 KiB, so two blocks share an SM and one works while
// the other waits at a cluster barrier; 1024-thread blocks of 16384
// keys, one an SM, took 0.83 against 0.77 ms at 4096^2). Slots past the
// tile hold +inf and sort last, so the first step*step ranks are the
// tile. The keys stay in shared memory, not registers: 16 keys held
// across the passes spilled at 64 registers a thread.
// The load pass reads the tile's rows from the plane (16 bytes a
// thread when the step and the plane allow it), maps invalid values to
// +inf, counts the valid ones (warp reduction, one shared atomic per
// warp) and stores the keys in the block's first buffer, key j of a
// lane at warp * 512 + 32 j + lane. Each pass then:
//   1. ranks every key among the keys of its warp with the same digit,
//      in (j, lane) order, by __match_any_sync, and counts the digits
//      per warp;
//   2. scans the counts over the warps (the block's digit counts);
//   3. cluster.sync(); every block reads the cluster's digit counts
//      through map_shared_rank and forms each digit's offset: digits in
//      order, then block rank, then warp, then the rank in the warp;
//   4. stores each key at that offset in whichever block's other
//      buffer holds it (a distributed shared memory store), then
//      cluster.sync(); the next pass reads that buffer in (warp, j,
//      lane) order, which is the order the ranks of step 1 follow:
//      every pass is stable, as LSD radix needs.
// After the fourth pass every block writes its part of the sorted
// buffer to the output, coalesced.
//
// Tiles of more than 8 x 8192 keys (step > 256; no path sends one:
// star_detection.py:_tile_size caps the step at 256) take the chunked
// route (tile_sort_chunked_kernel, its own entry point and launch
// count): one block per tile sorts chunks of 16384 keys by a bitonic
// network in shared memory and merges them pairwise through a global
// scratch by merge-path co-ranking.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kInfKey = 0x7f800000u;  // +inf
constexpr float kPadding = 1e-7f;          // constants.PADDING_THRESHOLD
constexpr int kKeys = 16;                  // keys per thread
constexpr int kDigits = 256;               // 8-bit digits
constexpr int kPasses = 4;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ uint32_t key_of(float v) {
  return (isfinite(v) && v > kPadding) ? __float_as_uint(v) : kInfKey;
}

__global__ void __launch_bounds__(kMaxThreads, 2)
tile_sort_kernel(const float* __restrict__ plane, int tx, int step,
                 int width, int vec, float* __restrict__ out,
                 int* __restrict__ counts) {
  extern __shared__ uint32_t s_dyn[];
  __shared__ uint32_t s_cta[kDigits];   // this block's digit counts
  __shared__ uint32_t s_base[kDigits];  // this block's start of each digit
  __shared__ uint32_t s_scan[kDigits / 32];
  __shared__ int s_valid;

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = nthr * kKeys;             // keys a block holds
  const int per_shift = __ffs(per) - 1;     // per is a power of two
  uint32_t* wcnt = s_dyn + 2 * per;         // [warps][kDigits]
  uint32_t* my_wcnt = wcnt + warp * kDigits;
  const int mine = warp * (32 * kKeys) + lane;  // key j at mine + 32 j
  const int tile = blockIdx.x / csize;
  const int ti = tile / tx;
  const int tj = tile - ti * tx;
  const int n = step * step;
  const float* base = plane + (size_t)ti * step * width + (size_t)tj * step;
  const int e0 = crank * per;               // first tile element here
  const uint32_t lt_mask = (1u << lane) - 1u;
  if (tid == 0) s_valid = 0;

  // ---- load: the tile's values as keys, +inf past the tile ----
  uint32_t* keys = s_dyn;                   // this pass's buffer [per]
  int my_valid = 0;
  if (vec) {  // step % 4 == 0 and a 16-byte aligned plane: float4 loads
#pragma unroll
    for (int q = 0; q < kKeys / 4; ++q) {
      const int e = e0 + (q * nthr + tid) * 4;
      float4 f = make_float4(NAN, NAN, NAN, NAN);
      if (e < n) {
        const int r = e / step;
        f = *reinterpret_cast<const float4*>(base + (size_t)r * width +
                                             (e - r * step));
      }
      const uint32_t k4[4] = {key_of(f.x), key_of(f.y), key_of(f.z),
                              key_of(f.w)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        keys[mine + 32 * (4 * q + c)] = k4[c];
        my_valid += k4[c] != kInfKey;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const int e = e0 + q * nthr + tid;
      uint32_t key = kInfKey;
      if (e < n) {
        const int r = e / step;
        key = key_of(base[(size_t)r * width + (e - r * step)]);
      }
      keys[mine + 32 * q] = key;
      my_valid += key != kInfKey;
    }
  }

  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = pass * 8;
    uint32_t* next = s_dyn + ((pass + 1) & 1) * per;  // the other buffer
    // 1. ranks among the warp's equal digits, (j, lane) order: the
    //    buffer's own order, so the pass is stable
    for (int d = lane; d < kDigits; d += 32) my_wcnt[d] = 0;
    __syncwarp();
    uint32_t rk[kKeys / 2];  // two 16-bit ranks a word (< 32 * kKeys)
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const uint32_t d = (keys[mine + 32 * j] >> shift) & (kDigits - 1);
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      const int leader = __ffs(peers) - 1;
      uint32_t prev = 0;
      if (lane == leader) prev = my_wcnt[d];
      prev = __shfl_sync(0xffffffffu, prev, leader);
      if (lane == leader) my_wcnt[d] = prev + __popc(peers);
      __syncwarp();
      const uint32_t r = prev + __popc(peers & lt_mask);
      if (j & 1)
        rk[j >> 1] |= r << 16;
      else
        rk[j >> 1] = r;
    }
    __syncthreads();
    if (pass == 0) {
      const int v = __reduce_add_sync(0xffffffffu, my_valid);
      if (lane == 0) atomicAdd(&s_valid, v);
    }
    // 2. exclusive scan of each digit's count over the warps
    if (tid < kDigits) {
      uint32_t run = 0;
      for (int w = 0; w < (nthr >> 5); ++w) {
        const uint32_t c = wcnt[w * kDigits + tid];
        wcnt[w * kDigits + tid] = run;
        run += c;
      }
      s_cta[tid] = run;
    }
    // 3. the cluster's counts → this block's start of each digit
    cluster.sync();
    if (pass == 0 && crank == 0 && tid == 0) {
      int total = 0;
      for (int c = 0; c < csize; ++c)
        total += *cluster.map_shared_rank(&s_valid, c);
      counts[tile] = total;
    }
    uint32_t tot = 0, pre = 0, incl = 0;
    if (tid < kDigits) {
      for (int c = 0; c < csize; ++c) {
        const uint32_t v = *cluster.map_shared_rank(&s_cta[tid], c);
        tot += v;
        if (c < crank) pre += v;
      }
      incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) s_scan[warp] = incl;
    }
    __syncthreads();
    if (tid < kDigits) {
      uint32_t carry = 0;
      for (int w = 0; w < warp; ++w) carry += s_scan[w];
      s_base[tid] = carry + incl - tot + pre;
    }
    __syncthreads();
    // 4. every key to its place in the cluster's other buffer
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const uint32_t key = keys[mine + 32 * j];
      const uint32_t d = (key >> shift) & (kDigits - 1);
      const uint32_t r = (rk[j >> 1] >> ((j & 1) * 16)) & 0xffffu;
      const uint32_t g = s_base[d] + my_wcnt[d] + r;
      uint32_t* dst = cluster.map_shared_rank(next, g >> per_shift);
      dst[g & (per - 1)] = key;
    }
    cluster.sync();
    keys = next;
  }

  // ---- the sorted ranks of this block, written once ----
  float* dst_out = out + (size_t)tile * n;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int p = j * nthr + tid;
    if (e0 + p < n) dst_out[e0 + p] = __uint_as_float(keys[p]);
  }
}

// ---- the chunked route, for tiles past the largest cluster ----

constexpr int kChunkThreads = 1024;

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

__global__ void __launch_bounds__(kChunkThreads)
tile_sort_chunked_kernel(const float* __restrict__ plane, int tx, int step,
                         int width, int chunk, int n_chunks,
                         uint32_t* __restrict__ scratch,
                         float* __restrict__ out, int* __restrict__ counts) {
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
    for (int i = threadIdx.x; i < chunk; i += blockDim.x)
      run_a[(size_t)c * chunk + i] = s[i];
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

// plane [ty*step, tx*step] f32 (width = tx*step); csize blocks of
// `threads` threads per tile, csize in {1, 2, 4, 8}, threads in {256,
// 512}, csize * threads * 16 >= step*step; out [ty*tx, step*step]
// f32, counts [ty*tx] i32. Returns cudaGetLastError() after the launch,
// or the launch's own error; a plan outside those bounds is refused.
extern "C" int abt_tile_sort(const float* plane, int ty, int tx, int step,
                             int csize, int threads, float* out,
                             int* counts, void* stream) {
  if (ty <= 0 || tx <= 0) return 0;
  const long long n = (long long)step * step;
  if ((csize != 1 && csize != 2 && csize != 4 && csize != kMaxCluster) ||
      (threads != 256 && threads != kMaxThreads) ||
      (long long)csize * threads * kKeys < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * (size_t)threads * kKeys * sizeof(uint32_t) +
                      (size_t)(threads / 32) * kDigits * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ty * tx * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec = step % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(plane) & 15u) == 0;
  err = cudaLaunchKernelEx(&cfg, tile_sort_kernel, plane, tx, step,
                           tx * step, vec, out, counts);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The chunked route. chunk = 16384 and n_chunks >= 2 a power of two
// with chunk * n_chunks >= step*step; scratch [ty*tx, 2, chunk*n_chunks] u32;
// out and counts as abt_tile_sort's. Returns cudaGetLastError() after
// the launch.
extern "C" int abt_tile_sort_chunked(const float* plane, int ty, int tx,
                                     int step, int chunk, int n_chunks,
                                     void* scratch, float* out, int* counts,
                                     void* stream) {
  if (ty <= 0 || tx <= 0) return 0;
  if (chunk != 16384 || n_chunks < 2 || (n_chunks & (n_chunks - 1)) ||
      (long long)chunk * n_chunks < (long long)step * step)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)chunk * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sort_chunked_kernel<<<ty * tx, kChunkThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      plane, tx, step, tx * step, chunk, n_chunks,
      static_cast<uint32_t*>(scratch), out, counts);
  return static_cast<int>(cudaGetLastError());
}
