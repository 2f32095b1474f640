// K12: the triangle-descriptor vote table of the affine aligner.
//
// Replaces the TPU kernel
//   astroburst_tpu/alignment/vote_kernel.py:vote_pallas
// (a bf16 match tile per (ref block, target block) contracted on the MXU
// against one-hot vertex matrices; its inputs arrive sorted by the first
// ratio and it skips every block pair whose ranges lie more than the
// tolerance apart).
//
// What it computes: votes[a, b], a, b < 64, is the number of (ref
// triangle i, target triangle j) pairs with |r_i0 - t_j0| <= tol and
// |r_i1 - t_j1| <= tol whose p-th vertices are stars a and b, summed over
// p = 0, 1, 2 (affine.rs:320-384). Padded or non-finite triangles match
// nothing (inf - x is inf, inf - inf and NaN - x are NaN, and both fail
// <=). A vertex outside [0, 64) casts no vote for its position, as an
// all-zero one-hot row would not. The plain torch version is
// alignment/vote_kernel.py:vote_plain (the one-hot contraction of
// affine.py:176-227 in f32); the counts are integers, so the two are
// equal.
//
// What bounds it on the H100, counted as the work the function needs:
// the larger of (a) the bytes of the inputs plus one read and one write
// of each list for the sort, under 2 MB at T = 34 304 (~0.0006 ms at
// 3.35 TB/s), and (b) 6 operations (two differences, two abs, two
// compares) for each pair inside the exact r0 window |r0 - t0| <= tol —
// 21.8e6 pairs for chip_smoke.py's 60 stars (1.9% of all pairs), ~0.002
// ms at 67 TFLOP/s. The count depends on the data; chip_smoke.py counts
// it for its inputs (vote_bound). Testing every pair, 1.17e9 at
// T = 34 220, would be ~0.1 ms: the all-pairs figure of the first port
// of this kernel, which did test every pair.
//
// Design, two launches from one C entry and no torch work around them. (1) A
// counting sort, 8 blocks of 1024 threads for each list: every block counts
// all the list's rows into 8192 buckets of 1/128 in r0 (floor(r0 * 128),
// exact, clipped to [0, 8192)), the rows with a non-finite ratio in a last
// bucket, with 8 rows in flight a thread, and scans the counts into bucket
// starts; block x then moves the rows of the buckets k with k % 8 == x to
// their bucket's next free slot, packed as one int4 (r0, r1 as f32 bits, the
// three vertex ids one byte each: one 16-byte store a row), so the scattered
// stores are shared over 8 SMs. (2) The vote: the bucket is monotone in r0,
// and a pair with |r0 - t0| <= tol in f32 lies within m = floor(128 tol (1 +
// 1e-6)) + 1 buckets (3 at tol = 0.02), so the block of 256 sorted refs b
// meets only the targets of the buckets [k_lo - m, k_hi + m] around its least
// and greatest ref bucket (38e6 pairs at chip_smoke.py's 60 stars, where the
// exact window holds 21.8e6). Every block of a persistent grid makes that
// plan itself from the bucket starts in its prologue, numbers the windows'
// pieces of 256 targets in order and takes its own run of them, so a long
// window in the dense band of r0 is shared out and no SM carries it alone.
// For each piece the block stages its targets in shared memory and every
// thread tests its own ref against each of them (all threads of a warp read
// the same target: a broadcast) with the exact predicate. Most warp steps
// hold no match or one; a match is buffered, by a ballot and one predicated
// store, as (ref ids, target slot), and the warp drains its buffer with all
// 32 lanes at once, adding 1 to three cells of a 64 x 64 int histogram in
// shared memory, which the block adds to the table once, at its end, with
// integer atomics (non-zero cells only). Integer counts make the table exact
// and independent of the order of the atomics and of the order inside a
// bucket. Where every r0 is equal the windows are the whole list and every
// pair is tested, as the all-pairs kernel did.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStars = 64;
constexpr int kThreads = 256;      // ref triangles per vote block
constexpr int kPiece = 256;        // targets staged per step of a window
static_assert(kPiece == kThreads, "a piece is staged one target a thread");
constexpr int kBuf = 128;          // buffered matches a warp
constexpr float kScale = 128.0f;   // r0 buckets per unit
constexpr int kBuckets = 8192;     // r0 in [0, 64); beyond, the edge buckets
constexpr int kSortThreads = 1024;
constexpr int kPer = (kBuckets + 1 + kSortThreads - 1) / kSortThreads;
constexpr int kUnroll = 8;         // rows a sort thread has in flight
constexpr int kSortSplit = 8;      // sort blocks a list: bucket k to k % 8
constexpr int kMaxBlocks = 256;    // ref blocks of the plan (t_ref <= 65536)

__device__ __forceinline__ unsigned vertex_id(int v) {
  return (v >= 0 && v < kStars) ? static_cast<unsigned>(v) : 0xffu;
}

// The three vertex ids of a row packed one byte each, 0xff for an id
// outside [0, 64).
__device__ __forceinline__ int pack_ids(int v0, int v1, int v2) {
  return static_cast<int>(vertex_id(v0) | (vertex_id(v1) << 8) |
                          (vertex_id(v2) << 16));
}

// The bucket of a live row's r0: floor(r0 * 128) (exact: a power of two)
// clipped to [0, kBuckets); monotone in r0.
__device__ __forceinline__ int r0_bucket(float r0) {
  return static_cast<int>(
      fminf(fmaxf(floorf(r0 * kScale), 0.0f), kBuckets - 1.0f));
}

// A row's bucket: r0_bucket of its r0, or kBuckets for a row with a
// non-finite ratio (it sorts last).
__device__ __forceinline__ int bucket(float2 r) {
  return isfinite(r.x) && isfinite(r.y) ? r0_bucket(r.x) : kBuckets;
}

// Blocks (x, 0) sort the ref list, blocks (x, 1) the target list, by
// counting: the rows packed as one int4 (r0, r1 as f32 bits, the packed
// ids, 0), grouped by r0 bucket in ascending order, the non-finite rows
// last (bucket kBuckets); starts[k] is the first row of bucket k,
// starts[kBuckets + 1] the list's length. Every block of a list counts
// all its rows and scans the counts; block x moves only the rows of the
// buckets k with k % kSortSplit == x, so the scattered stores, the
// costly part, are shared over kSortSplit SMs. The order inside a bucket
// follows the atomics; no count depends on it. Block (0, 1) also zeroes
// the vote table.
__global__ void __launch_bounds__(kSortThreads)
triangle_bucket_kernel(const float* __restrict__ ref_ratios,
                       const int* __restrict__ ref_verts, int t_ref,
                       const float* __restrict__ tgt_ratios,
                       const int* __restrict__ tgt_verts, int t_tgt,
                       int4* __restrict__ ref_rows, int4* __restrict__ tgt_rows,
                       int* __restrict__ ref_starts,
                       int* __restrict__ tgt_starts, int* __restrict__ votes) {
  __shared__ int count[kBuckets + 1];
  __shared__ int warp_sums[kSortThreads / 32];
  const bool is_ref = blockIdx.y == 0;
  const int part = blockIdx.x;
  const float* ratios = is_ref ? ref_ratios : tgt_ratios;
  const int* verts = is_ref ? ref_verts : tgt_verts;
  const int t = is_ref ? t_ref : t_tgt;
  int4* rows = is_ref ? ref_rows : tgt_rows;
  int* starts = is_ref ? ref_starts : tgt_starts;
  const int tid = threadIdx.x;
  if (!is_ref && part == 0)
    for (int q = tid; q < kStars * kStars; q += kSortThreads) votes[q] = 0;
  for (int q = tid; q <= kBuckets; q += kSortThreads) count[q] = 0;
  __syncthreads();
  for (int i0 = 0; i0 < t; i0 += kSortThreads * kUnroll) {
    float2 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the step at once
      const int i = i0 + u * kSortThreads + tid;
      r[u] = i < t ? reinterpret_cast<const float2*>(ratios)[i]
                   : make_float2(NAN, NAN);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * kSortThreads + tid < t) atomicAdd(&count[bucket(r[u])], 1);
  }
  __syncthreads();
  // exclusive scan of count: each thread a run of kPer buckets
  const int q0 = tid * kPer;
  int local = 0;
  for (int e = 0; e < kPer && q0 + e <= kBuckets; ++e) local += count[q0 + e];
  const int lane = tid & 31, warp = tid >> 5;
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_sums[lane];
    int w_incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += u;
    }
    warp_sums[lane] = w_incl - v;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - local;
  for (int e = 0; e < kPer && q0 + e <= kBuckets; ++e) {
    const int c = count[q0 + e];
    if (part == 0) starts[q0 + e] = run;
    count[q0 + e] = run;  // now the bucket's next free row
    run += c;
  }
  if (tid == 0 && part == 0) starts[kBuckets + 1] = t;
  __syncthreads();
  for (int i0 = 0; i0 < t; i0 += kSortThreads * kUnroll) {
    float2 r[kUnroll];
    int k[kUnroll];
    int v[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kSortThreads + tid;
      r[u] = i < t ? reinterpret_cast<const float2*>(ratios)[i]
                   : make_float2(NAN, NAN);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // this block's rows: their ids
      const int i = i0 + u * kSortThreads + tid;
      k[u] = bucket(r[u]);
      const bool mine = i < t && k[u] % kSortSplit == part;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[u][c] = mine ? verts[3 * i + c] : 0;
      if (!mine) k[u] = -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k[u] < 0) continue;
      const int slot = atomicAdd(&count[k[u]], 1);
      rows[slot] = make_int4(__float_as_int(r[u].x), __float_as_int(r[u].y),
                             pack_ids(v[u][0], v[u][1], v[u][2]), 0);
    }
  }
}

// A warp adds its n buffered matches to the histogram, a lane a match:
// entry = ref ids (bytes 1-3) | target slot in the staged piece (byte
// 0); position p votes for (ref id p, target id p) when both are < 64.
__device__ __forceinline__ void drain(const unsigned* buf, int n, int lane,
                                      const unsigned* s_tv, int* hist) {
  __syncwarp();
  for (int e = lane; e < n; e += 32) {
    const unsigned m = buf[e];
    const unsigned tv = s_tv[m & 0xffu];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const unsigned a = (m >> (8 + 8 * p)) & 0xffu;
      const unsigned b = (tv >> (8 * p)) & 0xffu;
      if (a < kStars && b < kStars) atomicAdd(&hist[a * kStars + b], 1);
    }
  }
  __syncwarp();
}

// The plan, made by every block in its prologue: ref block b (sorted
// refs b * kThreads onwards) meets the targets of the buckets
// [k_lo - m, k_hi + m] around its first and last live ref's buckets (the
// least and the greatest), cut into pieces of kPiece; the pieces of all
// ref blocks are numbered in order, and block x of the grid takes the
// run [total * x / grid, total * (x + 1) / grid).
__global__ void __launch_bounds__(kThreads)
triangle_vote_kernel(const int4* __restrict__ ref_rows, int t_ref,
                     const int4* __restrict__ tgt_rows,
                     const int* __restrict__ ref_starts,
                     const int* __restrict__ tgt_starts, float tol,
                     int* __restrict__ votes) {
  __shared__ int s_lo[kMaxBlocks];   // window of each ref block
  __shared__ int s_hi[kMaxBlocks];
  __shared__ int s_end[kMaxBlocks];  // running count of pieces
  __shared__ int s_carry;
  __shared__ int hist[kStars * kStars];
  __shared__ float2 s_t[kPiece];
  __shared__ unsigned s_tv[kPiece];
  __shared__ unsigned s_buf[kThreads / 32][kBuf];
  const int tid = threadIdx.x;
  unsigned* buf = s_buf[tid >> 5];
  const int lane = tid & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int n_live = ref_starts[kBuckets];  // the live refs come first
  const int nb = (t_ref + kThreads - 1) / kThreads;
  // |r0 - t0| <= tol holds in f32 only if the real difference is at
  // most tol (1 + 2^-23), so the buckets differ by at most m
  const int m = static_cast<int>(floorf(tol * kScale * 1.000001f)) + 1;
  if (tid == 0) s_carry = 0;
  for (int b0 = 0; b0 < nb; b0 += kThreads) {
    const int b = b0 + tid;
    int pieces = 0;
    if (b < nb && b * kThreads < n_live) {
      const int last = min(b * kThreads + kThreads, n_live) - 1;
      const int k_lo = r0_bucket(__int_as_float(ref_rows[b * kThreads].x));
      const int k_hi = r0_bucket(__int_as_float(ref_rows[last].x));
      const int lo = tgt_starts[max(k_lo - m, 0)];
      const int hi = tgt_starts[min(k_hi + m + 1, kBuckets)];
      s_lo[b] = lo;
      s_hi[b] = hi;
      pieces = (max(hi - lo, 0) + kPiece - 1) / kPiece;
    } else if (b < nb) {
      s_lo[b] = s_hi[b] = 0;
    }
    // inclusive scan of the pieces over this step's blocks
    const int warp = tid >> 5;
    int incl = pieces;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    __shared__ int warp_sums[kThreads / 32];
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = s_carry;
    for (int q = 0; q < warp; ++q) before += warp_sums[q];
    if (b < nb) s_end[b] = before + incl;
    __syncthreads();
    if (tid == kThreads - 1) s_carry = before + incl;
    __syncthreads();
  }
  const long long total = s_carry;
  const int p0 = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int p1 = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  if (p0 >= p1) return;  // the whole block
  for (int q = tid; q < kStars * kStars; q += kThreads) hist[q] = 0;

  // ref block of piece p0: the first b with s_end[b] > p0
  int b = 0;
  for (int e = nb - 1; b < e;) {
    const int mid = (b + e) >> 1;
    if (s_end[mid] > p0) e = mid; else b = mid + 1;
  }
  int loaded = -1;
  float r0 = INFINITY, r1 = INFINITY;
  unsigned a_ids = 0xffffff00u;  // the ref's three ids, bytes 1-3
  for (int p = p0; p < p1; ++p) {
    while (s_end[b] <= p) ++b;  // the same for the whole block
    if (b != loaded) {
      loaded = b;
      const int i = b * kThreads + tid;
      r0 = r1 = INFINITY;
      a_ids = 0xffffff00u;
      if (i < t_ref) {
        const int4 row = ref_rows[i];
        r0 = __int_as_float(row.x);
        r1 = __int_as_float(row.y);
        a_ids = static_cast<unsigned>(row.z) << 8;
      }
    }
    const int j0 = s_lo[b] + (p - (b ? s_end[b - 1] : 0)) * kPiece;
    const int cnt = min(kPiece, s_hi[b] - j0);
    __syncthreads();  // the previous piece is consumed (and hist zeroed)
    if (tid < cnt) {
      const int4 row = tgt_rows[j0 + tid];
      s_t[tid] = make_float2(__int_as_float(row.x), __int_as_float(row.y));
      s_tv[tid] = static_cast<unsigned>(row.z);
    }
    __syncthreads();
    // a match is buffered as (ref ids, target slot) by a ballot and one
    // predicated store; the warp drains its buffer with all 32 lanes
    int n_buf = 0;  // the same for the whole warp
    for (int q = 0; q < cnt; ++q) {
      const float2 tt = s_t[q];
      const bool hit = fabsf(r0 - tt.x) <= tol && fabsf(r1 - tt.y) <= tol;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot == 0u) continue;
      if (hit) buf[n_buf + __popc(ballot & lanes_below)] = a_ids | q;
      n_buf += __popc(ballot);
      if (n_buf > kBuf - 32) {
        drain(buf, n_buf, lane, s_tv, hist);
        n_buf = 0;
      }
    }
    drain(buf, n_buf, lane, s_tv, hist);
  }
  __syncthreads();
  for (int q = tid; q < kStars * kStars; q += kThreads) {
    const int c = hist[q];
    if (c) atomicAdd(&votes[q], c);
  }
}

}  // namespace

// ref_ratios [t_ref, 2] f32, ref_verts [t_ref, 3] i32, the same for the
// targets; scratch: 4 (t_ref + t_tgt) + 2 (8192 + 2) i32, 16-byte
// aligned (the sorted rows, one int4 each, and the bucket starts of both
// lists); votes [64, 64] i32, zeroed
// here; grid: the blocks that walk the pieces. t_ref <= 65536 (256 ref
// blocks in the plan). Two launches: the counting sort, then the vote.
// Returns cudaGetLastError() after them.
extern "C" int abt_triangle_vote(const float* ref_ratios, const int* ref_verts,
                                 int t_ref, const float* tgt_ratios,
                                 const int* tgt_verts, int t_tgt, float tol,
                                 int grid, int* scratch, int* votes,
                                 void* stream) {
  if (t_ref <= 0 || t_tgt <= 0) return 0;
  if (t_ref > kMaxBlocks * kThreads || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* ref_rows = reinterpret_cast<int4*>(scratch);
  int4* tgt_rows = ref_rows + t_ref;
  int* ref_starts = reinterpret_cast<int*>(tgt_rows + t_tgt);
  int* tgt_starts = ref_starts + kBuckets + 2;
  triangle_bucket_kernel<<<dim3(kSortSplit, 2), kSortThreads, 0, st>>>(
      ref_ratios, ref_verts, t_ref, tgt_ratios, tgt_verts, t_tgt, ref_rows,
      tgt_rows, ref_starts, tgt_starts, votes);
  triangle_vote_kernel<<<grid, kThreads, 0, st>>>(
      ref_rows, t_ref, tgt_rows, ref_starts, tgt_starts, tol, votes);
  return static_cast<int>(cudaGetLastError());
}
