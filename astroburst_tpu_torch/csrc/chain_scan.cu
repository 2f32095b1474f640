// chain_scan: the two sequential scans of the fused alignment chain.
//
// Replaces no TPU kernel. The JAX package runs these scans as lax.scan
// steps inside its one-program alignment chain
//   astroburst_tpu/alignment/fused_chain.py:_dedupe_topk (:71)
//   astroburst_tpu/alignment/fused_chain.py:_greedy_match (:178)
// In plain torch each step is several launches (~1000 a chain at 10-25 us
// of host time each), more than the chain's device time, so each scan is
// one block here, launched once. The plain torch versions are
// alignment/fused_chain.py:dedupe_topk_plain and greedy_match_plain; the
// CUDA kernels are bit-equal to them.
//
// abt_dedupe_topk: brightest-first greedy 3 px dedupe of the packed
// detection candidates (star_detection.rs:215). packed is the [10, k] f32
// record of analysis/star_detection.py:_detect (rows cy, cx, flux, valid
// at 0, 1, 2, 8). One block of kScan threads: (1) the candidates are
// ranked by the key (valid ? -flux : +inf), ties by index — a stable
// ascending sort, NaN last as torch.sort puts it — by counting, and the
// kScan first go to shared memory in that order; (2) step i tests
// candidate i against every accepted slot (thread t holds slot t) and
// folds the clashes with __syncthreads_or, thread i keeps its accept flag;
// an invalid candidate's step is skipped (uniformly: every thread reads
// its flag); (3) a block prefix over the accept flags (ballots) writes the
// first kKeep accepted x and y in order, +inf in empty slots, and
// min(accepted, kKeep). The squared distance is __fmul_rn/__fadd_rn, the
// plain version's separately rounded dy*dy + dx*dx (a contraction to FMA
// would change which pairs sit below 9 at the edge).
//
// abt_greedy_match: greedy one-to-one pairs by descending votes
// (affine.rs:320-384) over the [64, 64] i32 vote table. One block of
// kMatchThreads threads, kPer cells each in registers (one row segment a
// thread); each of at most 64 steps takes the block's maximum with the
// lowest flat index among ties (a reduction in registers, warp shuffles,
// then the warps' results in shared memory, double-buffered so one
// barrier a step is enough), stops when it is below min_votes, and sets
// the winner's row and column to -1.
//
// What bounds them on the H100: latency, not bytes or operations. The
// dedupe reads 4 rows of k floats (16 KB at k = 1024) and does ~k^2
// compares for the ranks and ~256^2 distances for the scan (~1.5e6
// operations, ~0.00002 ms at 67 TFLOP/s); the match reads 16 KB. Both
// are a chain of block barriers (up to 256 and 64), each a few hundred
// nanoseconds, so each takes microseconds, against the milliseconds of
// the plain loops' launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kScan = 256;          // candidates walked (fused_chain.SCAN_CAP)
constexpr int kKeep = 60;           // stars kept (fused_chain.N_TRI_STARS)
static_assert(kKeep <= kScan, "a kept star is a scanned slot");
constexpr int kStars = 64;          // rows and columns of the vote table
constexpr int kMatchThreads = 256;
constexpr int kPer = kStars * kStars / kMatchThreads;   // 16 cells a thread
static_assert(kStars % kPer == 0, "a thread's cells lie in one row");
constexpr int kWarps = kMatchThreads / 32;

// torch.sort's ascending order: NaN after every number, NaNs equal
__device__ __forceinline__ bool key_less(float a, float b) {
  return a < b || (!isnan(a) && isnan(b));
}

__device__ __forceinline__ bool key_equal(float a, float b) {
  return a == b || (isnan(a) && isnan(b));
}

__global__ void __launch_bounds__(kScan) dedupe_topk_kernel(
    const float* __restrict__ packed, int k, float* __restrict__ out_xy,
    int* __restrict__ out_n) {
  extern __shared__ float keys[];   // k sort keys
  __shared__ float sy[kScan];
  __shared__ float sx[kScan];
  __shared__ int sv[kScan];
  __shared__ int warp_count[kScan / 32];
  const int t = threadIdx.x;
  const size_t kk = static_cast<size_t>(k);
  const float* cys = packed;
  const float* cxs = packed + kk;
  const float* flux = packed + 2 * kk;
  const float* valid = packed + 8 * kk;

  for (int c = t; c < k; c += kScan) {
    keys[c] = valid[c] > 0.5f ? -flux[c] : INFINITY;
  }
  sy[t] = 0.0f;
  sx[t] = 0.0f;
  sv[t] = 0;
  __syncthreads();

  const int n = min(k, kScan);
  for (int c = t; c < k; c += kScan) {
    const float kc = keys[c];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const float kj = keys[j];
      rank += (key_less(kj, kc) || (j < c && key_equal(kj, kc))) ? 1 : 0;
    }
    if (rank < n) {
      sy[rank] = cys[c];
      sx[rank] = cxs[c];
      sv[rank] = valid[c] > 0.5f ? 1 : 0;
    }
  }
  __syncthreads();

  const float y = sy[t];
  const float x = sx[t];
  const bool v = sv[t] != 0;
  bool acc = false;
  for (int i = 0; i < n; ++i) {
    if (!sv[i]) continue;   // never accepted; the same on every thread
    const float dy = __fsub_rn(y, sy[i]);
    const float dx = __fsub_rn(x, sx[i]);
    const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
    const int clash = __syncthreads_or(acc && d2 < 9.0f);
    if (t == i) acc = v && !clash;
  }

  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, acc);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kScan / 32; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  const int rank = before + __popc(ballot & ((1u << lane) - 1u));
  if (acc && rank < kKeep) {
    out_xy[rank] = x;
    out_xy[kKeep + rank] = y;
  }
  if (t >= total && t < kKeep) {
    out_xy[t] = INFINITY;
    out_xy[kKeep + t] = INFINITY;
  }
  if (t == 0) *out_n = min(total, kKeep);
}

// (value, flat index) a beats (value, flat index) b: more votes, or as
// many at a lower index
__device__ __forceinline__ bool beats(int av, int ai, int bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(kMatchThreads) greedy_match_kernel(
    const int* __restrict__ votes, int min_votes, int* __restrict__ ris,
    int* __restrict__ tis, int* __restrict__ count) {
  __shared__ int wv[2][kWarps];
  __shared__ int wi[2][kWarps];
  __shared__ int s_ri[kStars];
  __shared__ int s_ti[kStars];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int base = t * kPer;
  const int row = base / kStars;
  const int col0 = base % kStars;
  int v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = votes[base + j];
  if (t < kStars) {
    s_ri[t] = 0;
    s_ti[t] = 0;
  }
  int cnt = 0;
  for (int step = 0; step < kStars; ++step) {
    int best = v[0];
    int bi = base;
#pragma unroll
    for (int j = 1; j < kPer; ++j) {
      if (v[j] > best) {
        best = v[j];
        bi = base + j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (beats(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    const int buf = step & 1;
    if (lane == 0) {
      wv[buf][warp] = best;
      wi[buf][warp] = bi;
    }
    __syncthreads();
    best = wv[buf][0];
    bi = wi[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (beats(wv[buf][w], wi[buf][w], best, bi)) {
        best = wv[buf][w];
        bi = wi[buf][w];
      }
    }
    if (best < min_votes) break;   // the same on every thread
    const int ri = bi / kStars;
    const int ti = bi % kStars;
    if (t == 0) {
      s_ri[cnt] = ri;
      s_ti[cnt] = ti;
    }
    ++cnt;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (row == ri || col0 + j == ti) v[j] = -1;
    }
  }
  __syncthreads();
  if (t < kStars) {
    ris[t] = s_ri[t];
    tis[t] = s_ti[t];
  }
  if (t == 0) *count = cnt;
}

}  // namespace

extern "C" int abt_dedupe_topk(const float* packed, int k, float* out_xy,
                               int* out_n, void* stream) {
  dedupe_topk_kernel<<<1, kScan, static_cast<size_t>(k) * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(packed, k, out_xy,
                                                            out_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int abt_greedy_match(const int* votes, int min_votes, int* ris,
                                int* tis, int* count, void* stream) {
  greedy_match_kernel<<<1, kMatchThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      votes, min_votes, ris, tis, count);
  return static_cast<int>(cudaGetLastError());
}
