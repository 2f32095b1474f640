// Exact order statistics of one large f32 tensor by radix histograms.
//
// Replaces no TPU kernel. The JAX package takes the IFU cube's global
// statistics by its compare-count quantile; the port took them exactly
// by sorting the cube a 16 M chunk at a time and bisecting over the
// keys (ops/select.py: global_stats_plain, 2 x 32 sorts of 16 M values
// with their int64 indices, 2 x 32 rounds of searchsorted). This kernel
// gives the same values, bit for bit, without sorting.
//
// What it computes (ops/select.py: global_stats): over the n values of
// x, valid = finite and non-zero; count = the valid values; for the
// 0-based ranks ks[0..2] (rank_indices' median, 1% and 99.9% ranks,
// computed by torch between the two entry points, from the count on the
// device) the rank-k valid value; then, with med the first of them, the
// rank-ks[0] value of |v - med| over the valid v (the MAD). A rank at or
// past the count gives +inf; a zero is returned as +0.0. The output is
// f64 [5]: count, med, mad, low, high.
//
// The order is that of the 32-bit key u of each value: its bits with
// the sign bit set for a positive value, all bits flipped for a
// negative one (ops/select.py's key plus 2^31), so unsigned u orders
// as the floats do and -0.0 sits just below +0.0. A rank's key is found
// digit by digit, most significant first: 11, 11 and 10 bits.
//   pass 0: count the valid values; histogram of u >> 21 (2048 bins);
//   choose: per rank, the bin holding it and the rank left inside it;
//   pass 1: the values whose u >> 21 is a rank's bin, histogram of the
//           next 11 bits, one histogram a rank (up to 3 at once);
//   choose; pass 2: u >> 10 matched, the last 10 bits; choose: the key.
// Then the same three passes over |v - med| (med read from device
// memory, the subtraction in f32 as the plain version's) for one rank.
//
// What bounds it on the H100: the bytes. Each pass reads the cube once:
// 6 reads of 2.15 GB for a 2048 x 512^2 cube, 3.85 ms at 3.35 TB/s (the
// work itself needs the 2 reads of the plain version, 1.28 ms: the
// values, then the deviations from their median). A pass does ~10-30
// integer operations a value (the key, the digit, compares, a run's
// count), within the ~37 a value that the card issues in the time its
// bytes take. The choose steps read 16-48 KB.
// There is no sorted copy and no 2 GiB buffer: the workspace is 131 KB.
//
// Design: a persistent grid (the occupancy's blocks on every SM, fewer
// for a small tensor) walks the tensor in 16-byte loads, a warp over 32
// consecutive float4s; the elements before the first 16-byte boundary
// and after the last whole float4 take two extra slots, so any view
// (a frame of a cube with an odd plane) is read in place. Contention:
// the top 11 bits are the sign, the exponent and 2 mantissa bits, so a
// continuum piles most values into a few bins. Each thread keeps, for
// each of its histograms, a run of equal digits in registers and adds
// the run to the block's histogram in shared memory with one atomic
// when the digit changes and once at the end: in pass 0 a thread's
// neighbouring values mostly share their top digit (every value equal:
// one atomic a thread), and passes 1 and 2 count only the values under
// a rank's prefix, whose next digits spread over 2048 or 1024 bins, so
// their atomics rarely meet. The block adds its non-zero bins to the
// global histogram (u64) once. Measured on one H100 at 700 W: at the IFU
// cell's 2048 x 512^2 cube 5.4-5.6 ms a call against 9.4-9.5 ms with
// warp aggregation by __match_any_sync (whose pass 1, a warp's digits
// mostly distinct, took 2.2-2.5 ms); 5.8-5.9 against 7.9 ms with every
// value equal; 8.3 against 6.5 ms at the worst case for runs, 1 and 2
// alternating (every value ends a run, a warp's lanes on two bins).
// A choose step is one block, a warp a rank: each lane sums a run of
// bins, a shuffle scan finds the lane whose run holds the rank, and
// that lane walks its run. 12 launches a call (6 passes, 6 choices),
// one fill of the workspace before them, and torch's rank_indices
// between pass 0 and the rest. Nothing goes to the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr unsigned kNone = 0xffffffffu;   // a rank at or past the count

// workspace, u64 words (ops/select.py: WORKSPACE_WORDS)
constexpr int kCount = 0;     // valid values
constexpr int kKrem = 1;      // per rank slot: the rank left in its prefix
constexpr int kPrefix = 5;    // per rank slot: the digits chosen so far
constexpr int kValue = 9;     // per rank slot: the f32 bits of its value
constexpr int kHist = 16;     // the six histograms, in launch order
constexpr int kHistV0 = kHist;                // values, pass 0: 2048
constexpr int kHistV1 = kHistV0 + 2048;       // pass 1: 3 x 2048
constexpr int kHistV2 = kHistV1 + 3 * 2048;   // pass 2: 3 x 1024
constexpr int kHistM0 = kHistV2 + 3 * 1024;   // deviations: 2048
constexpr int kHistM1 = kHistM0 + 2048;       // 2048
constexpr int kHistM2 = kHistM1 + 2048;       // 1024
static_assert(kHistM2 + 1024 == 16 + 16384, "workspace layout");
// rank slots: 0, 1, 2 the values' (median, 1%, 99.9%), 3 the MAD's

template <int S> struct Digit;      // pass S's prefix and digit of key u
template <> struct Digit<0> {
  static constexpr int kBins = 2048;
  __device__ static unsigned of(unsigned u) { return u >> 21; }
};
template <> struct Digit<1> {
  static constexpr int kBins = 2048;
  __device__ static unsigned prefix(unsigned u) { return u >> 21; }
  __device__ static unsigned of(unsigned u) { return (u >> 10) & 2047u; }
};
template <> struct Digit<2> {
  static constexpr int kBins = 1024;
  __device__ static unsigned prefix(unsigned u) { return u >> 10; }
  __device__ static unsigned of(unsigned u) { return u & 1023u; }
};

__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned u) {
  if (u == kNone) return INFINITY;
  const float f =
      __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
  return f == 0.0f ? 0.0f : f;
}

// A thread's run of equal digits of histogram h: the value's digit d
// extends it, or the run is added to h with one atomic and d starts
// the next.
__device__ __forceinline__ void bump(unsigned* h, unsigned& run_d,
                                     unsigned& run_n, unsigned d) {
  if (d != run_d) {
    if (run_n) atomicAdd(h + run_d, run_n);
    run_d = d;
    run_n = 0;
  }
  ++run_n;
}

// One pass over x: pass S of the values (kDev false) or of |v - med|.
// Slot i < nv is the float4 body[i]; slot nv the `head` elements before
// body, slot nv + 1 the `tail` after it.
template <int S, bool kDev>
__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const float* __restrict__ x, int head,
                  const float4* __restrict__ body, long long nv, int tail,
                  u64* __restrict__ ws, u64* __restrict__ hist, int first,
                  int nranks) {
  constexpr int kBins = Digit<S>::kBins;
  constexpr int kHists = S == 0 ? 1 : 3;
  __shared__ unsigned sh[kHists * kBins];
  __shared__ u64 s_count;
  for (int i = threadIdx.x; i < kHists * kBins; i += kThreads) sh[i] = 0;
  if (threadIdx.x == 0) s_count = 0;
  unsigned pre[3] = {kNone, kNone, kNone};
  if constexpr (S > 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      if (r < nranks) pre[r] = static_cast<unsigned>(ws[kPrefix + first + r]);
  }
  const float med = kDev ? __uint_as_float(static_cast<unsigned>(ws[kValue]))
                         : 0.0f;
  __syncthreads();

  const long long slots = nv + 2;
  const long long stride = (long long)gridDim.x * kThreads;
  unsigned my_count = 0;
  unsigned run_d[kHists], run_n[kHists];   // the thread's open runs
#pragma unroll
  for (int r = 0; r < kHists; ++r) run_d[r] = run_n[r] = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < slots; i += stride) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int have = 0;                           // bit j: v[j] is an element
    if (i < nv) {
      const float4 q = body[i];
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      have = 15;
    } else if (i <= nv + 1) {
      const float* t = i == nv ? x : reinterpret_cast<const float*>(body + nv);
      const int m = i == nv ? head : tail;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j < m) v[j] = t[j];
      have = (1 << m) - 1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = v[j];
      const bool ok = ((have >> j) & 1) && isfinite(s) && s != 0.0f;
      const unsigned u = key_of(kDev ? fabsf(s - med) : s);
      if constexpr (S == 0) {
        if (!kDev) my_count += ok;
        if (ok) bump(sh, run_d[0], run_n[0], Digit<0>::of(u));
      } else {
#pragma unroll
        for (int r = 0; r < 3; ++r)        // pre[r] of no rank never matches
          if (ok && Digit<S>::prefix(u) == pre[r])
            bump(sh + r * kBins, run_d[r], run_n[r], Digit<S>::of(u));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kHists; ++r)
    if (run_n[r]) atomicAdd(sh + r * kBins + run_d[r], run_n[r]);
  if (S == 0 && !kDev) {
    const unsigned c = __reduce_add_sync(kFull, my_count);
    if ((threadIdx.x & 31) == 0 && c)
      atomicAdd(&s_count, static_cast<u64>(c));
  }
  __syncthreads();
  const int bins = S == 0 ? kBins : nranks * kBins;
  for (int b = threadIdx.x; b < bins; b += kThreads)
    if (sh[b]) atomicAdd(hist + b, static_cast<u64>(sh[b]));
  if (S == 0 && !kDev && threadIdx.x == 0 && s_count)
    atomicAdd(ws + kCount, s_count);
}

// One block, a warp a rank slot first + w (w < nranks): the bin of
// pass S's histogram that holds the rank, appended to its prefix, and
// the rank left inside that bin; after pass 2 the value. Pass 0 starts
// each rank from ks[w] over the one shared histogram. With `out`, the
// result row of the call.
template <int S>
__global__ void radix_choose_kernel(u64* __restrict__ ws,
                                    const u64* __restrict__ hist, int first,
                                    int nranks,
                                    const long long* __restrict__ ks,
                                    double* __restrict__ out) {
  constexpr int kBins = Digit<S>::kBins;
  constexpr int kBits = S == 2 ? 10 : 11;
  constexpr int kPer = kBins / 32;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (w < nranks) {
    const int r = first + w;
    u64 k = S == 0 ? static_cast<u64>(ks[w]) : ws[kKrem + r];
    unsigned pre = S == 0 ? 0u : static_cast<unsigned>(ws[kPrefix + r]);
    if (S == 0 || pre != kNone) {
      const u64* h = hist + (S == 0 ? 0 : w * kBins) + lane * kPer;
      u64 s = 0;
#pragma unroll 8
      for (int j = 0; j < kPer; ++j) s += h[j];
      u64 incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const u64 t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const u64 excl = incl - s;
      const unsigned owner = __ballot_sync(kFull, excl <= k && k < incl);
      if (owner == 0) {
        pre = kNone;                 // k at or past the count
      } else {
        const int ol = __ffs(owner) - 1;
        unsigned bin = 0;
        u64 rem = 0;
        if (lane == ol) {
          u64 c = excl;
          for (int j = 0; j < kPer; ++j) {
            const u64 hj = h[j];
            if (k < c + hj) {
              bin = lane * kPer + j;
              rem = k - c;
              break;
            }
            c += hj;
          }
        }
        bin = __shfl_sync(kFull, bin, ol);
        rem = __shfl_sync(kFull, rem, ol);
        pre = S == 0 ? bin : (pre << kBits) | bin;
        k = rem;
      }
    }
    if (lane == 0) {
      ws[kKrem + r] = k;
      ws[kPrefix + r] = pre;
      if (S == 2) ws[kValue + r] = __float_as_uint(value_of(pre));
    }
  }
  if (out != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const auto val = [&](int r) {
        return static_cast<double>(
            __uint_as_float(static_cast<unsigned>(ws[kValue + r])));
      };
      out[0] = static_cast<double>(ws[kCount]);
      out[1] = val(0);
      out[2] = val(3);
      out[3] = val(1);
      out[4] = val(2);
    }
  }
}

struct Span {          // x cut at its 16-byte boundaries
  const float* x;
  int head;
  const float4* body;
  long long nv;
  int tail;
};

Span span_of(const float* x, long long n) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15u) / 4);
  const int head = static_cast<int>(mis ? (4 - mis < n ? 4 - mis : n) : 0);
  const long long rest = n - head;
  return {x, head, reinterpret_cast<const float4*>(x + head), rest / 4,
          static_cast<int>(rest % 4)};
}

template <int S, bool kDev>
cudaError_t pass(const Span& sp, u64* ws, int hist, int first, int nranks,
                 cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, radix_pass_kernel<S, kDev>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = (sp.nv + 2 + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < most ? need : most);
  radix_pass_kernel<S, kDev><<<grid, kThreads, 0, stream>>>(
      sp.x, sp.head, sp.body, sp.nv, sp.tail, ws, ws + hist, first, nranks);
  return cudaGetLastError();
}

template <int S>
cudaError_t choose(u64* ws, int hist, int first, int nranks,
                   const long long* ks, double* out, cudaStream_t stream) {
  radix_choose_kernel<S><<<1, 128, 0, stream>>>(ws, ws + hist, first, nranks,
                                                 ks, out);
  return cudaGetLastError();
}

}  // namespace

// Pass 0 of the values: the valid count into ws[0], the top digits'
// histogram. ws: the zeroed workspace of 16 + 16384 u64 words.
extern "C" int abt_radix_count(const float* x, long long n, void* ws,
                               void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pass<0, false>(span_of(x, n), static_cast<u64*>(ws),
                                         kHistV0, 0, 0,
                                         static_cast<cudaStream_t>(stream)));
}

// The rest, after abt_radix_count on the same x and ws, with ks the
// three int64 ranks: 11 launches, the result row in out (f64 [5]).
extern "C" int abt_radix_select(const float* x, long long n,
                                const long long* ks, void* ws, double* out,
                                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Span sp = span_of(x, n);
  u64* w = static_cast<u64*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = choose<0>(w, kHistV0, 0, 3, ks, nullptr, st);
  if (err == cudaSuccess) err = pass<1, false>(sp, w, kHistV1, 0, 3, st);
  if (err == cudaSuccess) err = choose<1>(w, kHistV1, 0, 3, ks, nullptr, st);
  if (err == cudaSuccess) err = pass<2, false>(sp, w, kHistV2, 0, 3, st);
  if (err == cudaSuccess) err = choose<2>(w, kHistV2, 0, 3, ks, nullptr, st);
  if (err == cudaSuccess) err = pass<0, true>(sp, w, kHistM0, 3, 1, st);
  if (err == cudaSuccess) err = choose<0>(w, kHistM0, 3, 1, ks, nullptr, st);
  if (err == cudaSuccess) err = pass<1, true>(sp, w, kHistM1, 3, 1, st);
  if (err == cudaSuccess) err = choose<1>(w, kHistM1, 3, 1, ks, nullptr, st);
  if (err == cudaSuccess) err = pass<2, true>(sp, w, kHistM2, 3, 1, st);
  if (err == cudaSuccess) err = choose<2>(w, kHistM2, 3, 1, ks, out, st);
  return static_cast<int>(err);
}
