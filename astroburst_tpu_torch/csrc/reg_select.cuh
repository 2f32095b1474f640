// Order statistics of a small per-thread array held in registers, shared
// by K3 (shift_clip.cu: the median and MAD of a pixel's frames) and K7 /
// K9 (drizzle_finalize.cuh: RegLive, a pixel's capped push list).
//
// nvcc keeps an array in registers only if every subscript is a
// compile-time constant: every loop here has constant bounds and is
// unrolled, and a value at a runtime index is read by a tree of selects.
// A recursion of templates, or a loop bounded by another loop's
// variable, was left unrolled or uninlined and put the array on the
// stack (found in K9); bound such a loop by the array's size and test the
// other variable inside it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace abt_reg {

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// v[idx] of a register array, 0 <= idx < N, by a tree of selects on
// the bits of idx (depth log2 N, fewer than N selects).
template <int N>
__device__ __forceinline__ float reg_at(const float (&v)[N], int idx) {
  float w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = v[i];
  int len = N;  // w[0, len) still holds candidates
#pragma unroll
  for (int h = pow2_at_least(N) / 2; h > 0; h /= 2) {
    const bool bit = (idx & h) != 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < h && i + h < len) w[i] = bit ? w[i + h] : w[i];
    len = len < h ? len : h;
  }
  return w[0];
}

// Insert x into ascending v (slots past the values hold +inf): slot i
// becomes the median of v[i-1], v[i] and x, max(v[i-1], min(v[i], x)) —
// two min/max a slot, no compare or select. Slots at or past `upto`
// (a compile-time bound after unrolling where the caller knows that at
// most `upto` values are held, so they hold +inf and stay so) are left
// alone. Inserting +inf or NaN changes nothing. Equal values are
// bit-equal except +-0, which may swap places.
template <int N>
__device__ __forceinline__ void sorted_insert(float (&v)[N], float x,
                                              int upto = N) {
#pragma unroll
  for (int i = N - 1; i > 0; --i)
    if (i <= upto) v[i] = fmaxf(v[i - 1], fminf(v[i], x));
  v[0] = fminf(v[0], x);
}

// Sort a bitonic d (it falls, then rises: the deviations |v - c| of an
// ascending v, +inf past its values) by one bitonic merge: log2 P
// half-cleaner stages of min/max over P = pow2_at_least(N) slots,
// skipping the exchanges with the implicit +inf slots past N (they
// change nothing). When N < P, only the lower half is merged after the
// first stage: it then holds the P/2 smallest values, sorted, which
// serves any rank < P/2 (so any rank <= N/2).
template <int N>
__device__ __forceinline__ void bitonic_merge(float (&d)[N]) {
  constexpr int P = pow2_at_least(N);
  constexpr int KEEP = N < P ? P / 2 : P;
#pragma unroll
  for (int j = P / 2; j > 0; j /= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i & j) == 0 && i + j < N && (j == P / 2 || i + j < KEEP)) {
        const float a = d[i];
        const float b = d[i + j];
        d[i] = fminf(a, b);
        d[i + j] = fmaxf(a, b);
      }
    }
  }
}

}  // namespace abt_reg
