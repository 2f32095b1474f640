// K12: the triangle-descriptor vote table of the affine aligner.
//
// Replaces the TPU kernel
//   astroburst_tpu/alignment/vote_kernel.py:vote_pallas
// (a bf16 match tile per (ref block, target block) contracted on the MXU
// against one-hot vertex matrices).
//
// What it computes: votes[a, b], a, b < 64, is the number of (ref
// triangle i, target triangle j) pairs with |r_i0 - t_j0| <= tol and
// |r_i1 - t_j1| <= tol whose p-th vertices are stars a and b, summed over
// p = 0, 1, 2 (affine.rs:320-384). Ratios are [T, 2] f32, vertices [T, 3]
// i32; padded triangles carry +inf ratios and match nothing (inf - x is
// inf, inf - inf is NaN, and both fail <=). A vertex outside [0, 64)
// casts no vote for its position, as an all-zero one-hot row would not.
// The plain torch version is alignment/vote_kernel.py:vote_plain (the
// one-hot contraction of affine.py:176-227 in f32); the counts are
// integers, so the two are equal.
//
// What bounds it on the H100: operations — every (ref, target) pair is
// tested (1.2e9 pairs at T = 34 220 from 60 stars, ~6 operations each:
// ~0.1 ms at 67 TFLOP/s); the inputs are under 1 MB.
//
// Design: one thread per ref triangle, 256 per block; the target list is
// split over blockIdx.y and streamed through shared memory in tiles of
// 1024 (ratios as two f32 arrays, the three vertex ids packed into one
// word), every thread of a warp reading the same target at once (a
// broadcast). A match adds 1 to three cells of a 64 x 64 int histogram in
// shared memory; at the end each block adds its non-zero cells to the
// global table with integer atomics. Integer counts make the result exact
// and independent of the order of the atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStars = 64;
constexpr int kThreads = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ unsigned vertex_id(int v) {
  return (v >= 0 && v < kStars) ? static_cast<unsigned>(v) : 0xffu;
}

__global__ void __launch_bounds__(kThreads)
triangle_vote_kernel(const float* __restrict__ ref_ratios,
                     const int* __restrict__ ref_verts, int t_ref,
                     const float* __restrict__ tgt_ratios,
                     const int* __restrict__ tgt_verts, int t_tgt, float tol,
                     int* __restrict__ votes) {
  __shared__ int hist[kStars * kStars];
  __shared__ float s_t0[kTile];
  __shared__ float s_t1[kTile];
  __shared__ unsigned s_tv[kTile];
  for (int q = threadIdx.x; q < kStars * kStars; q += kThreads) hist[q] = 0;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  float r0 = INFINITY, r1 = INFINITY;
  unsigned a0 = 0xffu, a1 = 0xffu, a2 = 0xffu;
  if (i < t_ref) {
    r0 = ref_ratios[2 * i];
    r1 = ref_ratios[2 * i + 1];
    a0 = vertex_id(ref_verts[3 * i]);
    a1 = vertex_id(ref_verts[3 * i + 1]);
    a2 = vertex_id(ref_verts[3 * i + 2]);
  }
  const bool live = isfinite(r0) && isfinite(r1);

  const int per = (t_tgt + gridDim.y - 1) / gridDim.y;
  const int j0 = blockIdx.y * per;
  const int j1 = min(j0 + per, t_tgt);
  for (int jt = j0; jt < j1; jt += kTile) {
    const int cnt = min(kTile, j1 - jt);
    __syncthreads();  // the previous tile is consumed (and hist zeroed)
    for (int q = threadIdx.x; q < cnt; q += kThreads) {
      const int j = jt + q;
      s_t0[q] = tgt_ratios[2 * j];
      s_t1[q] = tgt_ratios[2 * j + 1];
      s_tv[q] = vertex_id(tgt_verts[3 * j]) |
                (vertex_id(tgt_verts[3 * j + 1]) << 8) |
                (vertex_id(tgt_verts[3 * j + 2]) << 16);
    }
    __syncthreads();
    if (!live) continue;
    for (int q = 0; q < cnt; ++q) {
      if (fabsf(r0 - s_t0[q]) <= tol && fabsf(r1 - s_t1[q]) <= tol) {
        const unsigned tv = s_tv[q];
        const unsigned b0 = tv & 0xffu;
        const unsigned b1 = (tv >> 8) & 0xffu;
        const unsigned b2 = (tv >> 16) & 0xffu;
        if (a0 < kStars && b0 < kStars) atomicAdd(&hist[a0 * kStars + b0], 1);
        if (a1 < kStars && b1 < kStars) atomicAdd(&hist[a1 * kStars + b1], 1);
        if (a2 < kStars && b2 < kStars) atomicAdd(&hist[a2 * kStars + b2], 1);
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kStars * kStars; q += kThreads) {
    const int c = hist[q];
    if (c) atomicAdd(&votes[q], c);
  }
}

}  // namespace

// ref_ratios [t_ref, 2] f32, ref_verts [t_ref, 3] i32, the same for the
// targets; votes [64, 64] i32, zeroed by the caller. split: the number
// of target ranges (blockIdx.y). Returns cudaGetLastError() after the
// launch.
extern "C" int abt_triangle_vote(const float* ref_ratios, const int* ref_verts,
                                 int t_ref, const float* tgt_ratios,
                                 const int* tgt_verts, int t_tgt, float tol,
                                 int split, int* votes, void* stream) {
  if (t_ref <= 0 || t_tgt <= 0) return 0;
  const dim3 grid((t_ref + kThreads - 1) / kThreads, split);
  triangle_vote_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ref_ratios, ref_verts, t_ref, tgt_ratios, tgt_verts, t_tgt, tol, votes);
  return static_cast<int>(cudaGetLastError());
}
