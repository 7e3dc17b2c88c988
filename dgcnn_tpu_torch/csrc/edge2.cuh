// The per-edge arithmetic of the two-conv EdgeConv block, shared by its
// three kernels: knn_edge2.cu (eval), edge2_reduce.cu (the training
// forward) and edge2_bwd.cu (its backward).
//
// For a centre i and a neighbour j, channel c1 of the first conv and c2 of
// the second:
//
//   z1[c1] = (a1[j, c1] + b1[i, c1]) * s1[c1] + t1[c1],  h1 = LReLU(z1)
//   z2[c2] = sum over c1 = 0, 1, ..., C1 - 1 of h1[c1] * w2[c1, c2]
//
// in that operation order (the reference's, pallas_knn.py:1008-1014).  z1
// uses the _rn intrinsics so that nvcc cannot contract it into an FMA, and
// z2 is one fmaf chain over c1 in ascending order from 0.  So the three
// kernels compute the same z2 bits for the same edge: the backward finds
// the forward's max/min ties by comparing its recomputed z2 with them, and
// a z2 that rounded otherwise would count no tie and divide by zero.
//
// A warp owns one centre row.  Lane l owns first-conv channels l + 32 u and
// second-conv channels l + 32 v; a warp-private row of shared memory holds
// the edge's h1 (all C1 channels) for the z2 dot products, and w2 sits in
// shared memory with a padded row stride, so that both w2[c1, lane] (the
// forward's reads) and w2[lane, c2] (the backward's) are free of bank
// conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dg {

constexpr int E2_MAXC = 128;           // C1, C2 <= 128
constexpr int E2_CPL = E2_MAXC / 32;   // channels per lane

// Row stride of w2 in shared memory.
__host__ __device__ __forceinline__ int e2_ldw(int C2) { return C2 + 1; }

// Copies w2 (C1, C2) into ws with row stride e2_ldw(C2).  Every thread of
// the block calls it; the caller synchronises the block before reading.
__device__ __forceinline__ void e2_stage_w2(const float* __restrict__ w2,
                                            int C1, int C2, float* ws) {
  const int ldw = e2_ldw(C2);
  for (int e = threadIdx.x; e < C1 * C2; e += blockDim.x) {
    const int r = e / C2, c = e - r * C2;
    ws[r * ldw + c] = w2[e];
  }
}

// v rounded to bf16 (to nearest even), as f32: the a1 rows and the da1
// addends of the AMP forms of the training kernels 7 and 8.
__device__ __forceinline__ float e2_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float e2_lrelu(float z, float slope) {
  return z >= 0.f ? z : __fmul_rn(slope, z);
}

__device__ __forceinline__ float e2_z1(float a, float b, float s, float t) {
  return __fadd_rn(__fmul_rn(__fadd_rn(a, b), s), t);
}

// z2[c2] of the edge whose h1 row is `hrow` (C1 values in shared memory).
__device__ __forceinline__ float e2_z2(const float* hrow,
                                       const float* ws, int C1, int ldw,
                                       int c2) {
  float acc = 0.f;
  for (int c1 = 0; c1 < C1; ++c1)
    acc = fmaf(hrow[c1], ws[c1 * ldw + c2], acc);
  return acc;
}

// The centre's per-lane first-conv constants: b1[i], s1, t1 for channels
// lane + 32 u (zero past C1).
struct E2Centre {
  float b[E2_CPL], s[E2_CPL], t[E2_CPL];
};

__device__ __forceinline__ E2Centre e2_centre(const float* __restrict__ b1row,
                                              const float* __restrict__ s1,
                                              const float* __restrict__ t1,
                                              int C1, int lane) {
  E2Centre ctr;
#pragma unroll
  for (int u = 0; u < E2_CPL; ++u) {
    const int c = lane + 32 * u;
    ctr.b[u] = c < C1 ? b1row[c] : 0.f;
    ctr.s[u] = c < C1 ? s1[c] : 0.f;
    ctr.t[u] = c < C1 ? t1[c] : 0.f;
  }
  return ctr;
}

// Writes the h1 row of the edge to neighbour row `arow` of a1 into the
// warp's shared row `hrow`.  The caller __syncwarp()s before reading it.
// ROUND: a1's values rounded to bf16 (the AMP forms of kernels 7 and 8).
template <bool ROUND = false>
__device__ __forceinline__ void e2_h1_row(const float* __restrict__ arow,
                                          const E2Centre& ctr, float slope,
                                          int C1, int lane, float* hrow) {
#pragma unroll
  for (int u = 0; u < E2_CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < C1) {
      const float a = ROUND ? e2_round_bf16(arow[c]) : arow[c];
      hrow[c] = e2_lrelu(e2_z1(a, ctr.b[u], ctr.s[u], ctr.t[u]), slope);
    }
  }
}

// e2_h1_row's operations on a1 values the lanes hold (channel lane + 32 u
// in a[u]): the mean row of a tied class of kernel 6's v3.
__device__ __forceinline__ void e2_h1_vals(const float (&a)[E2_CPL],
                                           const E2Centre& ctr, float slope,
                                           int C1, int lane, float* hrow) {
#pragma unroll
  for (int u = 0; u < E2_CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < C1)
      hrow[c] = e2_lrelu(e2_z1(a[u], ctr.b[u], ctr.s[u], ctr.t[u]), slope);
  }
}

}  // namespace dg
