// The tiled second conv of the two-conv EdgeConv block, shared by the
// tiled routes of its three kernels: knn_edge2.cu (eval, after the tiled
// selection), edge2_reduce.cu (the training forward) and edge2_bwd.cu (its
// backward).
//
// A tile is R = min(8, 128 / k) whole centre rows, R * k <= 128 edge slots
// (120 at k = 20 and 40); a block of 256 threads stages the tile's h1 in
// shared memory (edge2.cuh's operations, a row of 64 floats a slot) and
// computes z2 = h1 w2 as a register block: thread (tx, ty) = (tid % 16,
// tid / 16) takes edges ty + 16 m (m < 8) and channels c0 + i (i < 4),
// each element one fmaf chain over c1 = 0, 1, ..., C1 - 1 from +0.  That
// is e2_z2's order, so every route of the three kernels computes the same
// z2 bits for the same edge: the backward finds the forward's max/min ties
// by comparing its z2 with them.
#pragma once

#include <cuda_runtime.h>

#include "edge2.cuh"

namespace dg {

constexpr int E2T_THREADS = 256;  // threads a block
constexpr int E2T_EDGES = 128;    // edge slots a tile
constexpr int E2T_ROWS = 8;       // the most rows a tile
constexpr int E2T_C1 = 64;        // C1 <= 64: the row stride of h1

// The rows of a tile: R = min(E2T_ROWS, E2T_EDGES / k).
__host__ __device__ __forceinline__ int e2t_rows(int k) {
  return E2T_EDGES / k < E2T_ROWS ? E2T_EDGES / k : E2T_ROWS;
}

// The shapes the training kernels 7 and 8 take on their tiled routes:
// C1, C2 <= 64 and multiples of 4 (every model: C1 = C2 = 64), k <= 128.
inline bool e2t_train_route(int C1, int C2, int k) {
  return C1 <= E2T_C1 && C2 <= E2T_C1 && C1 % 4 == 0 && C2 % 4 == 0 &&
         k <= E2T_EDGES;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// h1 of every edge slot of the tile into hb (E2T_EDGES x E2T_C1): slot e
// takes row jrow[e] of A (-1: an empty slot, zeros; MEANS and below -1:
// the row already in its slot of hb, a class mean of kernel 6's v3) and the
// centre's row eloc[e] of b1rows (row stride ldb); channels C1.. hold
// zeros.  ROUND: A's values rounded to bf16 (the AMP forms of kernels 7 and
// 8).  Thread tid takes channel tid % 64 of slots tid / 64 + 4 m.  The
// caller synchronises the block before and after.
template <bool MEANS = false, bool ROUND = false>
__device__ __forceinline__ void e2t_stage_h1(
    const float* __restrict__ A, const float* b1rows, int ldb,
    const int* jrow, const int* eloc, const float* s1s, const float* t1s,
    int C1, float slope, float* hb) {
  const int cl = threadIdx.x & (E2T_C1 - 1), eb = threadIdx.x / E2T_C1;
  for (int e = eb; e < E2T_EDGES; e += E2T_THREADS / E2T_C1) {
    const int j = jrow[e];
    float h = 0.f;
    if ((j >= 0 || (MEANS && j < -1)) && cl < C1) {
      const float a = MEANS && j < -1 ? hb[e * E2T_C1 + cl]
                      : ROUND         ? e2_round_bf16(A[(size_t)j * C1 + cl])
                                      : A[(size_t)j * C1 + cl];
      h = e2_lrelu(e2_z1(a, b1rows[eloc[e] * ldb + cl], s1s[cl], t1s[cl]),
                   slope);
    }
    hb[e * E2T_C1 + cl] = h;
  }
}

// acc[m][i] = z2 of edge ty + 16 m, channel c0 + i: h1 in hb (row stride
// E2T_C1), w2 in w2s (row stride ldw, a multiple of 4), C1 a multiple of 4.
__device__ __forceinline__ void e2t_z2_block(const float* hb,
                                             const float* w2s, int ldw,
                                             int C1, int c0, int ty,
                                             float (&acc)[8][4]) {
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  for (int c1 = 0; c1 < C1; c1 += 4) {
    float4 w[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) w[cc] = ld4(w2s + (c1 + cc) * ldw + c0);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float4 h = ld4(hb + (ty + 16 * m) * E2T_C1 + c1);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float hv = comp(h, cc);
        acc[m][0] = fmaf(hv, w[cc].x, acc[m][0]);
        acc[m][1] = fmaf(hv, w[cc].y, acc[m][1]);
        acc[m][2] = fmaf(hv, w[cc].z, acc[m][2]);
        acc[m][3] = fmaf(hv, w[cc].w, acc[m][3]);
      }
    }
  }
}

}  // namespace dg
