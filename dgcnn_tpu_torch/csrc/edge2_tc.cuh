// The tensor-core tile of the two-conv block's training kernels 7 and 8 in
// their AMP forms: edge2_reduce_tc.cu (the forward) and edge2_bwd.cu's
// edge2_bwd_tc_kernel (the backward), on edge2_tile.cuh's tiles (R =
// min(8, 128 / k) whole centre rows, at most 128 edge slots; C1, C2 <= 64).
//
// z2 = h1 w2 runs on Hopper's tensor cores in three TF32 terms
// (mma_tf32.cuh: each f32 operand split into a TF32 hi and lo by
// round-to-nearest, lo*lo dropped, mma.sync m16n8k8).  The tensor core
// truncates its sums, so no chain is long: every k8 step (8 first-conv
// channels) takes its three MMAs (lo hi, hi lo, hi hi) into a zeroed
// partial, and the partials are added into the f32 sum step by step,
// rounded to nearest.  An MMA's output element depends on its row,
// its column and its accumulator alone, so z2 of an edge is a function of
// that edge's h1 row, w2 and C1, whatever the warp and the slot that
// compute it: both kernels call z2_tile() and get the same bits.
//
// Which edges hold a row's max and min follows the f32 fmaf chain (e2_z2's
// bits: one fmaf a first-conv channel, ascending from +0; the earlier
// tiled form's, and the plain f32 product's on the card).  The tile's z2
// differs from the chain's by a few ulps, and where two edges' z2 lie that
// close the two can pick different edges: the cotangent then lands on
// another edge, which moves ds1, dt1 and dW2 by about the plain version's
// rel 1e-5 gate a flip on the seg models' blocks (PERF.md).  Each sum lies
// within about 2^-18 of the sum of |h1 w2| from the exact product (the
// chain's 64 roundings; the tile's TF32 splits, dropped lo*lo and
// truncations), and that sum is at most ||h1 row|| ||w2 column||
// (Cauchy-Schwarz); bound() allows twice the two together.  So
// only edges whose tile z2 lies within twice the row's largest bound of
// the tile's max can hold the chain's max.  Where one edge alone does
// (nearly every output) it is the chain's max and no chain runs; where
// several do, the chain runs on them (chain_z2()) and the ties are those
// whose chain z2 equals the largest.  Likewise the min.  Kernel 7 writes
// the tile's max and min: the chain's max edge lies within twice the bound
// of the tile's max too, so kernel 8 finds it from there.
//
// Tiles in shared memory hold rows of 64 floats in mma_tf32.cuh's swizzled
// layout (at()): h1 (128 x 64, zeros past C1 and on empty slots) and w2
// (64 x 64, zeros past C1 rows and C2 columns).  A warp computes MI m16
// tiles of rows and 4 n8 tiles of columns of a 128 x 64 product
// (WarpTile): fragment (i, j) of its acc holds rows m0 + 16 i + {g, g + 8}
// and columns n0 + 8 j + {2t, 2t + 1} (g = lane / 4, t = lane % 4).
#pragma once

#include <cuda_runtime.h>

#include "edge2.cuh"
#include "edge2_tile.cuh"
#include "mma_tf32.cuh"

namespace dg_e2tc {

constexpr int EDGES = dg::E2T_EDGES;  // 128 edge slots a tile
constexpr int ROWS = dg::E2T_ROWS;    // at most 8 centre rows a tile
constexpr int C = dg::E2T_C1;         // 64: C1, C2 <= C, the row width
// the chain's z2 lies within TOL ||h1 row|| ||w2 column|| of the tile's:
// 2^-16 (the note)
constexpr float TOL = 1.52587890625e-5f;

// Offset of element (r, c) of a swizzled tile of C-float rows.
__device__ __forceinline__ int at(int r, int c) { return dg_mma::at<C>(r, c); }

// The k8 steps of a product over c channels (zeros past c).
__device__ __forceinline__ int ksteps(int c) { return (c + 7) >> 3; }

struct WarpTile {
  int m0, n0;
};

// This warp's block of a 128 x 64 product: 16 MI rows, 32 columns (MI =
// 2: eight warps; MI = 1: sixteen).
template <int MI>
__device__ __forceinline__ WarpTile warp_tile() {
  const int w = threadIdx.x >> 5;
  return {16 * MI * (w >> 1), 32 * (w & 1)};
}

// B[k][n] = M[n0 + n][k0 + k] (n0, k0 multiples of 8): M read along its
// rows (B = M^T).
template <int W>
__device__ __forceinline__ dg_mma::FragB load_b_rows(const float* M, int n0,
                                                     int k0) {
  const int g = dg_mma::lane_g(), t = dg_mma::lane_t(), f = dg_mma::swz(g);
  const float* r = M + (n0 + g) * W;
  dg_mma::FragB b;
  dg_mma::split(r[dg_mma::col(k0 + t, f)], b.hi[0], b.lo[0]);
  dg_mma::split(r[dg_mma::col(k0 + t + 4, f)], b.hi[1], b.lo[1]);
  return b;
}

// acc += a b in three terms through a zeroed partial: one k8 step of a
// product, its chain three MMAs long.
__device__ __forceinline__ void step3(float (&acc)[4],
                                      const dg_mma::FragA& a,
                                      const dg_mma::FragB& b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  dg_mma::mma3(p, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// B[k][n] = w2[k0 + k][n0 + n] from w2 split once into its TF32 hi and lo
// bits (w2h, w2l: swizzled as w2s; stage_w2_split): load_b_cols's values
// without the split.
template <int W>
__device__ __forceinline__ dg_mma::FragB load_b_split(const unsigned* w2h,
                                                      const unsigned* w2l,
                                                      int n0, int k0) {
  const int g = dg_mma::lane_g(), t = dg_mma::lane_t();
  const int o0 = (k0 + t) * W + dg_mma::col(n0 + g, dg_mma::swz(t));
  const int o1 = (k0 + t + 4) * W + dg_mma::col(n0 + g, dg_mma::swz(t + 4));
  dg_mma::FragB b;
  b.hi[0] = w2h[o0];
  b.lo[0] = w2l[o0];
  b.hi[1] = w2h[o1];
  b.lo[1] = w2l[o1];
  return b;
}

// z2 = h1 w2 on the warp's block: h1 in hb (EDGES x C, swizzled), C1 the
// first conv's channels; load_b(n0, k0) the B fragment of w2 (load_b_cols
// on the f32 w2s, or load_b_split: the same bits).  Each k8 step's three
// MMAs go into a zeroed partial, added into acc in f32 (step3).
template <int MI, class LoadB>
__device__ __forceinline__ void z2_tile(const float* hb, LoadB load_b,
                                        int C1, const WarpTile& wt,
                                        float (&acc)[MI][4][4]) {
  dg_mma::zero_tiles(acc);
  const int steps = ksteps(C1);
  for (int u = 0; u < steps; ++u) {
    dg_mma::FragA a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      a[i] = dg_mma::load_a_rows<C>(hb, wt.m0 + 16 * i, 8 * u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const dg_mma::FragB b = load_b(wt.n0 + 8 * j, 8 * u);
#pragma unroll
      for (int i = 0; i < MI; ++i) step3(acc[i][j], a[i], b);
    }
  }
}

// The warp's block of acc into the swizzled tile dst (float2 stores).
template <int MI>
__device__ __forceinline__ void store_tile(float* dst, const WarpTile& wt,
                                           const float (&acc)[MI][4][4]) {
  const int g = dg_mma::lane_g(), t = dg_mma::lane_t();
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wt.m0 + 16 * i + g, c = wt.n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dst + at(r, c)) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(dst + at(r + 8, c)) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// w2 (C1, C2) into the swizzled w2s, zeros past C1 rows and C2 columns,
// and the norm of each column into wn.  Every thread of the block calls
// it; the caller synchronises.
__device__ __forceinline__ void stage_w2(const float* __restrict__ w2,
                                         int C1, int C2, float* w2s,
                                         float* wn) {
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int r = e >> 6, c = e & (C - 1);
    w2s[at(r, c)] = r < C1 && c < C2 ? w2[r * C2 + c] : 0.f;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < C1 && c < C2; ++r)
      s = fmaf(w2[r * C2 + c], w2[r * C2 + c], s);
    wn[c] = sqrtf(s);
  }
}

// w2 (C1, C2) split into its TF32 hi and lo bits (mma_tf32.cuh's split),
// swizzled as stage_w2 places w2s, zeros past C1 rows and C2 columns.
__device__ __forceinline__ void stage_w2_split(const float* __restrict__ w2,
                                               int C1, int C2, unsigned* w2h,
                                               unsigned* w2l) {
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int r = e >> 6, c = e & (C - 1);
    dg_mma::split(r < C1 && c < C2 ? w2[r * C2 + c] : 0.f, w2h[at(r, c)],
                  w2l[at(r, c)]);
  }
}

// The norm of an edge's h1 row from the squares of the quads that 16
// neighbouring lanes hold (lane % 16 = the quad), in every one of them.
__device__ __forceinline__ float row_norm16(float4 h) {
  float s = h.x * h.x + h.y * h.y + h.z * h.z + h.w * h.w;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return sqrtf(s);
}

// How far the chain's z2 of an edge (h1 row norm hn) at a second-conv
// channel (w2 column norm wn) can lie from the tile's.
__device__ __forceinline__ float bound(float hn, float wn) {
  return TOL * hn * wn;
}

// z2 of edge e at channel c by the f32 fmaf chain (e2_z2's bits): h1 and
// w2 in the swizzled tiles hb and w2s.
__device__ __forceinline__ float chain_z2(const float* hb, int e,
                                          const float* w2s, int C1, int c) {
  float acc = 0.f;
#pragma unroll 4
  for (int c1 = 0; c1 < C1; c1 += 4) {
    const float4 h = dg::ld4(hb + at(e, c1));
    acc = fmaf(h.x, w2s[at(c1, c)], acc);
    acc = fmaf(h.y, w2s[at(c1 + 1, c)], acc);
    acc = fmaf(h.z, w2s[at(c1 + 2, c)], acc);
    acc = fmaf(h.w, w2s[at(c1 + 3, c)], acc);
  }
  return acc;
}

// h1 of first-conv channels c .. c + 3 of one edge from its a1 values
// (rounded to bf16 here: the AMP form's selected values), the centre's b1
// row and s1, t1: e2_h1_row<true>'s operations.
__device__ __forceinline__ float4 h1_quad(float4 a, const float* b1row,
                                          const float* s1s, const float* t1s,
                                          int c, float slope) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  float h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = dg::e2_lrelu(dg::e2_z1(dg::e2_round_bf16(av[i]), b1row[c + i],
                                  s1s[c + i], t1s[c + i]),
                        slope);
  return make_float4(h[0], h[1], h[2], h[3]);
}

}  // namespace dg_e2tc
