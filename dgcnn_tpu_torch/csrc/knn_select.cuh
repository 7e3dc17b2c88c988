// The kNN selection every neighbour-picking kernel of the port shares: the
// select_kernel of edge_conv_eval.cu and the knn_reduce kernels of
// knn_reduce.cu.
//
// A warp owns one query row i of a cloud and keeps the scores of its N
// columns in registers, NPL = N / 32 a lane (column j = 32 * t + lane in
// s[t]), so the N x N score matrix never leaves the SM.  A block holds
// QB = 16 query rows of one cloud and stages the cloud's graph features
// through shared memory CC channels at a time.  The scores follow the
// reference's operation order, (2 * <g_i, g_j> - |g_i|^2) - |g_j|^2, with
// the _rn intrinsics so that nvcc cannot contract them into an FMA; the
// k neighbours then come out one per round of a warp arg-max on
// (score, -index): torch.topk's order, lowest index first among ties.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace dg {

constexpr int QB = 16;       // query rows (warps) per block
constexpr int CC = 8;        // graph channels staged per pass
constexpr int CS = CC + 1;   // padded shared-memory row stride (no bank conflicts)
constexpr int MAXCPL = 8;    // output channels per lane: Co <= 256
constexpr int MAX_N = 2048;  // scores per lane: N / 32 <= 64 registers

// Dynamic shared memory of a select block for a cloud of N points.
inline size_t select_smem_bytes(int N) {
  return (size_t)N * CS * sizeof(float);
}

// Scores of query row i against the N points of its cloud: G is the
// cloud's (N, Cg) graph features, SQ its (N,) squared norms, sg the
// block's dynamic shared memory.  Every thread of the block calls it
// (it synchronises the block).  Columns past N score -inf.
template <int NPL>
__device__ __forceinline__ void row_scores(const float* __restrict__ G, int Cg,
                                           const float* __restrict__ SQ, int N,
                                           int i, int lane, float* sg,
                                           float (&s)[NPL]) {
#pragma unroll
  for (int t = 0; t < NPL; ++t) s[t] = 0.f;
  for (int c0 = 0; c0 < Cg; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < N * CC; e += blockDim.x) {
      const int j = e / CC, c = e - j * CC;
      sg[j * CS + c] = (c0 + c < Cg) ? G[(size_t)j * Cg + c0 + c] : 0.f;
    }
    __syncthreads();
    float q[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) q[c] = sg[i * CS + c];
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const int j = t * 32 + lane;
      if (j < N) {
        const float* r = sg + j * CS;
#pragma unroll
        for (int c = 0; c < CC; ++c) s[t] = fmaf(q[c], r[c], s[t]);
      }
    }
  }
  const float qq = SQ[i];
#pragma unroll
  for (int t = 0; t < NPL; ++t) {
    const int j = t * 32 + lane;
    s[t] = (j < N) ? __fsub_rn(__fsub_rn(__fmul_rn(2.f, s[t]), qq), SQ[j])
                   : -INFINITY;
  }
}

// One round of the extraction: the column with the highest score, lowest
// index first among equal scores.  Every lane returns it; its score
// becomes -inf.
template <int NPL>
__device__ __forceinline__ int pop_nearest(float (&s)[NPL], int lane) {
  // lane-local best; t ascending, so the first maximum has the lowest index
  float best = s[0];
  int bj = lane;
#pragma unroll
  for (int t = 1; t < NPL; ++t) {
    if (s[t] > best) {
      best = s[t];
      bj = t * 32 + lane;
    }
  }
  // warp arg-max on (score, -index)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (ob > best || (ob == best && oj < bj)) {
      best = ob;
      bj = oj;
    }
  }
#pragma unroll
  for (int t = 0; t < NPL; ++t)
    if (t * 32 + lane == bj) s[t] = -INFINITY;
  return bj;
}

// Calls f(std::integral_constant<int, NPL>{}) for the smallest register
// bucket NPL (4, 8, 16, 32, 48 or 64) that holds N / 32 scores a lane.
template <typename F>
cudaError_t with_npl(int N, F&& f) {
  const int npl = N / 32;
  if (npl <= 4) return f(std::integral_constant<int, 4>{});
  if (npl <= 8) return f(std::integral_constant<int, 8>{});
  if (npl <= 16) return f(std::integral_constant<int, 16>{});
  if (npl <= 32) return f(std::integral_constant<int, 32>{});
  if (npl <= 48) return f(std::integral_constant<int, 48>{});
  return f(std::integral_constant<int, 64>{});
}

// Launches on `st`, defined in edge_conv_eval.cu; each returns the launch
// error.  out[r] = |g_r|^2 for the rows of a (rows, C) matrix:
cudaError_t launch_sqnorm(const float* g, int rows, int C, float* out,
                          cudaStream_t st);
// out (M, ncols) = x (M, K) @ w (K, ncols) in f32 with the tiled GEMM of
// tile_gemm.cuh.  Each output element's sum runs over K in one fixed order
// whatever M and ncols are, so two calls on the same rows give the same
// bits:
cudaError_t launch_project(const float* x, int M, int K, const float* w,
                           int ncols, float* out, cudaStream_t st);

}  // namespace dg
