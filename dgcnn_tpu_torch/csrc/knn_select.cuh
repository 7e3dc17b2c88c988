// The kNN selection every neighbour-picking kernel of the port shares: the
// select_kernel of edge_conv_eval.cu, the knn_reduce kernels of
// knn_reduce.cu, knn_edge2.cu and knn_idx.cu.  The banded kernels hand
// row_scores a window of their sorted cloud as the cloud.
//
// A warp owns one query row i of a cloud and keeps the scores of its N
// columns in registers, NPL = N / 32 a lane (column j = 32 * t + lane in
// s[t]), so the N x N score matrix never leaves the SM.  A block holds
// QB query rows of one cloud and stages the cloud's graph features
// through shared memory CC channels at a time (Bucket below).  The scores
// follow the reference's operation order, (2 * <g_i, g_j> - |g_i|^2) -
// |g_j|^2, with the _rn intrinsics so that nvcc cannot contract them into
// an FMA; the k neighbours then come out one per round of a warp arg-max
// on (score, -index): torch.topk's order, lowest index first among ties.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace dg {

constexpr int MAX_N = 4096;  // scores per lane: N / 32 <= 128 registers

// The block shape of a register bucket of NPL scores a lane.  Up to 64
// (N <= 2048) a block runs QB = 16 warps, stages CC = 8 graph channels a
// pass and a lane reduces up to CPL = 8 output channels (Co <= 256).
// Above, a thread holds 96 or 128 scores: the block drops to 8 warps, so
// that __launch_bounds__(QB * 32) leaves a thread up to 255 registers, and
// a lane reduces up to 4 output channels (Co <= 128).  Such a block takes
// the whole register file, one block an SM; a pass stages 4 channels
// (81,920 B at N = 4096).  At 128 scores a lane ptxas still spills ~100
// bytes a thread, in the score loop and the rounds' lane-local arg-max.
// The staging width does not change the scores' bits: each score sums its
// channels in ascending order whatever CC is, and padded channels add
// exact zeros.
template <int NPL>
struct Bucket {
  static constexpr int QB = NPL <= 64 ? 16 : 8;   // query rows (warps)
  static constexpr int CC = NPL <= 64 ? 8 : 4;    // channels per pass
  static constexpr int CS = CC + 1;  // padded row stride: no bank conflicts
  static constexpr int CPL = NPL <= 64 ? 8 : 4;   // output channels a lane
};

// The widest Co that the bucket of N takes.
inline int max_co(int N) { return N / 32 <= 64 ? 256 : 128; }

// Dynamic shared memory of the graph stage of a select block for a cloud
// of N points.
template <int NPL>
__host__ __device__ inline size_t select_smem_bytes(int N) {
  return (size_t)N * Bucket<NPL>::CS * sizeof(float);
}

// One 4-byte asynchronous copy from global to shared memory (cp.async,
// sm_80 and later): *dst = *src, or 0 when `in` is false.  Nothing waits
// for it until cp.async.wait_all, and it holds no register.
__device__ __forceinline__ void async_copy4(float* dst, const float* src,
                                            bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// row_scores for the buckets above 64 scores a lane (one block an SM).
// The graph stage is copied with cp.async: a staging loop of plain loads
// keeps one load in flight a thread, and at one block an SM that took most
// of the kernel's time at Cg = 64 (PERF.md, Findings).  The squared norms
// ride in each row's padding slot (channel CC) of the last pass and each
// score is finished in that pass's loop: finished in a loop of its own over
// SQ in global memory, the compiler issues all NPL loads at once and holds
// them in as many registers, which spill at 128 scores a lane.  Each score
// takes the operations of row_scores below in the same order.
template <int NPL>
__device__ __forceinline__ void row_scores_async(
    const float* __restrict__ G, int Cg, const float* __restrict__ SQ, int N,
    int i, int lane, float* sg, float (&s)[NPL]) {
  constexpr int CC = Bucket<NPL>::CC, CS = Bucket<NPL>::CS;
  const int passes = (Cg + CC - 1) / CC;
#pragma unroll
  for (int t = 0; t < NPL; ++t) s[t] = 0.f;
  for (int p = 0; p < passes; ++p) {
    const int c0 = p * CC;
    const bool last = p == passes - 1;
    __syncthreads();  // every warp is done with the previous pass
    for (int e = threadIdx.x; e < N * CC; e += blockDim.x) {
      const int j = e / CC, c = e - j * CC;
      const bool in = c0 + c < Cg;
      async_copy4(sg + j * CS + c, in ? G + (size_t)j * Cg + c0 + c : G, in);
    }
    if (last)
      for (int j = threadIdx.x; j < N; j += blockDim.x)
        async_copy4(sg + j * CS + CC, SQ + j, true);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float q[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) q[c] = sg[i * CS + c];
    if (last) {
      const float qq = sg[i * CS + CC];
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int j = t * 32 + lane;
        if (j < N) {
          const float* r = sg + j * CS;
#pragma unroll
          for (int c = 0; c < CC; ++c) s[t] = fmaf(q[c], r[c], s[t]);
          s[t] = __fsub_rn(__fsub_rn(__fmul_rn(2.f, s[t]), qq), r[CC]);
        } else {
          s[t] = -INFINITY;
        }
      }
    } else {
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
  }
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
  if constexpr (NPL > 64) {
    row_scores_async<NPL>(G, Cg, SQ, N, i, lane, sg, s);
    return;
  }
  constexpr int CC = Bucket<NPL>::CC, CS = Bucket<NPL>::CS;
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
// bucket NPL (4, 8, 16, 32, 48, 64, 96 or 128) that holds N / 32 scores a
// lane.
template <typename F>
cudaError_t with_npl(int N, F&& f) {
  const int npl = N / 32;
  if (npl <= 4) return f(std::integral_constant<int, 4>{});
  if (npl <= 8) return f(std::integral_constant<int, 8>{});
  if (npl <= 16) return f(std::integral_constant<int, 16>{});
  if (npl <= 32) return f(std::integral_constant<int, 32>{});
  if (npl <= 48) return f(std::integral_constant<int, 48>{});
  if (npl <= 64) return f(std::integral_constant<int, 64>{});
  if (npl <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// Launches on `st`; each returns the launch error.  out[r] = |g_r|^2 for
// the rows of a (rows, C) matrix (edge_conv_eval.cu):
cudaError_t launch_sqnorm(const float* g, int rows, int C, float* out,
                          cudaStream_t st);
// out (M, ncols) = x (M, K) @ w (K, ncols) in f32 (project.cu).  Each
// output element's sum runs over K in one fixed order whatever M and
// ncols are, so two calls on the same rows give the same bits:
cudaError_t launch_project(const float* x, int M, int K, const float* w,
                           int ncols, float* out, cudaStream_t st);

}  // namespace dg
