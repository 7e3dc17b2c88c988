// The earlier form of csrc/edge2_reduce.cu (one warp a centre row, each
// z2 channel one dot product against w2 in shared memory), not built into
// the library: tools/reduce_ab.py --kernel edge2_fwd times it against the
// kernel and holds the two to each other (PERF.md, Findings).  The
// library keeps the same kernel as its row-warp route.
//
// edge2_reduce: the forward of the training two-conv EdgeConv block's
// neighbour reductions on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::_edge2_fwd_call
// (body _edge2_train_kernel), exact (f32) mode.  Given the neighbours
// idx (B, N, k) of the block's first conv (kernel knn_reduce) and
//
//   z2[i, t] = LReLU((a1[idx[i, t]] + b1[i]) * s1 + t1) @ w2   (edge2.cuh)
//
// it writes max, min, sum and sum of squares over t of z2 (per channel,
// t ascending, _rn intrinsics): the second BatchNorm's statistics and the
// max/min the block's output selects from.  s1/t1 are the first
// BatchNorm's folded affine of this batch.
//
// Bound on an H100 SXM: operations.  At the DGCNNSemSeg training shapes
// (B=32, N=4096, k=20, C1 = C2 = 64) the per-edge second conv is
// 2*B*N*k*C1*C2 ~ 21.5 GFLOP a block, ~0.32 ms at the f32 CUDA-core peak
// (67 TFLOP/s), against ~0.13 GB of idx, a1, b1 in and reductions out,
// ~0.04 ms at 3.35 TB/s.
//
// Design: one warp per centre row (QB = 16 rows a block), no selection.
// For each neighbour the lanes read its row of a1 (coalesced), write the
// h1 row into the warp's row of shared memory, then form their z2
// channels against w2 in shared memory.  Neither per-edge tensor reaches
// device memory.  edge2_bwd.cu recomputes z2 with the same code, so its
// tie tests see the bits this kernel reduced.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"

namespace {

using dg::E2_CPL;
using dg::E2_MAXC;

constexpr int QB = 16;  // rows (warps) per block

__global__ void __launch_bounds__(QB * 32)
    edge2_fwd_kernel(const int* __restrict__ idx,
                     const float* __restrict__ a1,
                     const float* __restrict__ b1, int C1,
                     const float* __restrict__ s1,
                     const float* __restrict__ t1,
                     const float* __restrict__ w2, int C2, float slope,
                     int rows, int N, int k, float* __restrict__ amax,
                     float* __restrict__ amin, float* __restrict__ asum,
                     float* __restrict__ asumsq) {
  extern __shared__ float smem[];
  float* ws = smem;                         // w2
  float* hb = ws + C1 * dg::e2_ldw(C2);     // QB h1 rows
  dg::e2_stage_w2(w2, C1, C2, ws);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * QB + warp;  // b * N + i
  if (row >= (size_t)rows) return;
  const float* A = a1 + (row / N) * N * C1;           // the cloud's a1
  const int* irow = idx + row * k;
  const dg::E2Centre ctr = dg::e2_centre(b1 + row * C1, s1, t1, C1, lane);
  float mx[E2_CPL], mn[E2_CPL], sm[E2_CPL], s2[E2_CPL];
#pragma unroll
  for (int v = 0; v < E2_CPL; ++v) {
    mx[v] = -INFINITY;
    mn[v] = INFINITY;
    sm[v] = 0.f;
    s2[v] = 0.f;
  }
  float* hrow = hb + warp * C1;
  const int ldw = dg::e2_ldw(C2);
  for (int t = 0; t < k; ++t) {
    dg::e2_h1_row(A + (size_t)irow[t] * C1, ctr, slope, C1, lane, hrow);
    __syncwarp();
#pragma unroll
    for (int v = 0; v < E2_CPL; ++v) {
      const int c = lane + 32 * v;
      if (c < C2) {
        const float z = dg::e2_z2(hrow, ws, C1, ldw, c);
        mx[v] = fmaxf(mx[v], z);
        mn[v] = fminf(mn[v], z);
        sm[v] = __fadd_rn(sm[v], z);
        s2[v] = __fadd_rn(s2[v], __fmul_rn(z, z));
      }
    }
    __syncwarp();  // before the next edge overwrites hrow
  }
#pragma unroll
  for (int v = 0; v < E2_CPL; ++v) {
    const int c = lane + 32 * v;
    if (c < C2) {
      const size_t o = row * C2 + c;
      amax[o] = mx[v];
      amin[o] = mn[v];
      asum[o] = sm[v];
      asumsq[o] = s2[v];
    }
  }
}

}  // namespace

// idx (B, N, k) int32; a1/b1 (B, N, C1), s1/t1 (C1,), w2 (C1, C2) f32; out
// amax/amin/asum/asumsq (B, N, C2) f32; all contiguous, on the device.
// Returns the first CUDA error.
extern "C" int dg_edge2_fwd(const int* idx, const float* a1, const float* b1,
                            const float* s1, const float* t1, const float* w2,
                            float* amax, float* amin, float* asum,
                            float* asumsq, int B, int N, int C1, int C2,
                            int k, float slope, void* stream) {
  if (B < 1 || N < 1 || C1 < 1 || C1 > E2_MAXC || C2 < 1 || C2 > E2_MAXC ||
      k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  const int rows = B * N;
  const size_t smem =
      sizeof(float) * ((size_t)C1 * dg::e2_ldw(C2) + (size_t)QB * C1);
  cudaError_t e = cudaFuncSetAttribute(
      edge2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  edge2_fwd_kernel<<<(rows + QB - 1) / QB, QB * 32, smem,
                     (cudaStream_t)stream>>>(idx, a1, b1, C1, s1, t1, w2, C2,
                                             slope, rows, N, k, amax, amin,
                                             asum, asumsq);
  return (int)cudaGetLastError();
}
