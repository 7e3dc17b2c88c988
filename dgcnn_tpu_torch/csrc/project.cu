// project: out (M, ncols) = x (M, K) @ w (K, ncols) in f32 on Hopper
// (sm_90a), the projection stage of kernels 1, 4 and 12 (edge_conv_eval.cu,
// knn_reduce.cu) and, on its own, xw_project (dg_project).
//
// Replaces the projection inside the TPU kernel dgcnn_tpu/ops/
// pallas_knn.py::fused_knn_reduce_xw (and the [W_nbr | W_ctr] products of
// fused_edge_conv_eval): the port projects the whole cloud once, before
// the selection, instead of each selected row.
//
// Bound on an H100 SXM: operations, except at very small K.  At the
// DGCNNCls training stage 4 (M = 32 * 1024, K = 128, ncols = 256) the
// product is 2.1 GFLOP, 0.032 ms at the f32 CUDA-core peak (67 TFLOP/s),
// against 50 MB of x, w and out, 0.015 ms at 3.35 TB/s.  At K = 3 (the
// first stage of every model) the 3 multiply-adds an output are nothing
// beside its 4-byte write: that launch is a copy bound by its bytes.
//
// Design, two kernels behind launch_project:
//   project_kernel  (K % 4 == 0, K >= 32, ncols % 4 == 0, x, w and out
//                   16-byte aligned): the core of gemm128.cuh (shared with
//                   conv_pool.cu): a block of 256 threads owns a 128 x
//                   128 tile of out, each thread an 8 x 8 register block,
//                   two blocks an SM; K in chunks of 32 copied by 16-byte
//                   cp.async into a second buffer while the first is used:
//                   one block barrier a chunk, 16 conflict-free 128-bit
//                   shared loads a thread feed 256 FMAs.  The blocks walk
//                   the column tiles first, so each row tile of x comes
//                   from device memory once.
//   project_small_kernel  any other shape (K = 3, K = 9, unaligned rows):
//                   a thread four consecutive outputs of a row (one where
//                   ncols % 4 != 0 or w or out is unaligned), x and w read
//                   through L1; the writes are coalesced.
// Both sum each output over k = 0, 1, ..., K - 1 by fmaf from 0, in that
// order (the tile's zero padding past K adds exact zeros), so the two
// kernels, any tiling and any M or ncols give the same bits for the same
// row: the contract of launch_project (knn_select.cuh).  f32 on the CUDA
// cores throughout: the exact mode rules out TF32.  Times against the
// bound are in PERF.md (chip_smoke.py, phases 7 and 11).
#include <cuda_runtime.h>

#include "gemm128.cuh"
#include "knn_select.cuh"

namespace {

constexpr int PTHREADS = dg::G128_THREADS;
constexpr int PM = dg::G128_M;
constexpr int PN = dg::G128_N;
constexpr int PK = dg::G128_K;
constexpr int PA = dg::G128_A;
constexpr int PB = dg::G128_B;
constexpr size_t PSMEM = dg::G128_SMEM;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// blockIdx.x walks the column tiles, so that the blocks in flight share
// their rows of x and read them from L2.
__global__ void __launch_bounds__(PTHREADS, 2)
    project_kernel(const float* __restrict__ x, int M, int K,
                   const float* __restrict__ w, int ncols,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float psm[];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * PN, m0 = blockIdx.y * PM;
  // acc[i][j]: row (i < 4 ? 4 ty + i : 64 + 4 ty + i - 4), column
  // (j < 4 ? 4 tx + j : 64 + 4 tx + j - 4)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int chunks = (K + PK - 1) / PK;
  dg::g128_load_chunk(psm, psm + 2 * PA, x, M, K, m0, w, ncols, n0, 0);
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk c has landed for every thread, and every thread is done with
    // chunk c - 1, whose buffer the next copy fills
    __syncthreads();
    if (c + 1 < chunks)
      dg::g128_load_chunk(psm + ((c + 1) & 1) * PA,
                          psm + 2 * PA + ((c + 1) & 1) * PB, x, M, K, m0, w,
                          ncols, n0, (c + 1) * PK);
    dg::g128_fma_chunk(acc, psm + (c & 1) * PA, psm + 2 * PA + (c & 1) * PB);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i & 3) + (i >> 2) * 64 + 4 * ty;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 64 * h + 4 * tx;
      if (gn < ncols)
        *reinterpret_cast<float4*>(out + (size_t)gm * ncols + gn) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// V outputs a thread, consecutive in a row: 4 (ncols % 4 == 0, w and out
// 16-byte aligned: float4 reads of w and stores of out) or 1.
template <int V>
__global__ void __launch_bounds__(PTHREADS)
    project_small_kernel(const float* __restrict__ x, int M, int K,
                         const float* __restrict__ w, int ncols,
                         float* __restrict__ out) {
  const long long e = ((long long)blockIdx.x * PTHREADS + threadIdx.x) * V;
  if (e >= (long long)M * ncols) return;
  const int m = (int)(e / ncols), n = (int)(e - (long long)m * ncols);
  const float* xr = x + (size_t)m * K;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const float xv = xr[kk];
    const float* wr = w + (size_t)kk * ncols + n;
    if constexpr (V == 4) {
      const float4 wv = ld4(wr);
      acc[0] = fmaf(xv, wv.x, acc[0]);
      acc[1] = fmaf(xv, wv.y, acc[1]);
      acc[2] = fmaf(xv, wv.z, acc[2]);
      acc[3] = fmaf(xv, wv.w, acc[3]);
    } else {
      acc[0] = fmaf(xv, wr[0], acc[0]);
    }
  }
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(out + e) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  else
    out[e] = acc[0];
}

bool aligned16(const void* p) { return (size_t)p % 16 == 0; }

}  // namespace

namespace dg {

cudaError_t launch_project(const float* x, int M, int K, const float* w,
                           int ncols, float* out, cudaStream_t st) {
  if (K % 4 == 0 && K >= PK && ncols % 4 == 0 && aligned16(x) &&
      aligned16(w) && aligned16(out)) {
    cudaError_t e = cudaFuncSetAttribute(
        project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)PSMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid((ncols + PN - 1) / PN, (M + PM - 1) / PM);
    project_kernel<<<grid, PTHREADS, PSMEM, st>>>(x, M, K, w, ncols, out);
  } else if (ncols % 4 == 0 && aligned16(w) && aligned16(out)) {
    const long long n = (long long)M * ncols / 4;
    project_small_kernel<4><<<(unsigned)((n + PTHREADS - 1) / PTHREADS),
                              PTHREADS, 0, st>>>(x, M, K, w, ncols, out);
  } else {
    const long long n = (long long)M * ncols;
    project_small_kernel<1><<<(unsigned)((n + PTHREADS - 1) / PTHREADS),
                              PTHREADS, 0, st>>>(x, M, K, w, ncols, out);
  }
  return cudaGetLastError();
}

}  // namespace dg
