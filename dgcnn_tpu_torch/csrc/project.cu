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
//                   16-byte aligned): a block of 256 threads owns a 128 x
//                   128 tile of out, each thread an 8 x 8 register block
//                   (rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and
//                   64 + 4 tx + j), two blocks an SM.  K is walked in
//                   chunks of 32 that cp.async copies 16 bytes at a time
//                   into a second buffer while the first is used: one
//                   block barrier a chunk.  x stays row-major in shared
//                   memory (rows padded by 4 floats) and is read as float4
//                   along k, w as float4 along n: 16 128-bit shared loads a
//                   thread feed 256 FMAs, every warp's loads
//                   conflict-free.  The blocks walk the column tiles first,
//                   so each row tile of x comes from device memory once.
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

#include "knn_select.cuh"

namespace {

constexpr int PTHREADS = 256;
constexpr int PM = 128;         // rows of a block tile
constexpr int PN = 128;         // columns of a block tile
constexpr int PK = 32;          // k a chunk
constexpr int PAS = PK + 4;     // row stride of the x tile (floats)
constexpr int PA = PM * PAS;    // floats of an x buffer
constexpr int PB = PK * PN;     // floats of a w buffer
constexpr size_t PSMEM = sizeof(float) * 2 * (PA + PB);  // two buffers

// One 16-byte asynchronous copy, zero-filled when `in` is false.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Starts the copies of chunk k0 of the block's x rows (into a) and w
// columns (into b), 16 bytes a copy.
__device__ __forceinline__ void load_chunk(float* a, float* b,
                                           const float* __restrict__ x,
                                           int M, int K, int m0,
                                           const float* __restrict__ w,
                                           int ncols, int n0, int k0) {
#pragma unroll
  for (int e = threadIdx.x; e < PM * PK / 4; e += PTHREADS) {
    const int r = e / (PK / 4), c = (e % (PK / 4)) * 4;
    const bool in = m0 + r < M && k0 + c < K;
    copy16(a + r * PAS + c, in ? x + (size_t)(m0 + r) * K + k0 + c : x, in);
  }
#pragma unroll
  for (int e = threadIdx.x; e < PK * PN / 4; e += PTHREADS) {
    const int r = e / (PN / 4), c = (e % (PN / 4)) * 4;
    const bool in = k0 + r < K && n0 + c < ncols;
    copy16(b + r * PN + c, in ? w + (size_t)(k0 + r) * ncols + n0 + c : w,
           in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

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
  load_chunk(psm, psm + 2 * PA, x, M, K, m0, w, ncols, n0, 0);
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk c has landed for every thread, and every thread is done with
    // chunk c - 1, whose buffer the next copy fills
    __syncthreads();
    if (c + 1 < chunks)
      load_chunk(psm + ((c + 1) & 1) * PA, psm + 2 * PA + ((c + 1) & 1) * PB,
                 x, M, K, m0, w, ncols, n0, (c + 1) * PK);
    const float* as = psm + (c & 1) * PA + 4 * ty * PAS;
    const float* bs = psm + 2 * PA + (c & 1) * PB + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < PK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = ld4(as + ((i & 3) + (i >> 2) * 64) * PAS + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = ld4(bs + (k4 + kk) * PN);
        const float4 b1 = ld4(bs + (k4 + kk) * PN + 64);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0   ? a[i].x
                           : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z
                                     : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
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
