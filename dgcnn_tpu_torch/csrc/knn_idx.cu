// knn_idx: the idx-only kNN graph on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::knn_pallas (body
// _knn_only_kernel), the drop-in for ops/knn.py::knn, in its exact (v1,
// f32) mode:
//
//   idx[i, t] = the t-th of the k highest 2<x_i,x_j> - |x_i|^2 - |x_j|^2,
//               self included, lowest index first among equal scores
//
// Bound on an H100 SXM: operations.  At the DGCNNPartSeg training shape
// (TransformNet's graph: B=32, N=2048, C=3, k=40) the scores are 2*B*N^2*C
// flops plus one comparison a score, ~0.94 G operations, ~0.014 ms at the
// f32 CUDA-core peak (67 TFLOP/s), against 0.8 MB of x in and 10.5 MB of
// idx out, ~0.003 ms at 3.35 TB/s.  The k rounds of arg-max over N
// scores a row are the real cost of this selection (k * N comparisons a
// row, ~5.4 G at that shape).
//
// Design: edge_conv_eval.cu's select_kernel without the reduction.  sqnorm
// first, then the selection of knn_select.cuh: one warp a query row with
// its N scores in registers (N / 32 a lane: the 64 bucket at N=2048), the
// cloud staged through shared memory, and k rounds of warp arg-max on
// (score, -index); lane 0 writes each round's winner.  The N x N scores
// never reach device memory.
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

template <int NPL>
__global__ void __launch_bounds__(dg::Bucket<NPL>::QB * 32)
    knn_idx_kernel(const float* __restrict__ x, int C,
                   const float* __restrict__ sq, int N, int k,
                   int* __restrict__ idx) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * dg::Bucket<NPL>::QB + warp;
  float s[NPL];
  dg::row_scores<NPL>(x + (size_t)b * N * C, C, sq + (size_t)b * N, N, i,
                      lane, sg, s);
  int* irow = idx + ((size_t)b * N + i) * k;
  for (int r = 0; r < k; ++r) {
    const int j = dg::pop_nearest<NPL>(s, lane);
    if (lane == 0) irow[r] = j;
  }
}

}  // namespace

// x (B, N, C), scratch sq (B*N,), idx (B, N, k) int32; f32 otherwise,
// contiguous, on the device.  Returns the first CUDA error.
extern "C" int dg_knn_idx(const float* x, float* sq, int* idx, int B, int N,
                          int C, int k, void* stream) {
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || C < 1 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dg::launch_sqnorm(x, B * N, C, sq, st);
  if (e != cudaSuccess) return (int)e;
  e = dg::with_npl(N, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    constexpr int QB = dg::Bucket<NPL>::QB;
    const size_t smem = dg::select_smem_bytes<NPL>(N);
    cudaError_t err = cudaFuncSetAttribute(
        knn_idx_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    knn_idx_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(x, C, sq, N,
                                                               k, idx);
    return cudaGetLastError();
  });
  return (int)e;
}
