// knn_sum: the kNN graph and the f32 sum of the neighbours' rows of `a`,
// on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::fused_knn_sum (body
// _knn_sum_kernel) in its exact (v1, f32) mode, the first half of the HOG
// moment form (dgcnn_tpu/ops/hog.py::_compute_hog_fused):
//
//   idx[i, t] = the t-th of the k highest 2<x_i,x_j> - |x_i|^2 - |x_j|^2,
//               self included, lowest index first among equal scores
//   asum[i, c] = sum over t = 0..k-1, in that order, of a[idx[i, t], c]
//
// The TPU sums through a multi-hot matrix product with a 3-way bf16 split
// of `a` (_split3, _onehot_dot); here each sum is a plain f32 sum in
// neighbour order, so its last bits differ from the TPU's but equal those
// of the plain version's ordered sum.
//
// Bound on an H100 SXM: operations.  At the HOG shape (B=16, N=2048, C=3,
// k=32, a of 9 moments) the scores are 2*B*N^2*C flops plus one comparison
// a score, ~0.47 G operations, ~0.007 ms at the f32 CUDA-core peak (67
// TFLOP/s); x and a in, idx and asum out are ~6.3 MB, ~0.002 ms at 3.35
// TB/s.  As in knn_idx.cu, the k rounds of warp arg-max over N scores a
// row (k * N comparisons a row) are the real cost.
//
// Design: knn_idx.cu's kernel (sqnorm, then knn_select.cuh's warp-per-row
// selection with the N scores in registers) with the sum folded into the
// rounds: every lane learns each round's winner j, and lane c < Ca adds
// a[j, c] to its running sum, so the (B, N, k, Ca) gather never exists.
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

template <int NPL>
__global__ void __launch_bounds__(dg::Bucket<NPL>::QB * 32)
    knn_sum_kernel(const float* __restrict__ x, int C,
                   const float* __restrict__ sq, int N, int k,
                   const float* __restrict__ a, int Ca,
                   int* __restrict__ idx, float* __restrict__ asum) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * dg::Bucket<NPL>::QB + warp;
  float s[NPL];
  dg::row_scores<NPL>(x + (size_t)b * N * C, C, sq + (size_t)b * N, N, i,
                      lane, sg, s);
  const float* ab = a + (size_t)b * N * Ca;
  int* irow = idx + ((size_t)b * N + i) * k;
  float acc = 0.f;  // lane c < Ca: the running sum of channel c
  for (int r = 0; r < k; ++r) {
    const int j = dg::pop_nearest<NPL>(s, lane);
    if (lane == 0) irow[r] = j;
    if (lane < Ca) {
      const float v = ab[(size_t)j * Ca + lane];
      acc = r == 0 ? v : acc + v;
    }
  }
  if (lane < Ca) asum[((size_t)b * N + i) * Ca + lane] = acc;
}

}  // namespace

// x (B, N, C), a (B, N, Ca) with Ca <= 32, scratch sq (B*N,), idx (B, N, k)
// int32, asum (B, N, Ca); f32 otherwise, contiguous, on the device.
// Returns the first CUDA error.
extern "C" int dg_knn_sum(const float* x, const float* a, float* sq,
                          int* idx, float* asum, int B, int N, int C,
                          int Ca, int k, void* stream) {
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || C < 1 || Ca < 1 ||
      Ca > 32 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dg::launch_sqnorm(x, B * N, C, sq, st);
  if (e != cudaSuccess) return (int)e;
  e = dg::with_npl(N, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    constexpr int QB = dg::Bucket<NPL>::QB;
    const size_t smem = dg::select_smem_bytes<NPL>(N);
    cudaError_t err = cudaFuncSetAttribute(
        knn_sum_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    knn_sum_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        x, C, sq, N, k, a, Ca, idx, asum);
    return cudaGetLastError();
  });
  return (int)e;
}
