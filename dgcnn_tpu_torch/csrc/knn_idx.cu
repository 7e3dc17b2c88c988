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
// idx out, ~0.003 ms at 3.35 TB/s.  What a selection costs beyond that is
// keeping the k best of N scores a row.
//
// Design, two routes decided from k before the launch (sqnorm first on
// both):
//   k <= TS_LIST (64; every model: k = 20, 32, 40)  knn_idx_tiled_kernel:
//     the tiled selection of knn_select.cuh (tiled_topk), kernel 3's
//     tiled route without its reductions.  A block of 256 threads owns 64
//     query rows and streams the cloud in tiles of 128 columns whose
//     scores are a register-blocked product; each warp keeps eight rows'
//     running top-k in registers, filled by sorting the first tile, after
//     which a column enters only above the k-th: few insertions a row after
//     the first tiles.  Each row's list is then written in list order
//     (position p is slot p / 32 of lane p % 32) as coalesced int32 stores.
//   k > TS_LIST  knn_idx_kernel (also dg_knn_idx_rowwarp at any k, the
//     earlier side of the A/B and of chip_smoke.py's checks): the row-warp
//     selection, one warp a query row with its N scores in registers (N /
//     32 a lane; above 4096 points in knn_select.cuh's shared row), the
//     cloud staged through shared memory, and k rounds of warp arg-max on
//     (score, -index), k * N comparisons a row.
// The v2 form (dg_knn_idx_v2: DGCNN_TPU_EXTRACT=v2, read by
// _knn_only_kernel at pallas_knn.py:1554) lists the k largest packed keys
// of the same f32 scores (_pack_keys, :87): a TS_MIN pass of the tiled
// selection writes each row's least score, the TS_KEYS pass lists the keys
// (knn_select.cuh), lowest index first among equal ones; above TS_LIST
// (or dg_knn_idx_v2_rowwarp) the row-warp route on the same keys
// (row_keys), the row's least score taken from its registers.
// Both routes give each score the same bits (one fmaf chain over the
// channels, 0 ascending, then the same _rn operations) and the same
// neighbours in torch.topk's order, ties included: idx is identical on both
// routes and from call to call.  The N x N scores never reach device memory.
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

// The row-warp route; KEYS: v2, the row's keys (row_keys).
template <int NPL, bool KEYS>
__global__ void __launch_bounds__(dg::ROW_QB<NPL, KEYS> * 32, 1)
    knn_idx_kernel(const float* __restrict__ x, int C,
                   const float* __restrict__ sq, int N, int k,
                   int* __restrict__ idx, float lim) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i =
      blockIdx.x * dg::block_rows<NPL>(dg::ROW_QB<NPL, KEYS>) + warp;
  dg::RowScores<NPL> s;
  dg::row_scores<NPL>(x + (size_t)b * N * C, C, sq + (size_t)b * N, N, i,
                      lane, sg, s);
  if constexpr (KEYS) dg::row_keys<NPL>(s, lim);
  int* irow = idx + ((size_t)b * N + i) * k;
  for (int r = 0; r < k; ++r) {
    const int j = dg::pop_nearest<NPL>(s, lane);
    if (lane == 0) irow[r] = j;
  }
}

// The tiled route: the block's 64 rows' lists, then each row's list
// written in order, a warp its eight rows.  MODE TS_TOPK is v1; TS_KEYS
// v2, on the rows' grids in rmin.
template <int KL, int MODE>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    knn_idx_tiled_kernel(const float* __restrict__ x, int C,
                         const float* __restrict__ sq, int N, int k,
                         int* __restrict__ idx, float* rmin, float lim) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  const float* G = x + (size_t)b * N * C;
  dg::tiled_topk<KL, false, MODE>(G, C, sq + (size_t)b * N, 0, N, r0, k, tsm,
                                  ls, li, G,
                                  MODE == dg::TS_KEYS ? rmin + (size_t)b * N
                                                      : nullptr,
                                  lim);
#pragma unroll
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    int* irow = idx + ((size_t)b * N + r0 + dg::TS_WR * warp + rr) * k;
#pragma unroll
    for (int q = 0; q < KL; ++q)
      if (lane + 32 * q < k) irow[lane + 32 * q] = li[rr][q];
  }
}

template <int KL, int MODE = dg::TS_TOPK>
cudaError_t launch_tiled(const float* x, const float* sq, int* idx, int B,
                         int N, int C, int k, cudaStream_t st,
                         float* rmin = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_idx_tiled_kernel<KL, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dg::TS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  knn_idx_tiled_kernel<KL, MODE>
      <<<dim3(N / dg::TS_R, B), dg::TS_THREADS, dg::TS_SMEM_BYTES, st>>>(
          x, C, sq, N, k, idx, rmin, dg::keys_lim(N));
  return cudaGetLastError();
}

template <bool KEYS>
cudaError_t launch_rowwarp(const float* x, const float* sq, int* idx, int B,
                           int N, int C, int k, cudaStream_t st) {
  return dg::with_npl(N, 0, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const int QB = dg::launch_rows<NPL>(dg::ROW_QB<NPL, KEYS>, N);
    const size_t smem = dg::select_smem_bytes<NPL>(N, QB);
    auto kern = knn_idx_kernel<NPL, KEYS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(N / QB, B), QB * 32, smem, st>>>(x, C, sq, N, k, idx,
                                                  dg::keys_lim(N));
    return cudaGetLastError();
  });
}

// rmin (B * N scratch) asks for the v2 form.
int knn_idx(const float* x, float* sq, float* rmin, int* idx, int B, int N,
            int C, int k, bool rowwarp, cudaStream_t st) {
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || C < 1 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = dg::launch_sqnorm(x, B * N, C, sq, st);
  if (e != cudaSuccess) return (int)e;
  rowwarp = rowwarp || k > dg::TS_LIST;
  if (rmin != nullptr && rowwarp)
    return (int)launch_rowwarp<true>(x, sq, idx, B, N, C, k, st);
  if (rmin != nullptr) {
    e = dg::launch_rowmin(x, x, C, sq, B, N, nullptr, N, N, rmin, st);
    if (e != cudaSuccess) return (int)e;
    if (k <= 32)
      return (int)launch_tiled<1, dg::TS_KEYS>(x, sq, idx, B, N, C, k, st,
                                               rmin);
    return (int)launch_tiled<2, dg::TS_KEYS>(x, sq, idx, B, N, C, k, st,
                                             rmin);
  }
  if (rowwarp) return (int)launch_rowwarp<false>(x, sq, idx, B, N, C, k, st);
  if (k <= 32) return (int)launch_tiled<1>(x, sq, idx, B, N, C, k, st);
  return (int)launch_tiled<2>(x, sq, idx, B, N, C, k, st);
}

}  // namespace

// x (B, N, C), scratch sq (B*N,), idx (B, N, k) int32; f32 otherwise,
// contiguous, on the device.  Returns the first CUDA error.
extern "C" int dg_knn_idx(const float* x, float* sq, int* idx, int B, int N,
                          int C, int k, void* stream) {
  return knn_idx(x, sq, nullptr, idx, B, N, C, k, false,
                 (cudaStream_t)stream);
}

// The v2 form of dg_knn_idx: rmin (B * N f32) is scratch for the rows'
// grids (the tiled route's).
extern "C" int dg_knn_idx_v2(const float* x, float* sq, float* rmin,
                             int* idx, int B, int N, int C, int k,
                             void* stream) {
  if (rmin == nullptr) return (int)cudaErrorInvalidValue;
  return knn_idx(x, sq, rmin, idx, B, N, C, k, false, (cudaStream_t)stream);
}

// As dg_knn_idx_v2 on the row-warp route at any k.
extern "C" int dg_knn_idx_v2_rowwarp(const float* x, float* sq, float* rmin,
                                     int* idx, int B, int N, int C, int k,
                                     void* stream) {
  if (rmin == nullptr) return (int)cudaErrorInvalidValue;
  return knn_idx(x, sq, rmin, idx, B, N, C, k, true, (cudaStream_t)stream);
}

// As dg_knn_idx on the row-warp route at any k.
extern "C" int dg_knn_idx_rowwarp(const float* x, float* sq, int* idx, int B,
                                  int N, int C, int k, void* stream) {
  return knn_idx(x, sq, nullptr, idx, B, N, C, k, true,
                 (cudaStream_t)stream);
}
