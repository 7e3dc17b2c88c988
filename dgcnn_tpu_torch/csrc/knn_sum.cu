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
// neighbour order, starting from the t = 0 term, so its last bits differ
// from the TPU's but equal those of the plain version's ordered sum.
//
// Bound on an H100 SXM: operations.  At the HOG shape (B=16, N=2048, C=3,
// k=32, a of 9 moments) the scores are 2*B*N^2*C flops plus one comparison
// a score, ~0.47 G operations, ~0.007 ms at the f32 CUDA-core peak (67
// TFLOP/s); x and a in, idx and asum out are ~6.3 MB, ~0.002 ms at 3.35
// TB/s.  What a selection costs beyond that is keeping the k best of N
// scores a row.
//
// Design, two routes decided from k before the launch (sqnorm first on
// both):
//   k <= TS_LIST (64; the Net's k = 32)  knn_sum_tiled_kernel: kernel 11's
//     tiled route (knn_idx.cu; knn_select.cuh's tiled_topk: 64 query rows
//     a block, 128-column tiles whose scores are a register-blocked
//     product, each warp's eight rows' running top-k in registers), each
//     row's list written to idx in list order, then folded into its sums.
//     The fold stages each warp's eight lists in its own eight rows of the
//     selection's finished-tile buffer (no other warp touches them once
//     tiled_topk returns), a row at a stride of TS_LIST + 1 words, and
//     folds G = min(8, 32 / Ca) rows at once, lane g * Ca + c on row g and
//     channel c (Ca = 9: three rows on 27 lanes, three passes for the
//     eight rows where one row a pass would leave 23 of 32 lanes idle
//     eight times).  A lane reads its row's t-th index from shared memory,
//     a broadcast among the row's Ca lanes (the G rows sit in distinct
//     banks), where a shuffle of the registers serves one row an
//     instruction: G rows would cost G shuffles and a select each t.  The
//     gathers of `a` (73 KB a cloud at Ca = 9) hit L1 and L2.
//   k > TS_LIST  knn_sum_kernel (also dg_knn_sum_rowwarp at any k, the
//     earlier side of the A/B and of chip_smoke.py's checks): the row-warp
//     selection, one warp a query row with its N scores in registers (in
//     knn_select.cuh's shared row above 4096 points), k rounds of warp
//     arg-max, with the sum folded into the rounds: every lane learns each
//     round's winner j and lane c < Ca adds a[j, c].
// The v2 form (dg_knn_sum_v2), the JAX package's default: _knn_sum_kernel's
// variant is _extract_version("v2", ...) (pallas_knn.py:1518), so the AMP
// Net runs it and DGCNN_TPU_EXTRACT=v2 asks for it in the exact mode.  It
// lists the k largest packed keys of the same exact f32 scores (_pack_keys,
// :87): a TS_MIN pass of the tiled selection writes each row's least
// score, the TS_KEYS pass lists the keys (knn_select.cuh), lowest index
// first among equal ones; then the v1 form's list-order store and fold.
// Its sums stay the exact f32 sums in list order t = 0..k-1 (the TPU's v2
// sums the multi-hot rows of the same set).  Above TS_LIST (or
// dg_knn_sum_v2_rowwarp) the row-warp route on the same keys (row_keys).
// Both routes pick the same neighbours in the same order (kernel 11's
// routes give the same idx, ties included) and sum them in that order from
// the t = 0 term: idx and asum are the same bits on both routes.  Neither
// writes the (B, N, k, Ca) gather or the N x N scores to device memory.
#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

// The row-warp route; KEYS: v2, the row's keys (row_keys).
template <int NPL, bool KEYS>
__global__ void __launch_bounds__(dg::ROW_QB<NPL, KEYS> * 32, 1)
    knn_sum_kernel(const float* __restrict__ x, int C,
                   const float* __restrict__ sq, int N, int k,
                   const float* __restrict__ a, int Ca,
                   int* __restrict__ idx, float* __restrict__ asum,
                   float lim) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i =
      blockIdx.x * dg::block_rows<NPL>(dg::ROW_QB<NPL, KEYS>) + warp;
  dg::RowScores<NPL> s;
  dg::row_scores<NPL>(x + (size_t)b * N * C, C, sq + (size_t)b * N, N, i,
                      lane, sg, s);
  if constexpr (KEYS) dg::row_keys<NPL>(s, lim);
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

constexpr int LS = dg::TS_LIST + 1;  // a staged list's stride (words)

// The tiled route: the block's 64 rows' lists, each written to idx in list
// order and staged in shared memory, then the sums, a warp its eight rows.
// MODE TS_TOPK is v1; TS_KEYS v2, on the rows' grids in rmin.
template <int KL, int MODE>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    knn_sum_tiled_kernel(const float* __restrict__ x, int C,
                         const float* __restrict__ sq, int N, int k,
                         const float* __restrict__ a, int Ca,
                         int* __restrict__ idx, float* __restrict__ asum,
                         float* rmin, float lim) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  const float* X = x + (size_t)b * N * C;
  dg::tiled_topk<KL, false, MODE>(X, C, sq + (size_t)b * N, 0, N, r0, k, tsm,
                                  ls, li, X,
                                  MODE == dg::TS_KEYS ? rmin + (size_t)b * N
                                                      : nullptr,
                                  lim);
  // the warp's own rows of tiled_topk's finished-tile buffer (TS_WR rows
  // of TS_J words from row TS_WR * warp): the eight lists at stride LS
  static_assert(dg::TS_WR * LS <= dg::TS_WR * dg::TS_J, "lists fit");
  int* lists = reinterpret_cast<int*>(tsm) + dg::TS_WR * warp * dg::TS_J;
  const size_t row0 = (size_t)b * N + r0 + dg::TS_WR * warp;
#pragma unroll
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    int* irow = idx + (row0 + rr) * k;
#pragma unroll
    for (int q = 0; q < KL; ++q) {
      const int p = lane + 32 * q;
      if (p < k) {
        irow[p] = li[rr][q];
        lists[rr * LS + p] = li[rr][q];
      }
    }
  }
  __syncwarp();
  const int G = min(dg::TS_WR, 32 / Ca);  // rows folded at once
  const int g = lane / Ca, c = lane - g * Ca;
  if (g >= G) return;
  const float* ab = a + (size_t)b * N * Ca + c;
  for (int rr = g; rr < dg::TS_WR; rr += G) {
    const int* lr = lists + rr * LS;
    float acc = ab[(size_t)lr[0] * Ca];
#pragma unroll
    for (int t = 1; t < 32 * KL; ++t)
      if (t < k) acc += ab[(size_t)lr[t] * Ca];
    asum[(row0 + rr) * Ca + c] = acc;
  }
}

template <int KL, int MODE = dg::TS_TOPK>
cudaError_t launch_tiled(const float* x, const float* a, const float* sq,
                         int* idx, float* asum, int B, int N, int C, int Ca,
                         int k, cudaStream_t st, float* rmin = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_sum_tiled_kernel<KL, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dg::TS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  knn_sum_tiled_kernel<KL, MODE>
      <<<dim3(N / dg::TS_R, B), dg::TS_THREADS, dg::TS_SMEM_BYTES, st>>>(
          x, C, sq, N, k, a, Ca, idx, asum, rmin, dg::keys_lim(N));
  return cudaGetLastError();
}

template <bool KEYS>
cudaError_t launch_rowwarp(const float* x, const float* a, const float* sq,
                           int* idx, float* asum, int B, int N, int C,
                           int Ca, int k, cudaStream_t st) {
  return dg::with_npl(N, 0, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const int QB = dg::launch_rows<NPL>(dg::ROW_QB<NPL, KEYS>, N);
    const size_t smem = dg::select_smem_bytes<NPL>(N, QB);
    auto kern = knn_sum_kernel<NPL, KEYS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(N / QB, B), QB * 32, smem, st>>>(x, C, sq, N, k, a, Ca, idx,
                                                  asum, dg::keys_lim(N));
    return cudaGetLastError();
  });
}

// rmin (B * N scratch) asks for the v2 form.
int knn_sum(const float* x, const float* a, float* sq, float* rmin, int* idx,
            float* asum, int B, int N, int C, int Ca, int k, bool rowwarp,
            cudaStream_t st) {
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || C < 1 || Ca < 1 ||
      Ca > 32 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = dg::launch_sqnorm(x, B * N, C, sq, st);
  if (e != cudaSuccess) return (int)e;
  rowwarp = rowwarp || k > dg::TS_LIST;
  if (rmin != nullptr && rowwarp)
    return (int)launch_rowwarp<true>(x, a, sq, idx, asum, B, N, C, Ca, k, st);
  if (rmin != nullptr) {
    e = dg::launch_rowmin(x, x, C, sq, B, N, nullptr, N, N, rmin, st);
    if (e != cudaSuccess) return (int)e;
    if (k <= 32)
      return (int)launch_tiled<1, dg::TS_KEYS>(x, a, sq, idx, asum, B, N, C,
                                               Ca, k, st, rmin);
    return (int)launch_tiled<2, dg::TS_KEYS>(x, a, sq, idx, asum, B, N, C, Ca,
                                             k, st, rmin);
  }
  if (rowwarp)
    return (int)launch_rowwarp<false>(x, a, sq, idx, asum, B, N, C, Ca, k,
                                      st);
  if (k <= 32)
    return (int)launch_tiled<1>(x, a, sq, idx, asum, B, N, C, Ca, k, st);
  return (int)launch_tiled<2>(x, a, sq, idx, asum, B, N, C, Ca, k, st);
}

}  // namespace

// x (B, N, C), a (B, N, Ca) with Ca <= 32, scratch sq (B*N,), idx (B, N, k)
// int32, asum (B, N, Ca); f32 otherwise, contiguous, on the device.
// Returns the first CUDA error.
extern "C" int dg_knn_sum(const float* x, const float* a, float* sq,
                          int* idx, float* asum, int B, int N, int C,
                          int Ca, int k, void* stream) {
  return knn_sum(x, a, sq, nullptr, idx, asum, B, N, C, Ca, k, false,
                 (cudaStream_t)stream);
}

// The v2 form of dg_knn_sum: rmin (B * N f32) is scratch for the rows'
// grids (the tiled route's).
extern "C" int dg_knn_sum_v2(const float* x, const float* a, float* sq,
                             float* rmin, int* idx, float* asum, int B, int N,
                             int C, int Ca, int k, void* stream) {
  if (rmin == nullptr) return (int)cudaErrorInvalidValue;
  return knn_sum(x, a, sq, rmin, idx, asum, B, N, C, Ca, k, false,
                 (cudaStream_t)stream);
}

// As dg_knn_sum_v2 on the row-warp route at any k.
extern "C" int dg_knn_sum_v2_rowwarp(const float* x, const float* a,
                                     float* sq, float* rmin, int* idx,
                                     float* asum, int B, int N, int C, int Ca,
                                     int k, void* stream) {
  if (rmin == nullptr) return (int)cudaErrorInvalidValue;
  return knn_sum(x, a, sq, rmin, idx, asum, B, N, C, Ca, k, true,
                 (cudaStream_t)stream);
}

// As dg_knn_sum on the row-warp route at any k.
extern "C" int dg_knn_sum_rowwarp(const float* x, const float* a, float* sq,
                                  int* idx, float* asum, int B, int N, int C,
                                  int Ca, int k, void* stream) {
  return knn_sum(x, a, sq, nullptr, idx, asum, B, N, C, Ca, k, true,
                 (cudaStream_t)stream);
}
