// knn_edge2: one whole eval two-conv EdgeConv block on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::fused_knn_edge2
// (body _knn_edge2_kernel), in its exact (f32) mode:
//
//   nbr(i) = the k highest 2<g_i,g_j> - |g_i|^2 - |g_j|^2, self included,
//            lowest index first among equal scores     (kNN over graph)
//   h1 = LReLU((a1[j] + b1[i]) * s1 + t1)               (conv1 + BN1, C1)
//   h2 = LReLU((h1 @ w2) * s2 + t2)                      (conv2 + BN2, C2)
//   out_i = max over j in nbr(i) of h2                  (per channel)
//
// with a1 = x @ W1_nbr and b1 = x @ W1_ctr projected by the caller.
//
// Bound on an H100 SXM: operations.  At the DGCNNSemSeg eval shapes (B=16,
// N=4096, k=20, C1 = C2 = 64, Cg = 3 and 64) the scores are 2*B*N^2*Cg
// flops (1.6 and 34.4 GFLOP) and the per-edge second conv 2*B*N*k*C1*C2
// (10.7 GFLOP a block): ~57 GFLOP over the two blocks, ~0.86 ms at the f32
// CUDA-core peak (67 TFLOP/s), against ~0.1 GB in and out.
//
// Design, two routes decided from the shape before the launch (both
// after sqnorm):
//   k <= TS_LIST (64), C1 <= 64 and C2 <= 128 (every model: k = 20, 32,
//   40; C1 = 64, C2 = 64 or, in the TransformNet, 128)
//   knn_edge2_tiled_kernel.  The tiled selection of knn_select.cuh
//   (tiled_topk, as kernel 3 runs it): a block of 256 threads owns 64
//   query rows, streams the cloud in tiles of 128 columns whose scores
//   are a register-blocked product, and keeps each row's running top-k
//   in its warp's registers; no score stays in registers across tiles,
//   so nothing spills at N = 4096 and two blocks fit an SM.  Then the
//   block consumes its rows' edges in tiles of R = min(8, 128 / k) whole
//   rows (R * k <= 128 edges, as edge2_bwd.cu tiles them): the tile's
//   h1 goes to shared memory (e2_h1_row's operations), z2 = h1 w2 is a
//   register-blocked product (edge2_tile.cuh's block, shared with kernels
//   7 and 8: 8 edges x 4 channels a thread, 64 channels a pass; each
//   element one fmaf chain over c1 ascending from 0, so e2_z2's bits),
//   each element takes s2, t2 and the LeakyReLU in registers and goes to
//   shared memory, and the max over each row's k edges is taken there, t
//   ascending.  The affine comes before the max
//   because s2 may be negative.  Shared memory: the selection's 83,968 B
//   are free once the lists are in registers; the consumer takes h1 and
//   y of one tile (128 edges x 64 channels each), w2 (up to 64 x 128),
//   the folded affines and the tile's neighbour rows, 100,864 B: two
//   blocks still fit an SM.
//   Any other shape  knn_edge2_kernel: the row-warp selection (a warp per
//   query row with its N scores in registers, or above 4096 points in
//   knn_select.cuh's shared row, and k rounds of warp arg-max), with each
//   winner consumed at once: the lanes write the edge's h1 row into the
//   warp's row of shared memory (edge2.cuh), then
//   each lane forms its second-conv channels as f32 dot products against
//   w2 in shared memory and folds them into a running max.  Each w2 value
//   read from shared memory feeds one FMA.
// Both routes pick the neighbours in torch.topk's order, compute each
// edge's z2 and h2 with the same operations and take the max over the
// edges in that order: their outputs are the same bits.  The tiled
// consumer is edge2_consume.cuh's, which knn_edge2_variant.cu's forms (the
// AMP v3 and v2 forms, the exact v2 form) share.  Neither the (B,
// N, k, C1) hidden tensor nor idx reaches device memory.
//
// Kernel 13, dgcnn_tpu/ops/pallas_banded.py::banded_knn_edge2 (the
// --fast_extract path), is the same block on a cloud in its PC1-sorted
// order, each query tile's candidates a window of `band` sorted rows from
// starts[tile index].  It takes the same two routes on the same rule: at
// k <= 64, C1 <= 64 and C2 <= 128, knn_edge2_tiled_kernel<KL, true>, the
// tiled selection over the window (a block streams band / 128 column
// tiles instead of N / 128, the tile that holds its own query rows first:
// knn_select.cuh; the lists hold rows of the sorted cloud) and the
// consumer above unchanged; at other shapes knn_edge2_kernel over the
// window (see there).  dg_banded_knn_edge2_rowwarp takes the row-warp
// route at any shape: at band = N in the identity order (starts 0) it is
// the exact block's row-warp route, the oracle that holds the tiled
// routes to its bits.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"
#include "edge2_consume.cuh"
#include "edge2_tile.cuh"
#include "knn_select.cuh"

namespace {

using dg::E2_CPL;
using dg::E2_MAXC;

// The candidates of query row i are the W rows [start, start + W) of its
// cloud: start = 0 and W = N for the exact block; for the banded block the
// cloud is in its PC1-sorted order, start is the window start of i's query
// tile (starts[(block's first row) / tile]) and W the band.  The window
// holds every row of its tile, so the query row is one of the staged rows,
// and a window-local winner j is row start + j of a1.
template <int NPL>
__global__ void __launch_bounds__(dg::RowBlock<NPL>::QB * 32)
    knn_edge2_kernel(const float* __restrict__ graph, int Cg,
                     const float* __restrict__ sq,
                     const float* __restrict__ a1,
                     const float* __restrict__ b1, int C1,
                     const float* __restrict__ w2, int C2,
                     const float* __restrict__ s1,
                     const float* __restrict__ t1,
                     const float* __restrict__ s2,
                     const float* __restrict__ t2, float slope, int N, int k,
                     const int* __restrict__ starts, int tile, int W,
                     float* __restrict__ out) {
  const int QB = dg::block_rows<NPL>(dg::RowBlock<NPL>::QB);
  extern __shared__ float smem[];
  float* sg = smem;                          // graph stage (or shared rows)
  float* ws = sg + dg::select_smem_bytes<NPL>(W, QB) / sizeof(float);  // w2
  float* hb = ws + C1 * dg::e2_ldw(C2);                      // QB h1 rows
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const int start = starts ? starts[blockIdx.x * QB / tile] : 0;
  // row_scores synchronises the block before its first read of shared
  // memory and after its first write, which covers w2 too
  dg::e2_stage_w2(w2, C1, C2, ws);
  dg::RowScores<NPL> s;
  dg::row_scores<NPL>(graph + ((size_t)b * N + start) * Cg, Cg,
                      sq + (size_t)b * N + start, W, i - start, lane, sg, s);

  const size_t row = (size_t)b * N + i;
  const dg::E2Centre ctr = dg::e2_centre(b1 + row * C1, s1, t1, C1, lane);
  float sc2[E2_CPL], tc2[E2_CPL], mx[E2_CPL];
#pragma unroll
  for (int v = 0; v < E2_CPL; ++v) {
    const int c = lane + 32 * v;
    sc2[v] = c < C2 ? s2[c] : 0.f;
    tc2[v] = c < C2 ? t2[c] : 0.f;
    mx[v] = -INFINITY;
  }
  const float* A = a1 + ((size_t)b * N + start) * C1;
  float* hrow = hb + warp * C1;
  const int ldw = dg::e2_ldw(C2);
  for (int r = 0; r < k; ++r) {
    const int j = dg::pop_nearest<NPL>(s, lane);
    dg::e2_h1_row(A + (size_t)j * C1, ctr, slope, C1, lane, hrow);
    __syncwarp();
#pragma unroll
    for (int v = 0; v < E2_CPL; ++v) {
      const int c = lane + 32 * v;
      if (c < C2) {
        const float z = dg::e2_z2(hrow, ws, C1, ldw, c);
        const float y =
            dg::e2_lrelu(__fadd_rn(__fmul_rn(z, sc2[v]), tc2[v]), slope);
        mx[v] = fmaxf(mx[v], y);
      }
    }
    __syncwarp();  // before the next edge overwrites hrow
  }
#pragma unroll
  for (int v = 0; v < E2_CPL; ++v) {
    const int c = lane + 32 * v;
    if (c < C2) out[row * C2 + c] = mx[v];
  }
}

// ---------------------------------------------------------------- tiled
using namespace dg::e2c;

// The tiled route: the block's 64 rows' lists (tiled_topk), then
// e2t_consume.  BANDED: the candidates are the W rows from starts[r0 /
// tile] (kernel 13), the query rows' own tile streamed first; else the
// whole cloud.
template <int KL, bool BANDED>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    knn_edge2_tiled_kernel(const float* __restrict__ graph, int Cg,
                           const float* __restrict__ sq,
                           const float* __restrict__ a1,
                           const float* __restrict__ b1, int C1,
                           const float* __restrict__ w2, int C2,
                           const float* __restrict__ s1,
                           const float* __restrict__ t1,
                           const float* __restrict__ s2,
                           const float* __restrict__ t2, float slope, int N,
                           int k, const int* __restrict__ starts, int tile,
                           int W, float* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL, BANDED>(graph + (size_t)b * N * Cg, Cg,
                             sq + (size_t)b * N,
                             BANDED ? starts[r0 / tile] : 0, BANDED ? W : N,
                             r0, k, tsm, ls, li);
  e2t_consume<KL, false>(tsm, li, a1 + (size_t)b * N * C1,
                         b1 + (size_t)b * N * C1, C1, w2, C2, s1, t1, s2, t2,
                         slope, r0, k, out + (size_t)b * N * C2,
                         ScoreOperands<>{});
}

template <int KL, bool BANDED>
cudaError_t launch_tiled(const float* graph, const float* a1,
                         const float* b1, const float* w2, const float* s1,
                         const float* t1, const float* s2, const float* t2,
                         const float* sq, float* out, int B, int N, int Cg,
                         int C1, int C2, int k, float slope,
                         const int* starts, int tile, int W,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_edge2_tiled_kernel<KL, BANDED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)XSMEM_BYTES);
  if (err != cudaSuccess) return err;
  knn_edge2_tiled_kernel<KL, BANDED>
      <<<dim3(N / dg::TS_R, B), dg::TS_THREADS, XSMEM_BYTES, st>>>(
          graph, Cg, sq, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope, N, k,
          starts, tile, W, out);
  return cudaGetLastError();
}

// sqnorm and the tiled kernel, its list size picked from k.
template <bool BANDED>
cudaError_t launch_tiled_block(const float* graph, const float* a1,
                               const float* b1, const float* w2,
                               const float* s1, const float* t1,
                               const float* s2, const float* t2, float* sq,
                               float* out, int B, int N, int Cg, int C1,
                               int C2, int k, float slope, const int* starts,
                               int tile, int W, cudaStream_t st) {
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  if (k <= 32)
    return launch_tiled<1, BANDED>(graph, a1, b1, w2, s1, t1, s2, t2, sq,
                                   out, B, N, Cg, C1, C2, k, slope, starts,
                                   tile, W, st);
  return launch_tiled<2, BANDED>(graph, a1, b1, w2, s1, t1, s2, t2, sq, out,
                                 B, N, Cg, C1, C2, k, slope, starts, tile, W,
                                 st);
}

// sqnorm and the block kernel over the windows described above
// knn_edge2_kernel.
cudaError_t launch_block(const float* graph, const float* a1,
                         const float* b1, const float* w2, const float* s1,
                         const float* t1, const float* s2, const float* t2,
                         float* sq, float* out, int B, int N, int Cg, int C1,
                         int C2, int k, float slope, const int* starts,
                         int tile, int W, cudaStream_t st) {
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  return dg::with_npl(W, 0, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const size_t fixed = sizeof(float) * C1 * dg::e2_ldw(C2);
    const int QB = dg::launch_rows<NPL>(dg::RowBlock<NPL>::QB, W, fixed,
                                        sizeof(float) * C1);
    if (QB == 0) return cudaErrorInvalidValue;
    const size_t smem = dg::select_smem_bytes<NPL>(W, QB) + fixed +
                        sizeof(float) * QB * C1;
    cudaError_t err = cudaFuncSetAttribute(
        knn_edge2_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    knn_edge2_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        graph, Cg, sq, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope, N, k,
        starts, tile, W, out);
    return cudaGetLastError();
  });
}

}  // namespace

// graph (B, N, Cg), a1/b1 (B, N, C1), w2 (C1, C2), s1/t1 (C1,), s2/t2
// (C2,), scratch sq (B*N,), out (B, N, C2); all f32, contiguous, on the
// device.  The tiled route at k <= TS_LIST, C1 <= 64 and C2 <= 128, the
// row-warp route otherwise.  Returns the first CUDA error.
extern "C" int dg_knn_edge2(const float* graph, const float* a1,
                            const float* b1, const float* w2, const float* s1,
                            const float* t1, const float* s2, const float* t2,
                            float* sq, float* out, int B, int N, int Cg,
                            int C1, int C2, int k, float slope,
                            void* stream) {
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || Cg < 1 || C1 < 1 ||
      C1 > E2_MAXC || C2 < 1 || C2 > E2_MAXC || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!tiled_route(C1, C2, k))
    return (int)launch_block(graph, a1, b1, w2, s1, t1, s2, t2, sq, out, B,
                             N, Cg, C1, C2, k, slope, nullptr, N, N, st);
  return (int)launch_tiled_block<false>(graph, a1, b1, w2, s1, t1, s2, t2,
                                        sq, out, B, N, Cg, C1, C2, k, slope,
                                        nullptr, N, N, st);
}

namespace {

int banded_block(const float* graph, const float* a1, const float* b1,
                 const float* w2, const float* s1, const float* t1,
                 const float* s2, const float* t2, const int* starts,
                 float* sq, float* out, int B, int N, int Cg, int C1, int C2,
                 int k, int tile, int band, float slope, bool rowwarp,
                 cudaStream_t st) {
  if (B < 1 || N % 128 != 0 || band > dg::MAX_N || band % 128 != 0 ||
      band < 128 || band > N || tile % 128 != 0 || tile < 128 ||
      tile > band || N % tile != 0 || Cg < 1 || C1 < 1 || C1 > E2_MAXC ||
      C2 < 1 || C2 > E2_MAXC || k < 1 || k > band)
    return (int)cudaErrorInvalidValue;
  if (rowwarp || !tiled_route(C1, C2, k))
    return (int)launch_block(graph, a1, b1, w2, s1, t1, s2, t2, sq, out, B,
                             N, Cg, C1, C2, k, slope, starts, tile, band, st);
  return (int)launch_tiled_block<true>(graph, a1, b1, w2, s1, t1, s2, t2, sq,
                                       out, B, N, Cg, C1, C2, k, slope,
                                       starts, tile, band, st);
}

}  // namespace

// Kernel 13, banded_knn_edge2: the same block on a cloud in its PC1-sorted
// order, the candidates of each query tile of `tile` rows the `band` rows
// from starts[tile index] (the sort, the window starts and the un-sort are
// the caller's).  starts (N / tile,) int32 on the device; the other
// arguments as above.  The tiled route at k <= TS_LIST, C1 <= 64 and C2 <=
// 128, the row-warp route otherwise.  Returns the first CUDA error.
extern "C" int dg_banded_knn_edge2(const float* graph, const float* a1,
                                   const float* b1, const float* w2,
                                   const float* s1, const float* t1,
                                   const float* s2, const float* t2,
                                   const int* starts, float* sq, float* out,
                                   int B, int N, int Cg, int C1, int C2,
                                   int k, int tile, int band, float slope,
                                   void* stream) {
  return banded_block(graph, a1, b1, w2, s1, t1, s2, t2, starts, sq, out, B,
                      N, Cg, C1, C2, k, tile, band, slope, false,
                      (cudaStream_t)stream);
}

// As dg_banded_knn_edge2 on the row-warp route at any shape.
extern "C" int dg_banded_knn_edge2_rowwarp(
    const float* graph, const float* a1, const float* b1, const float* w2,
    const float* s1, const float* t1, const float* s2, const float* t2,
    const int* starts, float* sq, float* out, int B, int N, int Cg, int C1,
    int C2, int k, int tile, int band, float slope, void* stream) {
  return banded_block(graph, a1, b1, w2, s1, t1, s2, t2, starts, sq, out, B,
                      N, Cg, C1, C2, k, tile, band, slope, true,
                      (cudaStream_t)stream);
}
