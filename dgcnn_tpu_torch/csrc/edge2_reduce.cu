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
// (67 TFLOP/s; chip_smoke.py's bound, with the per-edge elementwise work,
// 0.34 ms), against ~0.13 GB of idx, a1, b1 in and reductions out, ~0.04
// ms at 3.35 TB/s.
//
// Design, two routes decided from the shape before the launch:
//   C1, C2 <= 64 and multiples of 4, k <= 128 (every model: C1 = C2 = 64,
//   k = 20 or 40; edge2_tile.cuh's e2t_train_route, the route of
//   edge2_bwd.cu too)  edge2_fwd_tiled_kernel.  A tile is R = min(8, 128
//   / k) whole centre rows (120 edges at k = 20 and 40).  A block of 256
//   threads stages the tile's b1 rows, its h1 (e2_h1_row's operations) and
//   w2 in shared memory, computes z2 = h1 w2 as a register block (8 edges
//   x 4 channels a thread, each element one fmaf chain over c1 ascending
//   from +0: e2_z2's bits) and writes it over h1; then one thread a (row,
//   channel) walks the row's k edges in t order and forms the four
//   reductions with the row-warp form's operations (fmaxf, fminf, _rn
//   adds).  So every output is bit-equal to the row-warp form's, and
//   edge2_bwd.cu's tie tests, which compare its recomputed z2 with amax and
//   amin, see equal bits.  Each w2 value read from shared memory feeds
//   eight FMAs (the row-warp form: one).  A block a tile: 52,736 B of
//   shared memory and at most 80 registers a thread (__launch_bounds__), so
//   three blocks share an SM.  Measured on an H100 (tools/reduce_ab.py,
//   PERF.md): three blocks an SM are ~17% faster than two at 98
//   registers, and a grid of three blocks an SM striding over the tiles
//   (w2 staged once a block) was 1-2% faster but spilled 8 B a thread.
//   Any other shape  edge2_fwd_kernel: one warp per centre row (QB = 16
//   rows a block).  For each neighbour the lanes read its row of a1
//   (coalesced), write the h1 row into the warp's row of shared memory,
//   then form their z2 channels as dot products against w2 in shared
//   memory (two shared loads an FMA).
// Neither per-edge tensor reaches device memory on either route, and no
// output has an atomic: the bits are the same from run to run.
//
// The AMP form (dg_edge2_fwd_amp), the JAX package's default in training
// (_edge2_train_kernel with exact=False, pallas_knn.py:1120-1161): a1's
// selected values rounded to bf16 (to nearest even; _parts(a1, False),
// :1131) as the tile stages h1; z1, h1, z2 and the four reductions are the
// exact form's f32 operations on them.  edge2_bwd.cu's AMP form stages h1
// with the same rounding, so its z2 and the ties it finds are the same
// bits.  Both routes, as the exact form takes them: the tiled one at
// e2t_train_route's shapes (every model's), the row-warp one (h1 rounded
// the same way, e2_h1_row<true>) at the others, k > 128 among them.  At
// the tiled route's shapes the AMP form runs on the tensor cores by
// default (edge2_reduce_tc.cu); the tiled instance here is its earlier
// form (the wrapper's simt=True).
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"
#include "edge2_tile.cuh"

namespace {

using dg::E2_CPL;
using dg::E2_MAXC;

constexpr int QB = 16;  // rows (warps) per block

// The row-warp route; AMP: a1's values rounded to bf16 as h1 is formed.
template <bool AMP>
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
    dg::e2_h1_row<AMP>(A + (size_t)irow[t] * C1, ctr, slope, C1, lane,
                       hrow);
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

// ---------------------------------------------------------------- tiled
constexpr int TT = dg::E2T_THREADS;
constexpr int TE = dg::E2T_EDGES;
constexpr int TR = dg::E2T_ROWS;
constexpr int TC = dg::E2T_C1;  // C1, C2 <= TC; row stride of h1 and z2
constexpr size_t TSMEM =
    sizeof(float) * (TC * TC + TE * TC + TR * TC + 2 * TC) +
    sizeof(int) * 2 * TE;

template <bool AMP>
__global__ void __launch_bounds__(TT, 3)
    edge2_fwd_tiled_kernel(const int* __restrict__ idx,
                           const float* __restrict__ a1,
                           const float* __restrict__ b1, int C1,
                           const float* __restrict__ s1,
                           const float* __restrict__ t1,
                           const float* __restrict__ w2, int C2, float slope,
                           int rows, int N, int k, float* __restrict__ amax,
                           float* __restrict__ amin, float* __restrict__ asum,
                           float* __restrict__ asumsq) {
  extern __shared__ __align__(16) float tsm[];
  float* w2s = tsm;             // w2 (C1, C2), row stride C2
  float* hb = w2s + TC * TC;    // h1 of the tile's edges, then their z2
  float* b1s = hb + TE * TC;    // (R, C1): the rows' b1
  float* s1s = b1s + TR * TC;   // s1, t1
  float* t1s = s1s + TC;
  int* jrow = reinterpret_cast<int*>(t1s + TC);  // a1 row of an edge, or -1
  int* eloc = jrow + TE;                         // its row in the tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int R = dg::e2t_rows(k), E = R * k, row0 = blockIdx.x * R;
  for (int e = tid; e < C1 * C2; e += TT) w2s[e] = w2[e];
  if (tid < TC) {
    s1s[tid] = tid < C1 ? s1[tid] : 0.f;
    t1s[tid] = tid < C1 ? t1[tid] : 0.f;
  }
  for (int e = tid; e < TE; e += TT) {
    const int r = e / k, t = e - r * k;
    const int row = row0 + r;
    const bool in = e < E && row < rows;
    jrow[e] = in ? (row / N) * N + idx[(size_t)row * k + t] : -1;
    eloc[e] = r;
  }
  for (int q = tid; q < R * TC; q += TT) {
    const int r = q / TC, c = q & (TC - 1);
    const int row = row0 + r;
    b1s[q] = row < rows && c < C1 ? b1[(size_t)row * C1 + c] : 0.f;
  }
  __syncthreads();
  dg::e2t_stage_h1<false, AMP>(a1, b1s, TC, jrow, eloc, s1s, t1s, C1, slope,
                               hb);
  __syncthreads();
  // z2 = h1 w2: edges ty + 16 m, second-conv channels 4 tx + i
  const bool active = 4 * tx < C2;
  float acc[8][4];
  if (active) dg::e2t_z2_block(hb, w2s, C2, C1, 4 * tx, ty, acc);
  __syncthreads();  // every read of h1 is done: z2 takes its place
  if (active) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      *reinterpret_cast<float4*>(hb + (ty + 16 * m) * TC + 4 * tx) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  // the four reductions over each row's edges, t ascending: the row-warp
  // form's operations
  for (int q = tid; q < R * TC; q += TT) {
    const int r = q / TC, c = q & (TC - 1);
    const int row = row0 + r;
    if (c >= C2 || row >= rows) continue;
    float mx = -INFINITY, mn = INFINITY, sm = 0.f, s2 = 0.f;
    for (int t = 0; t < k; ++t) {
      const float z = hb[(r * k + t) * TC + c];
      mx = fmaxf(mx, z);
      mn = fminf(mn, z);
      sm = __fadd_rn(sm, z);
      s2 = __fadd_rn(s2, __fmul_rn(z, z));
    }
    const size_t o = (size_t)row * C2 + c;
    amax[o] = mx;
    amin[o] = mn;
    asum[o] = sm;
    asumsq[o] = s2;
  }
}

bool valid(int B, int N, int C1, int C2, int k) {
  return B >= 1 && N >= 1 && C1 >= 1 && C1 <= E2_MAXC && C2 >= 1 &&
         C2 <= E2_MAXC && k >= 1 && k <= N;
}

template <bool AMP>
int launch_rowwarp(const int* idx, const float* a1, const float* b1,
                   const float* s1, const float* t1, const float* w2,
                   float* amax, float* amin, float* asum, float* asumsq,
                   int B, int N, int C1, int C2, int k, float slope,
                   cudaStream_t st) {
  const int rows = B * N;
  const size_t smem =
      sizeof(float) * ((size_t)C1 * dg::e2_ldw(C2) + (size_t)QB * C1);
  cudaError_t e = cudaFuncSetAttribute(
      edge2_fwd_kernel<AMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  edge2_fwd_kernel<AMP><<<(rows + QB - 1) / QB, QB * 32, smem, st>>>(
      idx, a1, b1, C1, s1, t1, w2, C2, slope, rows, N, k, amax, amin, asum,
      asumsq);
  return (int)cudaGetLastError();
}

template <bool AMP>
int launch_tiled(const int* idx, const float* a1, const float* b1,
                 const float* s1, const float* t1, const float* w2,
                 float* amax, float* amin, float* asum, float* asumsq, int B,
                 int N, int C1, int C2, int k, float slope, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      edge2_fwd_tiled_kernel<AMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TSMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = B * N, R = dg::e2t_rows(k);
  edge2_fwd_tiled_kernel<AMP><<<(rows + R - 1) / R, TT, TSMEM, st>>>(
      idx, a1, b1, C1, s1, t1, w2, C2, slope, rows, N, k, amax, amin, asum,
      asumsq);
  return (int)cudaGetLastError();
}

}  // namespace

// idx (B, N, k) int32; a1/b1 (B, N, C1), s1/t1 (C1,), w2 (C1, C2) f32; out
// amax/amin/asum/asumsq (B, N, C2) f32; all contiguous, on the device.
// C1, C2 <= 64 (multiples of 4) and k <= 128 take the tiled route, other
// shapes the row-warp route.  Returns the first CUDA error.
extern "C" int dg_edge2_fwd(const int* idx, const float* a1, const float* b1,
                            const float* s1, const float* t1, const float* w2,
                            float* amax, float* amin, float* asum,
                            float* asumsq, int B, int N, int C1, int C2,
                            int k, float slope, void* stream) {
  if (!valid(B, N, C1, C2, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!dg::e2t_train_route(C1, C2, k))
    return launch_rowwarp<false>(idx, a1, b1, s1, t1, w2, amax, amin, asum,
                                 asumsq, B, N, C1, C2, k, slope, st);
  return launch_tiled<false>(idx, a1, b1, s1, t1, w2, amax, amin, asum,
                             asumsq, B, N, C1, C2, k, slope, st);
}

// The AMP form of dg_edge2_fwd (the note): the same arguments and routes.
extern "C" int dg_edge2_fwd_amp(const int* idx, const float* a1,
                                const float* b1, const float* s1,
                                const float* t1, const float* w2,
                                float* amax, float* amin, float* asum,
                                float* asumsq, int B, int N, int C1, int C2,
                                int k, float slope, void* stream) {
  if (!valid(B, N, C1, C2, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!dg::e2t_train_route(C1, C2, k))
    return launch_rowwarp<true>(idx, a1, b1, s1, t1, w2, amax, amin, asum,
                                asumsq, B, N, C1, C2, k, slope, st);
  return launch_tiled<true>(idx, a1, b1, s1, t1, w2, amax, amin, asum,
                            asumsq, B, N, C1, C2, k, slope, st);
}

// The row-warp route at any shape dg_edge2_fwd takes (the checks hold the
// tiled route against it); the same arguments.
extern "C" int dg_edge2_fwd_rowwarp(const int* idx, const float* a1,
                                    const float* b1, const float* s1,
                                    const float* t1, const float* w2,
                                    float* amax, float* amin, float* asum,
                                    float* asumsq, int B, int N, int C1,
                                    int C2, int k, float slope,
                                    void* stream) {
  if (!valid(B, N, C1, C2, k)) return (int)cudaErrorInvalidValue;
  return launch_rowwarp<false>(idx, a1, b1, s1, t1, w2, amax, amin, asum,
                               asumsq, B, N, C1, C2, k, slope,
                               (cudaStream_t)stream);
}

// As dg_edge2_fwd_amp on the row-warp route at any shape.
extern "C" int dg_edge2_fwd_amp_rowwarp(const int* idx, const float* a1,
                                        const float* b1, const float* s1,
                                        const float* t1, const float* w2,
                                        float* amax, float* amin, float* asum,
                                        float* asumsq, int B, int N, int C1,
                                        int C2, int k, float slope,
                                        void* stream) {
  if (!valid(B, N, C1, C2, k)) return (int)cudaErrorInvalidValue;
  return launch_rowwarp<true>(idx, a1, b1, s1, t1, w2, amax, amin, asum,
                              asumsq, B, N, C1, C2, k, slope,
                              (cudaStream_t)stream);
}
