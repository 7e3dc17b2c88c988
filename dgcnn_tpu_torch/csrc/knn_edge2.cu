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
//   query row with its N scores in registers and k rounds of warp
//   arg-max), with each winner consumed at once: the lanes write the
//   edge's h1 row into the warp's row of shared memory (edge2.cuh), then
//   each lane forms its second-conv channels as f32 dot products against
//   w2 in shared memory and folds them into a running max.  Each w2 value
//   read from shared memory feeds one FMA.
// Both routes pick the neighbours in torch.topk's order, compute each
// edge's z2 and h2 with the same operations and take the max over the
// edges in that order: their outputs are the same bits.  Neither the (B,
// N, k, C1) hidden tensor nor idx reaches device memory.
//
// The row-warp kernel serves kernel 13, dgcnn_tpu/ops/pallas_banded.py::
// banded_knn_edge2 (the --fast_extract path): on a cloud in its PC1-sorted
// order each query tile's candidates are a window of `band` sorted rows
// (see knn_edge2_kernel), so the staging, the scores and the arg-max
// rounds shrink by N / band; the per-edge arithmetic is unchanged.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"
#include "edge2_tile.cuh"
#include "knn_select.cuh"

namespace {

using dg::E2_CPL;
using dg::E2_MAXC;

// Query rows (warps) per block: from 64 scores a lane up, 8 warps, so that
// a thread may keep the scores and the per-edge state in up to 255
// registers without spilling.
template <int NPL>
struct E2Block {
  static constexpr int QB = NPL >= 64 ? 8 : dg::Bucket<NPL>::QB;
};

// The candidates of query row i are the W rows [start, start + W) of its
// cloud: start = 0 and W = N for the exact block; for the banded block the
// cloud is in its PC1-sorted order, start is the window start of i's query
// tile (starts[(block's first row) / tile]) and W the band.  The window
// holds every row of its tile, so the query row is one of the staged rows,
// and a window-local winner j is row start + j of a1.
template <int NPL>
__global__ void __launch_bounds__(E2Block<NPL>::QB * 32)
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
  constexpr int QB = E2Block<NPL>::QB;
  extern __shared__ float smem[];
  float* sg = smem;                                          // graph stage
  float* ws = sg + dg::select_smem_bytes<NPL>(W) / sizeof(float);  // w2
  float* hb = ws + C1 * dg::e2_ldw(C2);                      // QB h1 rows
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const int start = starts ? starts[blockIdx.x * QB / tile] : 0;
  // row_scores synchronises the block before its first read of shared
  // memory and after its first write, which covers w2 too
  dg::e2_stage_w2(w2, C1, C2, ws);
  float s[NPL];
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
using dg::comp;
using dg::ld4;
constexpr int XE = dg::E2T_EDGES;  // edge slots a tile
constexpr int XR = dg::E2T_ROWS;   // the most rows a tile
constexpr int XC1 = dg::E2T_C1;    // C1 <= XC1: the row stride of h1
static_assert(dg::TS_THREADS == dg::E2T_THREADS,
              "the consumer stages h1 and z2 with edge2_tile.cuh's block");
constexpr int XC2 = 128;  // C2 <= XC2
constexpr int XP = 64;    // second-conv channels a pass: the row stride of y
constexpr size_t XSMEM_CONSUME =
    sizeof(float) * (XE * XC1 + XE * XP + XC1 * XC2 + 2 * XC1 + 2 * XC2) +
    sizeof(int) * 2 * XE;
constexpr size_t XSMEM_BYTES = XSMEM_CONSUME > dg::TS_SMEM_BYTES
                                   ? XSMEM_CONSUME
                                   : dg::TS_SMEM_BYTES;

bool tiled_route(int C1, int C2, int k) {
  return k <= dg::TS_LIST && C1 <= XC1 && C2 <= XC2;
}

// The tiled route: the block's 64 rows' lists (tiled_topk), then their
// edges in tiles of R = min(XR, XE / k) whole rows.  C1 and C2 are padded
// to multiples of 4 in shared memory with zeros, which add nothing to a
// z2 chain (a chain that starts at +0 never holds -0).
template <int KL>
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
                           int k, float* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL>(graph + (size_t)b * N * Cg, Cg, sq + (size_t)b * N, N,
                     r0, k, tsm, ls, li);

  float* hb = tsm;              // h1 of the tile's edges (XE, XC1)
  float* yb = hb + XE * XC1;    // h2 of one pass (XE, XP)
  float* w2s = yb + XE * XP;    // w2 (C1p, ldw)
  float* s1s = w2s + XC1 * XC2;  // s1, t1 (XC1); s2, t2 (XC2)
  float* t1s = s1s + XC1;
  float* s2s = t1s + XC1;
  float* t2s = s2s + XC2;
  int* jrow = reinterpret_cast<int*>(t2s + XC2);  // a1 row of an edge, or -1
  int* eloc = jrow + XE;                          // its row in the tile
  const int C1p = (C1 + 3) & ~3, ldw = (C2 + 3) & ~3;
  __syncthreads();  // every warp is done with the selection's shared memory
  for (int e = tid; e < C1p * ldw; e += dg::TS_THREADS) {
    const int r = e / ldw, c = e - r * ldw;
    w2s[e] = r < C1 && c < C2 ? w2[r * C2 + c] : 0.f;
  }
  if (tid < XC1) {
    s1s[tid] = tid < C1 ? s1[tid] : 0.f;
    t1s[tid] = tid < C1 ? t1[tid] : 0.f;
  }
  if (tid < XC2) {
    s2s[tid] = tid < C2 ? s2[tid] : 0.f;
    t2s[tid] = tid < C2 ? t2[tid] : 0.f;
  }
  const int R = dg::e2t_rows(k);
  const float* A = a1 + (size_t)b * N * C1;
  // the products give thread (tx, ty) edges ty + 16 m and channels 4 tx + i
  const int tx = tid & 15, ty = tid >> 4;

  for (int rt = 0; rt < dg::TS_R; rt += R) {
    const int nr = min(R, dg::TS_R - rt);  // rows r0 + rt .. of this tile
    // each warp writes the lists of its rows that fall in the tile; the
    // previous tile read jrow and eloc before two barriers
#pragma unroll
    for (int rr = 0; rr < dg::TS_WR; ++rr) {
      const int r = dg::TS_WR * warp + rr - rt;
      if (r >= 0 && r < nr) {
#pragma unroll
        for (int q = 0; q < KL; ++q) {
          const int t = lane + 32 * q;
          if (t < k) {
            jrow[r * k + t] = li[rr][q];
            eloc[r * k + t] = r;
          }
        }
      }
    }
    for (int e = nr * k + tid; e < XE; e += dg::TS_THREADS) jrow[e] = -1;
    __syncthreads();
    // h1 of every edge (e2_h1_row's operations); empty slots hold zeros
    dg::e2t_stage_h1(A, b1 + ((size_t)b * N + r0 + rt) * C1, C1, jrow, eloc,
                     s1s, t1s, C1, slope, hb);
    __syncthreads();
    for (int p0 = 0; p0 < C2; p0 += XP) {
      const int c0 = p0 + 4 * tx;
      const bool active = c0 < ldw;
      float acc[8][4];
      if (active) dg::e2t_z2_block(hb, w2s, ldw, C1p, c0, ty, acc);
      __syncthreads();  // the previous pass's (or tile's) reads of yb are done
      if (active) {
        float sc[4], tc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i] = s2s[c0 + i];
          tc[i] = t2s[c0 + i];
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          float y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = dg::e2_lrelu(__fadd_rn(__fmul_rn(acc[m][i], sc[i]), tc[i]),
                                slope);
          *reinterpret_cast<float4*>(yb + (ty + 16 * m) * XP + 4 * tx) =
              make_float4(y[0], y[1], y[2], y[3]);
        }
      }
      __syncthreads();
      // the max over each row's edges, t ascending: the row-warp order
      for (int q = tid; q < nr * XP; q += dg::TS_THREADS) {
        const int r = q / XP, c = q - r * XP;
        if (p0 + c < C2) {
          float mx = -INFINITY;
          for (int t = 0; t < k; ++t)
            mx = fmaxf(mx, yb[(r * k + t) * XP + c]);
          out[((size_t)b * N + r0 + rt + r) * C2 + p0 + c] = mx;
        }
      }
    }
  }
}

template <int KL>
cudaError_t launch_tiled(const float* graph, const float* a1,
                         const float* b1, const float* w2, const float* s1,
                         const float* t1, const float* s2, const float* t2,
                         const float* sq, float* out, int B, int N, int Cg,
                         int C1, int C2, int k, float slope,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_edge2_tiled_kernel<KL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)XSMEM_BYTES);
  if (err != cudaSuccess) return err;
  knn_edge2_tiled_kernel<KL>
      <<<dim3(N / dg::TS_R, B), dg::TS_THREADS, XSMEM_BYTES, st>>>(
          graph, Cg, sq, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope, N, k,
          out);
  return cudaGetLastError();
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
  return dg::with_npl(W, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    constexpr int QB = E2Block<NPL>::QB;
    const size_t smem =
        dg::select_smem_bytes<NPL>(W) +
        sizeof(float) * ((size_t)C1 * dg::e2_ldw(C2) + (size_t)QB * C1);
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
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return (int)e;
  if (k <= 32)
    return (int)launch_tiled<1>(graph, a1, b1, w2, s1, t1, s2, t2, sq, out,
                                B, N, Cg, C1, C2, k, slope, st);
  return (int)launch_tiled<2>(graph, a1, b1, w2, s1, t1, s2, t2, sq, out, B,
                              N, Cg, C1, C2, k, slope, st);
}

// Kernel 13, banded_knn_edge2: the same block on a cloud in its PC1-sorted
// order, the candidates of each query tile of `tile` rows the `band` rows
// from starts[tile index] (the sort, the window starts and the un-sort are
// the caller's).  starts (N / tile,) int32 on the device; the other
// arguments as above.  Returns the first CUDA error.
extern "C" int dg_banded_knn_edge2(const float* graph, const float* a1,
                                   const float* b1, const float* w2,
                                   const float* s1, const float* t1,
                                   const float* s2, const float* t2,
                                   const int* starts, float* sq, float* out,
                                   int B, int N, int Cg, int C1, int C2,
                                   int k, int tile, int band, float slope,
                                   void* stream) {
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || band % 128 != 0 ||
      band < 128 || band > N || tile % 128 != 0 || tile < 128 ||
      tile > band || N % tile != 0 || Cg < 1 || C1 < 1 || C1 > E2_MAXC ||
      C2 < 1 || C2 > E2_MAXC || k < 1 || k > band)
    return (int)cudaErrorInvalidValue;
  return (int)launch_block(graph, a1, b1, w2, s1, t1, s2, t2, sq, out, B, N,
                           Cg, C1, C2, k, slope, starts, tile, band,
                           (cudaStream_t)stream);
}
