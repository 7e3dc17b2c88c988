// edge2_reduce_tc: the AMP form of the training two-conv block's forward
// reductions (kernel 7) with its per-edge second conv on Hopper's tensor
// cores (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::_edge2_fwd_call
// (body _edge2_train_kernel) with exact=False (:1120-1161), the JAX
// package's default in training, at the shapes of edge2_tile.cuh's tiled
// route (C1, C2 <= 64 and multiples of 4, k <= 128: every model's).  With
// a1's selected rows rounded to bf16 (_parts(a1, False), :1131),
//
//   z2[i, t] = LReLU((bf16(a1[idx[i, t]]) + b1[i]) * s1 + t1) @ w2
//
// it writes max, min, sum and sum of squares over t of z2 (per channel, t
// ascending, fmaxf / fminf / _rn adds), as edge2_reduce.cu's AMP form
// does, z2 from edge2_tc.cuh's 3xTF32 tile (within a few f32 ulps of the
// f32 product).  edge2_bwd.cu's edge2_bwd_tc_kernel takes the ties from
// these max and min by edge2_tc.cuh's rule, which sends each max/min
// cotangent to the edges the plain f32 version does.
//
// Bound on an H100 SXM: bytes.  At the DGCNNSemSeg training shapes (B=32,
// N=4096, k=20, C1 = C2 = 64) idx, a1 and b1 in and the four reductions
// out are ~0.21 GB, ~0.06 ms at 3.35 TB/s; the second conv's 21.5 GFLOP
// are ~0.04 ms at TF32's 495 TFLOP/s (three MMAs a product: ~0.13 ms of
// tensor-core time), ~0.32 at the f32 CUDA-core peak.
//
// Design: a grid of two blocks of 8 warps an SM strides over the tiles.
// A tile's a1 rows (its edges' neighbours, 16 bytes a cp.async into the
// swizzled tile) and its rows' b1 are gathered asynchronously into one of
// two buffers while the block works on the other: TMA cannot gather
// arbitrary rows on sm_90.  On arrival the tile's h1 is formed in place
// (e2_h1_row<true>'s operations), z2 = h1 w2 on the tensor cores
// (edge2_tc.cuh's z2_tile: each warp a 32 x 32 block, k8 steps of three
// MMAs, w2 split into its TF32 hi and lo once a block) takes its place,
// and one thread a (row, channel) forms the four reductions over the row's
// k edges in t order.  Shared memory: w2's two halves 32 KB, two tiles 64
// KB, two b1 blocks 4 KB.  No atomics: the same bits from run to run.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2_tc.cuh"

namespace {

using dg_e2tc::at;
using dg_e2tc::C;
using dg_e2tc::EDGES;
using dg_e2tc::ROWS;

constexpr int THREADS = 256;     // 8 warps a block, two blocks an SM
constexpr int TILE = EDGES * C;  // floats a tile buffer
constexpr int PER = EDGES / (THREADS / 16);  // edges a thread stages
constexpr size_t SMEM = sizeof(float) * (2 * C * C + 2 * TILE +
                                         2 * ROWS * C + 2 * C) +
                        sizeof(int) * EDGES;

// Starts the gather of tile g into buf (a1 rows, swizzled; zeros on empty
// slots and past C1) and b1s (its rows' b1, row stride C), one commit
// group.  Thread tid copies the quad (tid % 16) of edges (tid / 16) + 16 u;
// erow: each edge slot's row in a tile.
__device__ __forceinline__ void gather_tile(int g,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ a1,
                                            const float* __restrict__ b1,
                                            int C1, int rows, int N, int k,
                                            int R, const int* erow,
                                            float* buf, float* b1s) {
  const int row0 = g * R, E = R * k, c = (threadIdx.x & 15) * 4;
  // the a1 rows of the thread's edges first, every load in flight at once
  int j[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = (threadIdx.x >> 4) + 16 * u, r = erow[e], row = row0 + r;
    j[u] = e < E && row < rows && c < C1
               ? (row / N) * N + idx[(size_t)row * k + e - r * k]
               : -1;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = (threadIdx.x >> 4) + 16 * u;
    dg_attn::copy16(buf + at(e, c), j[u] >= 0 ? a1 + (size_t)j[u] * C1 + c
                                              : a1,
                    j[u] >= 0);
  }
  for (int q = threadIdx.x; q < ROWS * (C / 4); q += THREADS) {
    const int r = q >> 4, c = (q & 15) * 4, row = row0 + r;
    const bool in = r < R && row < rows && c < C1;
    dg_attn::copy16(b1s + r * C + c, in ? b1 + (size_t)row * C1 + c : b1,
                    in);
  }
  dg_attn::commit();
}

__global__ void __launch_bounds__(THREADS, 2)
    edge2_fwd_tc_kernel(const int* __restrict__ idx,
                        const float* __restrict__ a1,
                        const float* __restrict__ b1, int C1,
                        const float* __restrict__ s1,
                        const float* __restrict__ t1,
                        const float* __restrict__ w2, int C2, float slope,
                        int rows, int N, int k, float* __restrict__ amax,
                        float* __restrict__ amin, float* __restrict__ asum,
                        float* __restrict__ asumsq) {
  extern __shared__ __align__(16) float smem[];
  unsigned* w2h = reinterpret_cast<unsigned*>(smem);  // w2's TF32 hi, lo
  unsigned* w2l = w2h + C * C;
  float* bufs = smem + 2 * C * C;   // two tiles: a1 rows, h1, then z2
  float* b1b = bufs + 2 * TILE;     // two (ROWS, C) blocks of b1
  float* s1s = b1b + 2 * ROWS * C;  // s1, t1 (zeros past C1)
  float* t1s = s1s + C;
  int* erow = reinterpret_cast<int*>(t1s + C);  // an edge slot's row
  const int tid = threadIdx.x;
  const int R = dg::e2t_rows(k), tiles = (rows + R - 1) / R;
  // the staging's fixed quad of channels; its edges (tid >> 4) + 16 m
  const int cq = (tid & 15) * 4;
  for (int e = tid; e < EDGES; e += THREADS) erow[e] = e / k;
  __syncthreads();
  if (blockIdx.x < tiles)
    gather_tile(blockIdx.x, idx, a1, b1, C1, rows, N, k, R, erow, bufs, b1b);
  dg_e2tc::stage_w2_split(w2, C1, C2, w2h, w2l);
  if (tid < C) {
    s1s[tid] = tid < C1 ? s1[tid] : 0.f;
    t1s[tid] = tid < C1 ? t1[tid] : 0.f;
  }
  const dg_e2tc::WarpTile wt = dg_e2tc::warp_tile<2>();
  const auto load_b = [&](int n0, int k0) {
    return dg_e2tc::load_b_split<C>(w2h, w2l, n0, k0);
  };
  int cur = 0;
  for (int g = blockIdx.x; g < tiles; g += gridDim.x, cur ^= 1) {
    __syncthreads();  // the other buffer's last reads are done
    const int next = g + gridDim.x;
    if (next < tiles)
      gather_tile(next, idx, a1, b1, C1, rows, N, k, R, erow,
            bufs + (cur ^ 1) * TILE, b1b + (cur ^ 1) * ROWS * C);
    else
      dg_attn::commit();  // an empty group: this tile's is the older one
    dg_attn::wait_groups<1>();
    __syncthreads();
    float* hb = bufs + cur * TILE;
    const float* b1s = b1b + cur * ROWS * C;
    const int row0 = g * R, E = R * k;
    // h1 in place of the tile's a1 rows; zeros on empty slots, past C1
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = (tid >> 4) + 16 * m, r = erow[e];
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < E && row0 + r < rows && cq < C1)
        h = dg_e2tc::h1_quad(dg::ld4(hb + at(e, cq)), b1s + r * C, s1s, t1s,
                             cq, slope);
      *reinterpret_cast<float4*>(hb + at(e, cq)) = h;
    }
    __syncthreads();
    float acc[2][4][4];
    dg_e2tc::z2_tile<2>(hb, load_b, C1, wt, acc);
    __syncthreads();  // every read of h1 is done: z2 takes its place
    dg_e2tc::store_tile<2>(hb, wt, acc);
    __syncthreads();
    // the four reductions over each row's edges, t ascending
    for (int q = tid; q < R * C; q += THREADS) {
      const int r = q >> 6, c = q & (C - 1), row = row0 + r;
      if (c >= C2 || row >= rows) continue;
      float mx = -INFINITY, mn = INFINITY, sm = 0.f, s2 = 0.f;
      for (int t = 0; t < k; ++t) {
        const float z = hb[at(r * k + t, c)];
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
  dg_attn::wait_groups<0>();
}

}  // namespace

// The AMP form of dg_edge2_fwd on the tensor cores: idx (B, N, k) int32;
// a1/b1 (B, N, C1), s1/t1 (C1,), w2 (C1, C2) f32; out amax/amin/asum/
// asumsq (B, N, C2) f32; all contiguous, on the device, a1 and b1 16-byte
// aligned.  Only the tiled route's shapes (C1, C2 <= 64 and multiples of
// 4, k <= 128).  Returns the first CUDA error.
extern "C" int dg_edge2_fwd_amp_tc(const int* idx, const float* a1,
                                   const float* b1, const float* s1,
                                   const float* t1, const float* w2,
                                   float* amax, float* amin, float* asum,
                                   float* asumsq, int B, int N, int C1,
                                   int C2, int k, float slope,
                                   void* stream) {
  if (B < 1 || N < 1 || C1 < 1 || C2 < 1 || k < 1 || k > N ||
      !dg::e2t_train_route(C1, C2, k) || ((size_t)a1 | (size_t)b1) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(edge2_fwd_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const int rows = B * N, tiles = (rows + dg::e2t_rows(k) - 1) /
                                  dg::e2t_rows(k);
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;
  edge2_fwd_tc_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      idx, a1, b1, C1, s1, t1, w2, C2, slope, rows, N, k, amax, amin, asum,
      asumsq);
  return (int)cudaGetLastError();
}
