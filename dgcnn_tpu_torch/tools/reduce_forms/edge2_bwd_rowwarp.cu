// The earlier form of csrc/edge2_bwd.cu (one warp a centre row, z2
// recomputed in two passes, two block barriers an edge), not built into
// the library: tools/reduce_ab.py --kernel edge2_bwd times it against
// the kernel and holds the two to each other (PERF.md, Findings).
//
// edge2_bwd: the backward of edge2_reduce's four reductions on Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::_edge2_bwd_call
// (body _edge2_bwd_kernel), exact (f32) mode.  With z1, h1 and z2 of each
// edge (i, t) as in edge2.cuh, sel = a1[idx[i, t]], cmax_i / cmin_i the
// number of t with z2 == amax_i / amin_i (ties split the max/min cotangent
// evenly, as jax.lax.reduce_max's and torch.amax's gradients do):
//
//   dz2 = [z2 == amax] * ct_max / cmax + [z2 == amin] * ct_min / cmin
//         + ct_sum + z2 * (2 * ct_sumsq)
//   dh1 = dz2 @ w2^T,   dz1 = dh1 * (z1 >= 0 ? 1 : slope)
//   dW2 += h1^T dz2,  ds1 += dz1 * (sel + b1),  dt1 += dz1,
//   db1[i] += dz1 * s1,  da1[idx[i, t]] += dz1 * s1
//
// in that operation order.  amax/amin are edge2_reduce.cu's outputs: this
// kernel recomputes z2 with the same code (edge2.cuh), so the tie tests
// compare equal bits.
//
// Bound on an H100 SXM: operations.  At the DGCNNSemSeg training shapes
// (B=32, N=4096, k=20, C1 = C2 = 64) the z2 recomputation, dh1 and dW2 are
// three products of 2*B*N*k*C1*C2 flops, ~64 GFLOP a block, ~1.0 ms at the
// f32 CUDA-core peak, against ~0.3 GB of inputs and gradients, ~0.1 ms at
// 3.35 TB/s.
//
// Design: one warp per centre row, QB = 8 rows a block, and a grid of at
// most a few blocks per SM that strides over the row groups.  Pass 1 walks
// the k edges and counts the ties; pass 2 walks them again: each warp
// forms its edge's h1 and dz2 rows in shared memory, its lanes form dh1
// for their first-conv channels (w2 read by rows of its padded copy), add
// db1 in registers and da1 into the neighbour's row with f32 atomics (as
// edge_reduce_bwd.cu does: da1's last bits vary from run to run); then the
// whole block adds the QB edges' outer products h1^T dz2 into its dW2
// partial in shared memory, each thread owning fixed entries (no atomics).
// At the end each block writes its dW2, ds1 and dt1 partials, and a second
// launch sums them over the blocks in a fixed order: dW2, ds1 and dt1
// carry no atomics and come out the same from run to run.  The caller
// zeroes da1.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"

namespace {

using dg::E2_CPL;
using dg::E2_MAXC;

constexpr int QB = 8;  // rows (warps) per block
constexpr int THREADS = QB * 32;

__global__ void __launch_bounds__(THREADS, 1)
    edge2_bwd_kernel(const int* __restrict__ idx,
                     const float* __restrict__ a1,
                     const float* __restrict__ b1, int C1,
                     const float* __restrict__ s1,
                     const float* __restrict__ t1,
                     const float* __restrict__ w2, int C2, float slope,
                     const float* __restrict__ amax,
                     const float* __restrict__ amin,
                     const float* __restrict__ ct_max,
                     const float* __restrict__ ct_min,
                     const float* __restrict__ ct_sum,
                     const float* __restrict__ ct_sumsq, int rows, int N,
                     int k, float* __restrict__ da1, float* __restrict__ db1,
                     float* __restrict__ part) {
  extern __shared__ float smem[];
  const int ldw = dg::e2_ldw(C2);
  float* ws = smem;                 // w2, row stride ldw
  float* pw = ws + C1 * ldw;        // the block's dW2 partial (C1, C2)
  float* hb = pw + C1 * C2;         // QB h1 rows
  float* gb = hb + QB * C1;         // QB dz2 rows
  float* rb = gb + QB * C2;         // QB x [ds1 | dt1] at the end
  dg::e2_stage_w2(w2, C1, C2, ws);
  for (int e = threadIdx.x; e < C1 * C2; e += THREADS) pw[e] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* hrow = hb + warp * C1;
  float* grow = gb + warp * C2;
  float ds1[E2_CPL], dt1[E2_CPL];
#pragma unroll
  for (int u = 0; u < E2_CPL; ++u) ds1[u] = dt1[u] = 0.f;

  const int groups = (rows + QB - 1) / QB;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    // a warp past the last row computes on row 0 and adds nothing: it
    // still takes part in the block's barriers
    const size_t row = (size_t)g * QB + warp;
    const bool active = row < (size_t)rows;
    const size_t rr = active ? row : 0;
    const size_t base = (rr / N) * N * C1;  // the cloud's a1 / da1
    const int* irow = idx + rr * k;
    const dg::E2Centre ctr = dg::e2_centre(b1 + rr * C1, s1, t1, C1, lane);

    float vmax[E2_CPL], vmin[E2_CPL], cmax[E2_CPL], cmin[E2_CPL];
#pragma unroll
    for (int v = 0; v < E2_CPL; ++v) {
      const int c = lane + 32 * v;
      vmax[v] = c < C2 ? amax[rr * C2 + c] : 0.f;
      vmin[v] = c < C2 ? amin[rr * C2 + c] : 0.f;
      cmax[v] = 0.f;
      cmin[v] = 0.f;
    }
    // pass 1: tie counts
    for (int t = 0; t < k; ++t) {
      dg::e2_h1_row(a1 + base + (size_t)irow[t] * C1, ctr, slope, C1, lane,
                    hrow);
      __syncwarp();
#pragma unroll
      for (int v = 0; v < E2_CPL; ++v) {
        const int c = lane + 32 * v;
        if (c < C2) {
          const float z = dg::e2_z2(hrow, ws, C1, ldw, c);
          cmax[v] += z == vmax[v] ? 1.f : 0.f;
          cmin[v] += z == vmin[v] ? 1.f : 0.f;
        }
      }
      __syncwarp();
    }
    float gmax[E2_CPL], gmin[E2_CPL], gsum[E2_CPL], gsq2[E2_CPL];
#pragma unroll
    for (int v = 0; v < E2_CPL; ++v) {
      const int c = lane + 32 * v;
      const size_t o = rr * C2 + c;
      gmax[v] = c < C2 ? __fdiv_rn(ct_max[o], cmax[v]) : 0.f;
      gmin[v] = c < C2 ? __fdiv_rn(ct_min[o], cmin[v]) : 0.f;
      gsum[v] = c < C2 ? ct_sum[o] : 0.f;
      gsq2[v] = c < C2 ? __fmul_rn(2.f, ct_sumsq[o]) : 0.f;
    }

    // pass 2: per-edge cotangents
    float db[E2_CPL];
#pragma unroll
    for (int u = 0; u < E2_CPL; ++u) db[u] = 0.f;
    for (int t = 0; t < k; ++t) {
      const size_t j = base + (size_t)irow[t] * C1;
      dg::e2_h1_row(a1 + j, ctr, slope, C1, lane, hrow);
      __syncwarp();
#pragma unroll
      for (int v = 0; v < E2_CPL; ++v) {
        const int c = lane + 32 * v;
        if (c < C2) {
          const float z = dg::e2_z2(hrow, ws, C1, ldw, c);
          const float dz = __fadd_rn(
              __fadd_rn(__fadd_rn(z == vmax[v] ? gmax[v] : 0.f,
                                  z == vmin[v] ? gmin[v] : 0.f),
                        gsum[v]),
              __fmul_rn(z, gsq2[v]));
          grow[c] = active ? dz : 0.f;
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < E2_CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < C1 && active) {
          float dh = 0.f;
          for (int c2 = 0; c2 < C2; ++c2)
            dh = fmaf(grow[c2], ws[c * ldw + c2], dh);
          const float sel = __fadd_rn(a1[j + c], ctr.b[u]);
          const float z1 = __fadd_rn(__fmul_rn(sel, ctr.s[u]), ctr.t[u]);
          const float dz1 = z1 >= 0.f ? dh : __fmul_rn(dh, slope);
          ds1[u] = __fadd_rn(ds1[u], __fmul_rn(dz1, sel));
          dt1[u] = __fadd_rn(dt1[u], dz1);
          const float dsel = __fmul_rn(dz1, ctr.s[u]);
          db[u] = __fadd_rn(db[u], dsel);
          atomicAdd(da1 + j + c, dsel);
        }
      }
      __syncthreads();  // every warp's h1 and dz2 rows of this edge are set
      for (int e = threadIdx.x; e < C1 * C2; e += THREADS) {
        const int r = e / C2, c = e - r * C2;
        float acc = pw[e];
#pragma unroll
        for (int w = 0; w < QB; ++w)
          acc = fmaf(hb[w * C1 + r], gb[w * C2 + c], acc);
        pw[e] = acc;
      }
      __syncthreads();  // before the next edge overwrites them
    }
    if (active) {
#pragma unroll
      for (int u = 0; u < E2_CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < C1) db1[row * C1 + c] = db[u];
      }
    }
  }

#pragma unroll
  for (int u = 0; u < E2_CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < C1) {
      rb[warp * 2 * C1 + c] = ds1[u];
      rb[warp * 2 * C1 + C1 + c] = dt1[u];
    }
  }
  __syncthreads();
  const int width = C1 * C2 + 2 * C1;
  float* prow = part + (size_t)blockIdx.x * width;
  for (int e = threadIdx.x; e < C1 * C2; e += THREADS) prow[e] = pw[e];
  for (int e = threadIdx.x; e < 2 * C1; e += THREADS) {
    float acc = 0.f;
    for (int w = 0; w < QB; ++w) acc = __fadd_rn(acc, rb[w * 2 * C1 + e]);
    prow[C1 * C2 + e] = acc;
  }
}

// out[e] = sum over the G blocks' partial rows of part[g, e], g ascending.
__global__ void partial_sum_kernel(const float* __restrict__ part, int G,
                                   int width, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc = __fadd_rn(acc, part[(size_t)g * width + e]);
  out[e] = acc;
}

}  // namespace

// idx (B, N, k) int32; a1/b1 (B, N, C1), s1/t1 (C1,), w2 (C1, C2), amax/amin
// and the cotangents ct_* (B, N, C2) f32; out da1 (B, N, C1) zeroed by the
// caller, db1 (B, N, C1), dflat (C1*C2 + 2*C1,) = [dW2 | ds1 | dt1]; scratch
// part (G, C1*C2 + 2*C1) for G blocks, 1 <= G <= the B*N/8 row groups; all
// f32 unless said, contiguous, on the device.  Returns the first CUDA
// error.
extern "C" int dg_edge2_bwd(const int* idx, const float* a1, const float* b1,
                            const float* s1, const float* t1, const float* w2,
                            const float* amax, const float* amin,
                            const float* ct_max, const float* ct_min,
                            const float* ct_sum, const float* ct_sumsq,
                            float* da1, float* db1, float* part, float* dflat,
                            int B, int N, int C1, int C2, int k, int G,
                            float slope, void* stream) {
  const int rows = B * N;
  if (B < 1 || N < 1 || C1 < 1 || C1 > E2_MAXC || C2 < 1 || C2 > E2_MAXC ||
      k < 1 || k > N || G < 1 || G > (rows + QB - 1) / QB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem =
      sizeof(float) * ((size_t)C1 * dg::e2_ldw(C2) + (size_t)C1 * C2 +
                       (size_t)QB * (C1 + C2) + (size_t)QB * 2 * C1);
  cudaError_t e = cudaFuncSetAttribute(
      edge2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  edge2_bwd_kernel<<<G, THREADS, smem, st>>>(
      idx, a1, b1, C1, s1, t1, w2, C2, slope, amax, amin, ct_max, ct_min,
      ct_sum, ct_sumsq, rows, N, k, da1, db1, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = C1 * C2 + 2 * C1;
  partial_sum_kernel<<<(width + 255) / 256, 256, 0, st>>>(part, G, width,
                                                          dflat);
  return (int)cudaGetLastError();
}
