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
// Design, two routes decided from the shape before the launch:
//   C1, C2 <= 64 and multiples of 4, k <= 128 (every model: C1 = C2 = 64,
//   k = 20 or 40)  edge2_bwd_tiled_kernel.  A tile is R = min(8, 128 / k)
//   whole centre rows, R * k <= 128 edges (120 at k = 20 and 40), so each
//   row's tie counts need nothing outside its tile.  A block of 256
//   threads stages the tile's h1 (E x C1, e2_h1_row's operations) and w2
//   and w2^T in shared memory, then computes three register-blocked
//   products: z2 = h1 w2 once (edge2_tile.cuh's block, shared with kernels
//   6 and 7: 8 edges x 4 channels a thread, each element one fmaf chain
//   over c1 ascending from 0: e2_z2's bits), kept in shared
//   memory, where the tie counts and dz2 are formed from it; dh1 = dz2
//   w2^T (fmaf over c2 ascending from 0, as the row-warp form); and dW2 +=
//   h1^T dz2 into a 4 x 4 block partial in each thread's registers across
//   the block's tiles.  db1 sums each row's dsel over t ascending with the
//   row-warp form's _rn adds (bit-equal to it), ds1 and dt1 are per-thread
//   partials over fixed edges added up in a fixed order.  Eight block
//   barriers a tile, where the row-warp form took two an edge.  The
//   elementwise phases (h1, the tie counts, dz2, db1) give a thread one
//   channel of every fourth edge, so no index divides by C1, C2 or k on
//   their path, and the tile's b1 rows, s1 and t1 sit in shared memory:
//   with the gathers' divisions and reloads these phases took ~0.9 ms of
//   4.15 a semseg call (PERF.md, Findings).
//   Any other shape  edge2_bwd_rowwarp_kernel: one warp per centre row, QB
//   = 8 rows a block.  Pass 1 walks the k edges and counts the ties; pass
//   2 walks them again: each warp forms its edge's h1 and dz2 rows in
//   shared memory, its lanes form dh1 for their first-conv channels (w2
//   read by rows of its padded copy), add db1 in registers and da1 into
//   the neighbour's row; then the whole block adds the QB
//   edges' outer products h1^T dz2 into its dW2 partial in shared memory.
// Both routes use a grid of a few blocks per SM that strides over the tiles
// or row groups.  At the end each block writes its dW2, ds1 and dt1
// partials, and a second launch sums them over the blocks in a fixed
// order: dW2, ds1 and dt1 carry no atomics and come out the same from run
// to run.  da1, two forms on either route (a template flag):
//   pull (dg_edge2_bwd_pull, the kernel's): each edge's addend dsel is
//     stored, (B * N * k, C1) f32 (~0.67 GB at semseg's B=32, N=4096, k=20,
//     C1=64), and reverse_lists.cu sums each point's row over its list of
//     in-edges in ascending edge id, from zero: no float atomic, the same
//     bits from run to run (~2 x 0.67 GB more traffic than the atomics:
//     ~0.4 ms at 3.35 TB/s).
//   atomic (dg_edge2_bwd, the oracle): each dsel is added into the
//     neighbour's row by an f32 atomicAdd, in an order that changes from
//     run to run; the caller zeroes da1.
//
// The AMP form (dg_edge2_bwd_pull_amp), the JAX package's default in
// training (_edge2_bwd_kernel with exact=False, pallas_knn.py:1200-1285),
// on either route (the row-warp one at k > 128 and the other shapes the
// tiled one does not take), pull form only: sel is a1's value rounded to
// bf16 (to nearest even; _parts(a1, False), :1217), staged into h1 with
// edge2_reduce.cu's AMP rounding, so z2 and the ties are its bits; each
// edge's dsel is rounded to bf16 before it is stored for the da1 sum
// (:1282-1283, the bf16 operand of the scatter product); db1, dW2, ds1 and
// dt1 are the f32 sums of the exact form, on the rounded sel.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"
#include "edge2_tile.cuh"
#include "reverse_lists.cuh"

namespace {

using dg::E2_CPL;
using dg::E2_MAXC;

constexpr int QB = 8;  // rows (warps) per block of the row-warp route
constexpr int THREADS = QB * 32;

// AMP: sel is a1's value rounded to bf16 (e2_h1_row<true> stages h1 with
// edge2_reduce.cu's rounding) and each stored dsel is rounded to bf16.
template <bool PULL, bool AMP>
__global__ void __launch_bounds__(THREADS, 1)
    edge2_bwd_rowwarp_kernel(const int* __restrict__ idx,
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
                     float* __restrict__ part, float* __restrict__ dsel_e) {
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
      dg::e2_h1_row<AMP>(a1 + base + (size_t)irow[t] * C1, ctr, slope, C1,
                         lane, hrow);
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
      dg::e2_h1_row<AMP>(a1 + j, ctr, slope, C1, lane, hrow);
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
          const float av = a1[j + c];
          const float sel = __fadd_rn(AMP ? dg::e2_round_bf16(av) : av,
                                      ctr.b[u]);
          const float z1 = __fadd_rn(__fmul_rn(sel, ctr.s[u]), ctr.t[u]);
          const float dz1 = z1 >= 0.f ? dh : __fmul_rn(dh, slope);
          ds1[u] = __fadd_rn(ds1[u], __fmul_rn(dz1, sel));
          dt1[u] = __fadd_rn(dt1[u], dz1);
          const float dsel = __fmul_rn(dz1, ctr.s[u]);
          db[u] = __fadd_rn(db[u], dsel);
          if constexpr (PULL)
            dsel_e[(rr * k + t) * C1 + c] =
                AMP ? dg::e2_round_bf16(dsel) : dsel;
          else
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

// ---------------------------------------------------------------- tiled
using dg::comp;
using dg::ld4;
constexpr int TT = dg::E2T_THREADS;  // threads a block of the tiled route
constexpr int TE = dg::E2T_EDGES;    // edge slots a tile
constexpr int TR = dg::E2T_ROWS;     // the most rows a tile
constexpr int TC = dg::E2T_C1;       // C1, C2 <= TC; row stride of h1 and z
constexpr size_t TSMEM =
    sizeof(float) * (2 * TC * TC + 2 * TE * TC + 7 * TR * TC + 2 * TC) +
    sizeof(int) * 2 * TE;

template <bool PULL, bool AMP>
__global__ void __launch_bounds__(TT, 2)
    edge2_bwd_tiled_kernel(const int* __restrict__ idx,
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
                           const float* __restrict__ ct_sumsq, int rows,
                           int N, int k, float* __restrict__ da1,
                           float* __restrict__ db1,
                           float* __restrict__ part,
                           float* __restrict__ dsel_e) {
  extern __shared__ __align__(16) float tsm[];
  float* w2s = tsm;               // w2 (C1, C2), row stride C2
  float* w2t = w2s + TC * TC;     // w2^T (C2, C1), row stride C1
  float* hb = w2t + TC * TC;      // h1 of the tile's edges, then dsel
  float* zb = hb + TE * TC;       // z2 of the tile's edges, then dz2
  float* vmax = zb + TE * TC;     // (R, C2) each: the row's max and min,
  float* vmin = vmax + TR * TC;   // the max/min cotangents over the tie
  float* gmax = vmin + TR * TC;   // counts, ct_sum and 2 ct_sumsq
  float* gmin = gmax + TR * TC;
  float* gsum = gmin + TR * TC;
  float* gsq2 = gsum + TR * TC;
  float* b1s = gsq2 + TR * TC;    // (R, C1): the rows' b1
  float* s1s = b1s + TR * TC;     // s1, t1
  float* t1s = s1s + TC;
  int* jrow = reinterpret_cast<int*>(t1s + TC);  // a1 row of an edge, or -1
  int* eloc = jrow + TE;                         // its row in the tile

  // the elementwise phases give thread tid channel cl of edges eb + 4 m
  // (rows of 64 channels: no division by C1, C2 or k on their path)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cl = tid & (TC - 1), eb = tid / TC;
  for (int e = tid; e < C1 * C2; e += TT) {
    const int r = e / C2, c = e - r * C2;
    w2s[e] = w2[e];
    w2t[c * C1 + r] = w2[e];
  }
  if (tid < TC) {
    s1s[tid] = tid < C1 ? s1[tid] : 0.f;
    t1s[tid] = tid < C1 ? t1[tid] : 0.f;
  }
  const int R = dg::e2t_rows(k), E = R * k;
  const int tiles = (rows + R - 1) / R;
  float pw[4][4], ds1p[4], dt1p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ds1p[i] = dt1p[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) pw[i][j] = 0.f;
  }

  for (int g = blockIdx.x; g < tiles; g += gridDim.x) {
    const int row0 = g * R;
    __syncthreads();  // the previous tile's reads of hb, zb and jrow are done
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
      const bool in = row < rows && c < C2;
      const size_t o = (size_t)row * C2 + c;
      vmax[q] = in ? amax[o] : 0.f;
      vmin[q] = in ? amin[o] : 0.f;
      gmax[q] = in ? ct_max[o] : 0.f;  // divided by the counts below
      gmin[q] = in ? ct_min[o] : 0.f;
      gsum[q] = in ? ct_sum[o] : 0.f;
      gsq2[q] = in ? __fmul_rn(2.f, ct_sumsq[o]) : 0.f;
      b1s[q] = row < rows && c < C1 ? b1[(size_t)row * C1 + c] : 0.f;
    }
    __syncthreads();
    // h1 of every edge (e2_h1_row's operations); empty slots hold zeros
    dg::e2t_stage_h1<false, AMP>(a1, b1s, TC, jrow, eloc, s1s, t1s, C1,
                                 slope, hb);
    __syncthreads();

    // z2 = h1 w2: edges ty + 16 m, second-conv channels 4 tx + i
    if (4 * tx < C2) {
      float acc[8][4];
      dg::e2t_z2_block(hb, w2s, C2, C1, 4 * tx, ty, acc);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        *reinterpret_cast<float4*>(zb + (ty + 16 * m) * TC + 4 * tx) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
    __syncthreads();
    // tie counts, t ascending, and the max/min cotangents over them
    for (int q = tid; q < R * TC; q += TT) {
      const int r = q / TC, c = q & (TC - 1);
      if (c >= C2) continue;
      const int sl = q;
      const float vx = vmax[sl], vn = vmin[sl];
      float cmax = 0.f, cmin = 0.f;
      for (int t = 0; t < k; ++t) {
        const float z = zb[(r * k + t) * TC + c];
        cmax += z == vx ? 1.f : 0.f;
        cmin += z == vn ? 1.f : 0.f;
      }
      const bool in = row0 + r < rows;
      gmax[sl] = in ? __fdiv_rn(gmax[sl], cmax) : 0.f;
      gmin[sl] = in ? __fdiv_rn(gmin[sl], cmin) : 0.f;
    }
    __syncthreads();
    // dz2 in place of z2; empty slots and rows past the end get zeros
    for (int e = eb; e < TE; e += TT / TC) {
      const int c = cl;
      if (c >= C2) continue;
      float dz = 0.f;
      if (jrow[e] >= 0) {
        const int sl = eloc[e] * TC + c;
        const float z = zb[e * TC + c];
        dz = __fadd_rn(__fadd_rn(__fadd_rn(z == vmax[sl] ? gmax[sl] : 0.f,
                                           z == vmin[sl] ? gmin[sl] : 0.f),
                                 gsum[sl]),
                       __fmul_rn(z, gsq2[sl]));
      }
      zb[e * TC + c] = dz;
    }
    __syncthreads();

    // dW2 += h1^T dz2: first-conv channels 4 ty + i, second 4 tx + j
    if (4 * ty < C1 && 4 * tx < C2) {
      for (int e = 0; e < E; ++e) {
        const float4 h = ld4(hb + e * TC + 4 * ty);
        const float4 d = ld4(zb + e * TC + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hv = comp(h, i);
          pw[i][0] = fmaf(hv, d.x, pw[i][0]);
          pw[i][1] = fmaf(hv, d.y, pw[i][1]);
          pw[i][2] = fmaf(hv, d.z, pw[i][2]);
          pw[i][3] = fmaf(hv, d.w, pw[i][3]);
        }
      }
    }
    // dh1 = dz2 w2^T: edges ty + 16 m, first-conv channels 4 tx + i
    float dh[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) dh[m][i] = 0.f;
    if (4 * tx < C1) {
      for (int c2 = 0; c2 < C2; c2 += 4) {
        float4 w[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          w[cc] = ld4(w2t + (c2 + cc) * C1 + 4 * tx);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 d = ld4(zb + (ty + 16 * m) * TC + c2);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float dv = comp(d, cc);
            dh[m][0] = fmaf(dv, w[cc].x, dh[m][0]);
            dh[m][1] = fmaf(dv, w[cc].y, dh[m][1]);
            dh[m][2] = fmaf(dv, w[cc].z, dh[m][2]);
            dh[m][3] = fmaf(dv, w[cc].w, dh[m][3]);
          }
        }
      }
    }
    __syncthreads();  // every read of h1 is done: dsel takes its place
    if (4 * tx < C1) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int e = ty + 16 * m;
        const int j = jrow[e];
        if (j < 0) continue;
        const float* brow = b1s + eloc[e] * TC;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * tx + i;
          if (c >= C1) continue;
          const float av = a1[(size_t)j * C1 + c];
          const float sel = __fadd_rn(AMP ? dg::e2_round_bf16(av) : av,
                                      brow[c]);
          const float z1 = __fadd_rn(__fmul_rn(sel, s1s[c]), t1s[c]);
          const float dz1 = z1 >= 0.f ? dh[m][i] : __fmul_rn(dh[m][i], slope);
          ds1p[i] = __fadd_rn(ds1p[i], __fmul_rn(dz1, sel));
          dt1p[i] = __fadd_rn(dt1p[i], dz1);
          const float dsel = __fmul_rn(dz1, s1s[c]);
          hb[e * TC + c] = dsel;
          if constexpr (PULL)  // edge (row0 + e / k, e % k): id row0 k + e
            dsel_e[((size_t)row0 * k + e) * C1 + c] =
                AMP ? dg::e2_round_bf16(dsel) : dsel;
          else
            atomicAdd(da1 + (size_t)j * C1 + c, dsel);
        }
      }
    }
    __syncthreads();
    // db1: each row's dsel summed over t ascending from 0
    for (int q = tid; q < R * TC; q += TT) {
      const int r = q / TC, c = q & (TC - 1);
      const int row = row0 + r;
      if (row >= rows || c >= C1) continue;
      float acc = 0.f;
      for (int t = 0; t < k; ++t)
        acc = __fadd_rn(acc, hb[(r * k + t) * TC + c]);
      db1[(size_t)row * C1 + c] = acc;
    }
  }

  // the block's partials: dW2 from the registers, ds1 and dt1 summed over
  // the 16 thread rows ty in ascending order
  const int width = C1 * C2 + 2 * C1;
  float* prow = part + (size_t)blockIdx.x * width;
  if (4 * ty < C1 && 4 * tx < C2) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(prow + (4 * ty + i) * C2 + 4 * tx) =
          make_float4(pw[i][0], pw[i][1], pw[i][2], pw[i][3]);
  }
  __syncthreads();  // the last tile's reads of hb are done
  float* red = hb;  // (16, 2 * TC): ty's ds1 | dt1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[ty * 2 * TC + 4 * tx + i] = ds1p[i];
    red[ty * 2 * TC + TC + 4 * tx + i] = dt1p[i];
  }
  __syncthreads();
  for (int e = tid; e < 2 * C1; e += TT) {
    const int col = e < C1 ? e : TC + e - C1;
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc = __fadd_rn(acc, red[y * 2 * TC + col]);
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

// The blocks of a launch: 1 <= G <= the tiles (B*N / tile_rows(k) on the
// tiled route, B*N / 8 on the row-warp route).
extern "C" int dg_edge2_bwd_tiles(int B, int N, int C1, int C2, int k) {
  const int R = dg::e2t_train_route(C1, C2, k) ? dg::e2t_rows(k) : QB;
  return (B * N + R - 1) / R;
}

namespace {

template <bool PULL, bool AMP = false>
int launch_bwd(const int* idx, const float* a1, const float* b1,
               const float* s1, const float* t1, const float* w2,
               const float* amax, const float* amin, const float* ct_max,
               const float* ct_min, const float* ct_sum,
               const float* ct_sumsq, float* da1, float* db1, float* part,
               float* dflat, float* dsel_e, int B, int N, int C1, int C2,
               int k, int G, float slope, cudaStream_t st) {
  const int rows = B * N;
  cudaError_t e;
  if (dg::e2t_train_route(C1, C2, k)) {
    e = cudaFuncSetAttribute(edge2_bwd_tiled_kernel<PULL, AMP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TSMEM);
    if (e != cudaSuccess) return (int)e;
    edge2_bwd_tiled_kernel<PULL, AMP><<<G, TT, TSMEM, st>>>(
        idx, a1, b1, C1, s1, t1, w2, C2, slope, amax, amin, ct_max, ct_min,
        ct_sum, ct_sumsq, rows, N, k, da1, db1, part, dsel_e);
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)C1 * dg::e2_ldw(C2) + (size_t)C1 * C2 +
                         (size_t)QB * (C1 + C2) + (size_t)QB * 2 * C1);
    e = cudaFuncSetAttribute(edge2_bwd_rowwarp_kernel<PULL, AMP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    edge2_bwd_rowwarp_kernel<PULL, AMP><<<G, THREADS, smem, st>>>(
        idx, a1, b1, C1, s1, t1, w2, C2, slope, amax, amin, ct_max, ct_min,
        ct_sum, ct_sumsq, rows, N, k, da1, db1, part, dsel_e);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = C1 * C2 + 2 * C1;
  partial_sum_kernel<<<(width + 255) / 256, 256, 0, st>>>(part, G, width,
                                                          dflat);
  return (int)cudaGetLastError();
}

bool valid_bwd(int B, int N, int C1, int C2, int k, int G) {
  return B >= 1 && N >= 1 && C1 >= 1 && C1 <= E2_MAXC && C2 >= 1 &&
         C2 <= E2_MAXC && k >= 1 && k <= N && G >= 1 &&
         G <= dg_edge2_bwd_tiles(B, N, C1, C2, k);
}

}  // namespace

// idx (B, N, k) int32; a1/b1 (B, N, C1), s1/t1 (C1,), w2 (C1, C2), amax/amin
// and the cotangents ct_* (B, N, C2) f32; out da1 (B, N, C1) zeroed by the
// caller, db1 (B, N, C1), dflat (C1*C2 + 2*C1,) = [dW2 | ds1 | dt1]; scratch
// part (G, C1*C2 + 2*C1) for G blocks, 1 <= G <= dg_edge2_bwd_tiles; all
// f32 unless said, contiguous, on the device.  C1, C2 <= 64 (multiples of
// 4) and k <= 128 take the tiled route, other shapes the row-warp route.
// da1 is added by f32 atomics (the oracle of the pull form).  Returns the
// first CUDA error.
extern "C" int dg_edge2_bwd(const int* idx, const float* a1, const float* b1,
                            const float* s1, const float* t1, const float* w2,
                            const float* amax, const float* amin,
                            const float* ct_max, const float* ct_min,
                            const float* ct_sum, const float* ct_sumsq,
                            float* da1, float* db1, float* part, float* dflat,
                            int B, int N, int C1, int C2, int k, int G,
                            float slope, void* stream) {
  if (!valid_bwd(B, N, C1, C2, k, G)) return (int)cudaErrorInvalidValue;
  return launch_bwd<false>(idx, a1, b1, s1, t1, w2, amax, amin, ct_max,
                           ct_min, ct_sum, ct_sumsq, da1, db1, part, dflat,
                           nullptr, B, N, C1, C2, k, G, slope,
                           (cudaStream_t)stream);
}

namespace {

template <bool AMP>
int pull(const int* idx, const float* a1, const float* b1, const float* s1,
         const float* t1, const float* w2, const float* amax,
         const float* amin, const float* ct_max, const float* ct_min,
         const float* ct_sum, const float* ct_sumsq, float* da1, float* db1,
         float* part, float* dflat, float* dsel_e, int* iscratch, int B,
         int N, int C1, int C2, int k, int G, float slope, cudaStream_t st) {
  if (!valid_bwd(B, N, C1, C2, k, G)) return (int)cudaErrorInvalidValue;
  const int *off, *lst;
  cudaError_t e = dg::build_reverse_lists(idx, B, N, k, iscratch, &off,
                                          &lst, st);
  if (e != cudaSuccess) return (int)e;
  const int rc = launch_bwd<true, AMP>(idx, a1, b1, s1, t1, w2, amax, amin,
                                       ct_max, ct_min, ct_sum, ct_sumsq, da1,
                                       db1, part, dflat, dsel_e, B, N, C1,
                                       C2, k, G, slope, st);
  if (rc) return rc;
  return (int)dg::launch_pull_sum(off, lst, dsel_e, B * N, C1, da1, st);
}

}  // namespace

// As dg_edge2_bwd with da1 in the pull form: every element of da1 written
// (the caller need not zero it), the same bits from run to run; scratch
// dsel_e (B * N * k * C1 floats) and iscratch (dg_reverse_list_ints(B, N,
// k) ints).
extern "C" int dg_edge2_bwd_pull(
    const int* idx, const float* a1, const float* b1, const float* s1,
    const float* t1, const float* w2, const float* amax, const float* amin,
    const float* ct_max, const float* ct_min, const float* ct_sum,
    const float* ct_sumsq, float* da1, float* db1, float* part, float* dflat,
    float* dsel_e, int* iscratch, int B, int N, int C1, int C2, int k, int G,
    float slope, void* stream) {
  return pull<false>(idx, a1, b1, s1, t1, w2, amax, amin, ct_max, ct_min,
                     ct_sum, ct_sumsq, da1, db1, part, dflat, dsel_e,
                     iscratch, B, N, C1, C2, k, G, slope,
                     (cudaStream_t)stream);
}

// The AMP form of dg_edge2_bwd_pull (the note): the same arguments and
// routes.
extern "C" int dg_edge2_bwd_pull_amp(
    const int* idx, const float* a1, const float* b1, const float* s1,
    const float* t1, const float* w2, const float* amax, const float* amin,
    const float* ct_max, const float* ct_min, const float* ct_sum,
    const float* ct_sumsq, float* da1, float* db1, float* part, float* dflat,
    float* dsel_e, int* iscratch, int B, int N, int C1, int C2, int k, int G,
    float slope, void* stream) {
  return pull<true>(idx, a1, b1, s1, t1, w2, amax, amin, ct_max, ct_min,
                    ct_sum, ct_sumsq, da1, db1, part, dflat, dsel_e,
                    iscratch, B, N, C1, C2, k, G, slope,
                    (cudaStream_t)stream);
}
