// edge_reduce_bwd: the backward of knn_reduce's four reductions on Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::edge_reduce_bwd
// (body _edge_reduce_bwd_kernel), exact (f32) mode.  With
// sel_t = a[idx[i, t]] per channel and cmax_i / cmin_i the number of t with
// sel_t == amax_i / amin_i (ties split the max/min cotangent evenly, as
// jax.lax.reduce_max's and torch.amax's gradients do):
//
//   w_t = [sel_t == amax_i] * ct_max_i / cmax_i + [sel_t == amin_i] *
//         ct_min_i / cmin_i + ct_sum_i + sel_t * (2 * ct_sumsq_i)
//   da[idx[i, t]] += w_t                  for every row i and t < k
//
// in that operation order (_rn intrinsics, no FMA contraction).  The ties
// are found by comparing a's rows with the forward's amax / amin, which
// knn_reduce.cu reads exactly from the same a.
//
// Bound on an H100 SXM: bytes.  At the DGCNNCls training shapes (B=32,
// N=1024, k=20, Co = 64 / 64 / 128 / 256) the kernel must read idx, a,
// amax, amin and four cotangents and write da: ~0.55 GB over the four
// stages, ~0.16 ms at 3.35 TB/s; its ~11 operations per (i, t, channel)
// take ~0.06 ms at 67 TFLOP/s.
//
// Three routes.  The pull route is the kernel's (dg_edge_reduce_bwd_pull,
// every shape the wrapper takes); the slices and atomic routes stay as
// oracles behind the wrapper's keywords.
//   pull  (no float atomic: da's bits are the same from run to run, and
//     those of an f32 scatter-add over the edges in ascending order).
//     reverse_lists.cu builds each point's list of in-edges e = i * k + t
//     in ascending e.  edge_reduce_bwd_addend_kernel is the atomic route
//     below with a store for its atomicAdd: a warp a row i counts the ties
//     and stores each edge's w_t as a row of Co floats (B N k Co floats:
//     ~0.67 GB at the DGCNNCls stage Co = 256, B=32).  Then the lists'
//     pull sum (reverse_lists.cu, kernel 8's) adds each point's rows in
//     list order from zero, a warp a point.  Two first forms recomputed
//     w_t in the pull instead of storing it (no per-edge buffer): a warp a
//     point reading row i's six values for each edge from device memory,
//     and the channel slices above with seven slices in shared memory.
//     Both were 2-5x slower than this one at the shapes of the models' own
//     graphs, and the second ran every point with many in-edges (a hub) in
//     each slice's block (PERF.md, Findings).
//   slices  (dg_edge_reduce_bwd; N <= 16384)
//   edge_reduce_bwd_slices_kernel.  Every part of the function is
//   independent per channel: the tie counts of (i, c), each w_t, and the
//   adds into da[:, c].  So a block takes one cloud b and CS consecutive
//   channels, CS the largest power of two up to 32 with N * CS <= 16384
//   (16 at N = 1024, 8 at 2048, 4 at 4096), and holds a[b, :, slice] and a
//   zeroed da slice in shared memory, N x CS f32 each: at most 128 KB, one
//   block of 1024 threads an SM.  A thread takes one (row i, channel c) at
//   a time, item q = i * CS + c, so a warp holds 32 / CS consecutive rows
//   of CS channels each: pass 1 reads idx[b, i, :] (from L1/L2, four
//   neighbours a 16-byte load where k % 4 == 0: the CS threads of a row
//   read the same words) and a_s[j, c] for each neighbour j and counts the
//   ties; pass 2 reads them again and adds each w_t, in the _rn order
//   above, into da_s[j, c] with a shared atomicAdd.  Then the block writes
//   its da slice once.  Each addend has the atomic form's bits; only the
//   order of the sum differs.  Device memory sees a, amax, amin, the
//   cotangents and da once (idx once a slice, from L2), and no global
//   atomic.  The layout [N][CS] (no padding) keeps the CS lanes of a row
//   on CS consecutive banks, so a gather or an add conflicts only where two
//   of a warp's 32 / CS rows pick neighbours equal mod 32 / CS; a padded
//   or channel-major layout spreads all 32 lanes over the banks at random,
//   which conflicts more.  Hence the wide slice: at 64 KB (CS = 8192 / N,
//   three blocks of 512 threads an SM) the slices took 1.1-1.7x as long at
//   N = 2048 and 4096 (tools/reduce_ab.py, PERF.md).  The shared f32 add
//   is no native instruction on sm_90: it compiles to a compare-and-swap
//   loop (ATOMS.CAST.SPIN in the SASS), ~30% of the kernel's time against
//   a plain read-modify-write.  A row that many points pick (a hub) takes
//   its adds one after another.
//   atomic  (dg_edge_reduce_bwd_atomic, and the slices entry above N =
//   16384) edge_reduce_bwd_atomic_kernel, the first form: one warp
//   per row i (QB = 16 rows a block), lane owns channels lane + 32 u; pass
//   1 reads the k neighbour rows of a (coalesced) and counts the ties, pass
//   2 reads them again (from L2) and adds each w_t into da's neighbour row
//   with a global f32 atomicAdd (one per (row, neighbour, channel)).  The
//   entry zeroes da on the stream first.
// On the slices and atomic routes the adds land in an order that changes
// from run to run, so da's last bits do too.
//
// The AMP form (dg_edge_reduce_bwd_pull_amp), the JAX package's default in
// training (_edge_reduce_bwd_kernel with exact=False, pallas_knn.py:
// 666-718), on the pull route: sel_t is a's value rounded to bf16 (to
// nearest even; _parts(a, False), :690), so the ties are counted against
// the AMP forward's amax / amin, which are values of round_bf16(a); w_t is
// formed as above in f32 and rounded to bf16 before it is stored (:716-
// 717, the bf16 operand of the scatter product), and each da[j] is the f32
// sum of its edges' rounded addends in ascending edge order.  No float
// atomic: the same bits from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reverse_lists.cuh"

namespace {

constexpr int QB = 16;      // rows (warps) per block of the atomic route
constexpr int MAXCPL = 8;   // channels per lane: Co <= 256

constexpr int ST = 1024;             // threads a block of the slices route
constexpr int SLICE_FLOATS = 16384;  // N * CS: 64 KB each for a and da
constexpr int MAX_CS = 32;             // more slices a cloud at small N

// log2 of the channels a block of the slices route takes, or -1 when a
// cloud of N rows does not fit.
int slice_log2(int N) {
  int l = -1;
  for (int cs = 1; cs <= MAX_CS && (long)N * cs <= SLICE_FLOATS; cs *= 2)
    ++l;
  return l;
}

// Calls f(j) for the neighbours j = irow[t] of a row, t ascending; VEC: k %
// 4 == 0 and irow 16-byte aligned, four neighbours a load.
template <bool VEC, typename F>
__device__ __forceinline__ void for_neighbours(const int* __restrict__ irow,
                                               int k, F f) {
  if (VEC) {
    for (int t = 0; t < k; t += 4) {
      const int4 j4 = *reinterpret_cast<const int4*>(irow + t);
      f(j4.x);
      f(j4.y);
      f(j4.z);
      f(j4.w);
    }
  } else {
#pragma unroll 4
    for (int t = 0; t < k; ++t) f(irow[t]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(ST, 1)
    edge_reduce_bwd_slices_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ a,
                                  const float* __restrict__ amax,
                                  const float* __restrict__ amin,
                                  const float* __restrict__ ct_max,
                                  const float* __restrict__ ct_min,
                                  const float* __restrict__ ct_sum,
                                  const float* __restrict__ ct_sumsq, int N,
                                  int Co, int k, int lcs,
                                  float* __restrict__ da) {
  extern __shared__ float ssm[];
  const int CS = 1 << lcs, items = N << lcs;
  float* as = ssm;          // a[b, :, c0 : c0 + CS], (N, CS)
  float* ds = as + items;   // da's slice, (N, CS)
  const int slices = (Co + CS - 1) >> lcs;
  const int b = blockIdx.x / slices;  // a cloud's slices are neighbours
  const int c0 = (blockIdx.x - b * slices) << lcs;
  const size_t cloud = (size_t)b * N;
  for (int q = threadIdx.x; q < items; q += ST) {
    const int i = q >> lcs, c = c0 + (q & (CS - 1));
    as[q] = c < Co ? a[(cloud + i) * Co + c] : 0.f;
    ds[q] = 0.f;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < items; q += ST) {
    const int i = q >> lcs, cl = q & (CS - 1);
    if (c0 + cl >= Co) continue;
    const size_t o = (cloud + i) * Co + c0 + cl;
    const int* irow = idx + (cloud + i) * k;
    const float vmax = amax[o], vmin = amin[o];
    float cmax = 0.f, cmin = 0.f;
    for_neighbours<VEC>(irow, k, [&](int j) {
      const float v = as[(j << lcs) + cl];
      cmax += v == vmax ? 1.f : 0.f;
      cmin += v == vmin ? 1.f : 0.f;
    });
    const float gmax = __fdiv_rn(ct_max[o], cmax);
    const float gmin = __fdiv_rn(ct_min[o], cmin);
    const float gsum = ct_sum[o];
    const float gsq2 = __fmul_rn(2.f, ct_sumsq[o]);
    for_neighbours<VEC>(irow, k, [&](int j) {
      const int s = (j << lcs) + cl;
      const float v = as[s];
      const float w = __fadd_rn(
          __fadd_rn(__fadd_rn(v == vmax ? gmax : 0.f, v == vmin ? gmin : 0.f),
                    gsum),
          __fmul_rn(v, gsq2));
      atomicAdd(ds + s, w);
    });
  }
  __syncthreads();
  for (int q = threadIdx.x; q < items; q += ST) {
    const int i = q >> lcs, c = c0 + (q & (CS - 1));
    if (c < Co) da[(cloud + i) * Co + c] = ds[q];
  }
}

__global__ void __launch_bounds__(QB * 32)
    edge_reduce_bwd_atomic_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ a,
                                  const float* __restrict__ amax,
                                  const float* __restrict__ amin,
                                  const float* __restrict__ ct_max,
                                  const float* __restrict__ ct_min,
                                  const float* __restrict__ ct_sum,
                                  const float* __restrict__ ct_sumsq, int N,
                                  int Co, int k, float* __restrict__ da) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * QB + warp;  // b * N + i
  const size_t base = (row / N) * N * Co;             // the cloud's a / da
  const int* irow = idx + row * k;

  float vmax[MAXCPL], vmin[MAXCPL], cmax[MAXCPL], cmin[MAXCPL];
#pragma unroll
  for (int u = 0; u < MAXCPL; ++u) {
    const int c = lane + 32 * u;
    vmax[u] = c < Co ? amax[row * Co + c] : 0.f;
    vmin[u] = c < Co ? amin[row * Co + c] : 0.f;
    cmax[u] = 0.f;
    cmin[u] = 0.f;
  }
  for (int t = 0; t < k; ++t) {
    const float* arow = a + base + (size_t)irow[t] * Co;
#pragma unroll
    for (int u = 0; u < MAXCPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = arow[c];
        cmax[u] += v == vmax[u] ? 1.f : 0.f;
        cmin[u] += v == vmin[u] ? 1.f : 0.f;
      }
    }
  }

  float gmax[MAXCPL], gmin[MAXCPL], gsum[MAXCPL], gsq2[MAXCPL];
#pragma unroll
  for (int u = 0; u < MAXCPL; ++u) {
    const int c = lane + 32 * u;
    if (c < Co) {
      const size_t o = row * Co + c;
      gmax[u] = __fdiv_rn(ct_max[o], cmax[u]);
      gmin[u] = __fdiv_rn(ct_min[o], cmin[u]);
      gsum[u] = ct_sum[o];
      gsq2[u] = __fmul_rn(2.f, ct_sumsq[o]);
    }
  }
  for (int t = 0; t < k; ++t) {
    const size_t j = base + (size_t)irow[t] * Co;
#pragma unroll
    for (int u = 0; u < MAXCPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = a[j + c];
        const float w = __fadd_rn(
            __fadd_rn(__fadd_rn(v == vmax[u] ? gmax[u] : 0.f,
                                v == vmin[u] ? gmin[u] : 0.f),
                      gsum[u]),
            __fmul_rn(v, gsq2[u]));
        atomicAdd(da + j + c, w);
      }
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The pull route's first pass: a warp a row i (8 a block), CPL channels a
// lane: the ties of (i, c) among a's rows of i's neighbours, t ascending,
// then each edge's w_t with the _rn operations of the note, stored at
// wbuf[(i k + t) Co + c] (a row of Co floats an edge, coalesced).  The
// atomic route's two passes with a store for its atomicAdd.  AMP: a's
// values and the stored w_t rounded to bf16.
template <int CPL, bool AMP>
__global__ void __launch_bounds__(256)
    edge_reduce_bwd_addend_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ a,
                                  const float* __restrict__ amax,
                                  const float* __restrict__ amin,
                                  const float* __restrict__ ct_max,
                                  const float* __restrict__ ct_min,
                                  const float* __restrict__ ct_sum,
                                  const float* __restrict__ ct_sumsq,
                                  int rows, int N, int Co, int k,
                                  float* __restrict__ wbuf) {
  const size_t row = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)rows) return;
  const size_t base = (row / N) * N * Co;  // the cloud's a
  const int* irow = idx + row * k;
  float vmax[CPL], vmin[CPL], cmax[CPL], cmin[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    vmax[u] = c < Co ? amax[row * Co + c] : 0.f;
    vmin[u] = c < Co ? amin[row * Co + c] : 0.f;
    cmax[u] = cmin[u] = 0.f;
  }
  for (int t = 0; t < k; ++t) {
    const float* arow = a + base + (size_t)irow[t] * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = AMP ? round_bf16(arow[c]) : arow[c];
        cmax[u] += v == vmax[u] ? 1.f : 0.f;
        cmin[u] += v == vmin[u] ? 1.f : 0.f;
      }
    }
  }
  float gmax[CPL], gmin[CPL], gsum[CPL], gsq2[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    const size_t o = row * Co + c;
    gmax[u] = c < Co ? __fdiv_rn(ct_max[o], cmax[u]) : 0.f;
    gmin[u] = c < Co ? __fdiv_rn(ct_min[o], cmin[u]) : 0.f;
    gsum[u] = c < Co ? ct_sum[o] : 0.f;
    gsq2[u] = c < Co ? __fmul_rn(2.f, ct_sumsq[o]) : 0.f;
  }
  for (int t = 0; t < k; ++t) {
    const float* arow = a + base + (size_t)irow[t] * Co;
    float* wrow = wbuf + (row * k + t) * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = AMP ? round_bf16(arow[c]) : arow[c];
        const float w = __fadd_rn(
            __fadd_rn(__fadd_rn(v == vmax[u] ? gmax[u] : 0.f,
                                v == vmin[u] ? gmin[u] : 0.f),
                      gsum[u]),
            __fmul_rn(v, gsq2[u]));
        wrow[c] = AMP ? round_bf16(w) : w;
      }
    }
  }
}

template <int CPL, bool AMP>
cudaError_t launch_addend(const int* idx, const float* a, const float* amax,
                          const float* amin, const float* ct_max,
                          const float* ct_min, const float* ct_sum,
                          const float* ct_sumsq, int rows, int N, int Co,
                          int k, float* wbuf, cudaStream_t st) {
  edge_reduce_bwd_addend_kernel<CPL, AMP><<<(rows + 7) / 8, 256, 0, st>>>(
      idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq, rows, N, Co, k,
      wbuf);
  return cudaGetLastError();
}

bool valid(int B, int N, int Co, int k) {
  return B >= 1 && N % 128 == 0 && Co >= 1 && Co <= 32 * MAXCPL && k >= 1 &&
         k <= N;
}

int launch_atomic(const int* idx, const float* a, const float* amax,
                  const float* amin, const float* ct_max, const float* ct_min,
                  const float* ct_sum, const float* ct_sumsq, float* da,
                  int B, int N, int Co, int k, cudaStream_t st) {
  cudaError_t e =
      cudaMemsetAsync(da, 0, sizeof(float) * (size_t)B * N * Co, st);
  if (e != cudaSuccess) return (int)e;
  edge_reduce_bwd_atomic_kernel<<<B * N / QB, QB * 32, 0, st>>>(
      idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq, N, Co, k, da);
  return (int)cudaGetLastError();
}

}  // namespace

// idx (B, N, k) int32; a, amax, amin and the cotangents ct_* (B, N, Co)
// f32; out da (B, N, Co) f32 (every element written; the caller need not
// zero it); all contiguous, on the device.  N <= 16384 takes the slices
// route, larger N the atomic route.  Returns the first CUDA error.
extern "C" int dg_edge_reduce_bwd(const int* idx, const float* a,
                                  const float* amax, const float* amin,
                                  const float* ct_max, const float* ct_min,
                                  const float* ct_sum, const float* ct_sumsq,
                                  float* da, int B, int N, int Co, int k,
                                  void* stream) {
  if (!valid(B, N, Co, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int lcs = slice_log2(N);
  if (lcs < 0)
    return launch_atomic(idx, a, amax, amin, ct_max, ct_min, ct_sum,
                         ct_sumsq, da, B, N, Co, k, st);
  const size_t smem = sizeof(float) * 2 * ((size_t)N << lcs);
  const bool vec = k % 4 == 0 && (size_t)idx % 16 == 0;
  auto kern = vec ? edge_reduce_bwd_slices_kernel<true>
                  : edge_reduce_bwd_slices_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int slices = (Co + (1 << lcs) - 1) >> lcs;
  kern<<<B * slices, ST, smem, st>>>(
      idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq, N, Co, k, lcs,
      da);
  return (int)cudaGetLastError();
}

// The atomic route at any shape dg_edge_reduce_bwd takes (the checks hold
// the slices route against it); the same arguments.
extern "C" int dg_edge_reduce_bwd_atomic(
    const int* idx, const float* a, const float* amax, const float* amin,
    const float* ct_max, const float* ct_min, const float* ct_sum,
    const float* ct_sumsq, float* da, int B, int N, int Co, int k,
    void* stream) {
  if (!valid(B, N, Co, k)) return (int)cudaErrorInvalidValue;
  return launch_atomic(idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq,
                       da, B, N, Co, k, (cudaStream_t)stream);
}

namespace {

template <bool AMP>
int pull(const int* idx, const float* a, const float* amax, const float* amin,
         const float* ct_max, const float* ct_min, const float* ct_sum,
         const float* ct_sumsq, float* da, float* wbuf, int* iscratch, int B,
         int N, int Co, int k, cudaStream_t st) {
  if (!valid(B, N, Co, k)) return (int)cudaErrorInvalidValue;
  const int *off, *lst;
  cudaError_t e = dg::build_reverse_lists(idx, B, N, k, iscratch, &off,
                                          &lst, st);
  if (e != cudaSuccess) return (int)e;
  const int rows = B * N;
  auto go = [&](auto launch) {
    return launch(idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq,
                  rows, N, Co, k, wbuf, st);
  };
  e = Co <= 32    ? go(launch_addend<1, AMP>)
      : Co <= 64  ? go(launch_addend<2, AMP>)
      : Co <= 128 ? go(launch_addend<4, AMP>)
                  : go(launch_addend<8, AMP>);
  if (e != cudaSuccess) return (int)e;
  return (int)dg::launch_pull_sum(off, lst, wbuf, rows, Co, da, st);
}

}  // namespace

// The pull route, at any shape dg_edge_reduce_bwd takes; the same
// arguments and two scratch buffers: wbuf (B * N * k * Co floats: each
// edge's w_t) and iscratch (dg_reverse_list_ints(B, N, k) ints: the
// reverse lists).  No float atomic: da has the same bits from run to run.
extern "C" int dg_edge_reduce_bwd_pull(
    const int* idx, const float* a, const float* amax, const float* amin,
    const float* ct_max, const float* ct_min, const float* ct_sum,
    const float* ct_sumsq, float* da, float* wbuf, int* iscratch, int B,
    int N, int Co, int k, void* stream) {
  return pull<false>(idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq,
                     da, wbuf, iscratch, B, N, Co, k, (cudaStream_t)stream);
}

// The AMP form of dg_edge_reduce_bwd_pull (the note): the same arguments.
extern "C" int dg_edge_reduce_bwd_pull_amp(
    const int* idx, const float* a, const float* amax, const float* amin,
    const float* ct_max, const float* ct_min, const float* ct_sum,
    const float* ct_sumsq, float* da, float* wbuf, int* iscratch, int B,
    int N, int Co, int k, void* stream) {
  return pull<true>(idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq,
                    da, wbuf, iscratch, B, N, Co, k, (cudaStream_t)stream);
}

// The int32 scratch of the reverse lists (reverse_lists.cuh).
extern "C" long long dg_reverse_list_ints(int B, int N, int k) {
  return (long long)dg::reverse_list_ints(B, N, k);
}
