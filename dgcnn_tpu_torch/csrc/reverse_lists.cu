// The reverse neighbour lists of kernels 5 and 8 and their pull sum
// (reverse_lists.cuh).  It replaces no TPU kernel: on the TPU,
// _edge_reduce_bwd_kernel and _edge2_bwd_kernel (dgcnn_tpu/ops/
// pallas_knn.py) scatter by a transposed one-hot product, which sums in a
// fixed order; on the card the scatter became float atomics, whose order
// changes from run to run, and these lists give the sums a fixed order
// again.
//
// Bound on an H100 SXM: bytes.  Building reads idx about three times and
// writes two int32 edge arrays of its size (B * N * k ints: ~2.6 MB at
// DGCNNCls's B=32, N=1024, k=20, ~10 MB at semseg's N=4096), a few
// microseconds at 3.35 TB/s.  Seven launches:
//   1. memset   the in-degree counters.
//   2. count    a thread an edge: atomicAdd(deg[b * N + j], 1), int32.
//   3. scan     the exclusive scan of the degrees, which also zeroes the
//               counters for the fill, in chunks of 4096 rows: a block a
//               chunk sums it, one block scans the chunks' sums (a thread a
//               run, then a scan of the 1024 run totals), and a block a
//               chunk scans it from its offset (three launches; one block
//               over every row took ~0.37 ms at semseg's 131072 rows on an
//               H100, PERF.md).
//   4. fill     a thread an edge: its slot off[g] + atomicAdd(cur[g], 1),
//               an order that changes from run to run.
//   5. sort     a warp a row: each entry's rank in its list is the number
//               of smaller edge ids (ids are unique), so the entries land
//               in ascending order whatever order the fill left; O(d^2 /
//               32) a list of d, with d ~ k on a kNN graph.
// Integer atomics are exact, so the lists are the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "reverse_lists.cuh"

namespace {

constexpr int SCAN_THREADS = 1024;

__global__ void count_kernel(const int* __restrict__ idx, int N, int k,
                             size_t edges, int* __restrict__ deg) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const int j = idx[e];
  if (j < 0 || j >= N) return;
  atomicAdd(deg + (e / ((size_t)N * k)) * N + j, 1);
}

constexpr int CHUNK = 4 * SCAN_THREADS;  // rows a block of the chunked scan

// The exclusive scan of v over the block's threads (every thread calls
// it); *total: the block's sum.
__device__ __forceinline__ int block_exclusive(int v, int* total) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  *total = warp_sum[SCAN_THREADS / 32 - 1];
  return inc - v + (warp > 0 ? warp_sum[warp - 1] : 0);
}

// sums[b] = the sum of deg over chunk b (a thread four rows).
__global__ void __launch_bounds__(SCAN_THREADS)
    chunk_sum_kernel(const int* __restrict__ deg, int rows,
                     int* __restrict__ sums) {
  const int r0 = blockIdx.x * CHUNK + 4 * threadIdx.x;
  int v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) v += r0 + i < rows ? deg[r0 + i] : 0;
  int total;
  block_exclusive(v, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// off[g] = base[b] + the sum of deg over chunk b's rows before g (chunk b
// holding g), off[rows] = base[chunks]; deg zeroed.
__global__ void __launch_bounds__(SCAN_THREADS)
    chunk_scan_kernel(int* __restrict__ deg, int rows,
                      const int* __restrict__ base, int chunks,
                      int* __restrict__ off) {
  const int r0 = blockIdx.x * CHUNK + 4 * threadIdx.x;
  int v[4], run = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = r0 + i < rows ? deg[r0 + i] : 0;
    run += v[i];
  }
  int total;
  int acc = base[blockIdx.x] + block_exclusive(run, &total);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r0 + i < rows) {
      off[r0 + i] = acc;
      acc += v[i];
      deg[r0 + i] = 0;
    }
  if (blockIdx.x == 0 && threadIdx.x == 0) off[rows] = base[chunks];
}

// off[g] = sum of deg[0 .. g), off[rows] = the total; deg zeroed: one
// block (the chunked scan's scan of the chunks' sums).
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(int* __restrict__ deg, int rows, int* __restrict__ off) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int per = (rows + SCAN_THREADS - 1) / SCAN_THREADS;
  const int r0 = min(rows, (int)threadIdx.x * per), r1 = min(rows, r0 + per);
  int run = 0;
  for (int r = r0; r < r1; ++r) run += deg[r];
  // exclusive scan of the runs: within each warp, then over the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int acc = inc - run + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int r = r0; r < r1; ++r) {
    off[r] = acc;
    acc += deg[r];
    deg[r] = 0;
  }
  if (threadIdx.x == SCAN_THREADS - 1) off[rows] = warp_sum[31];
}

__global__ void fill_kernel(const int* __restrict__ idx, int N, int k,
                            size_t edges, const int* __restrict__ off,
                            int* __restrict__ cur, int* __restrict__ tmp) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const int j = idx[e];
  if (j < 0 || j >= N) return;
  const size_t g = (e / ((size_t)N * k)) * N + j;
  tmp[off[g] + atomicAdd(cur + g, 1)] = (int)e;
}

__global__ void sort_kernel(const int* __restrict__ off,
                            const int* __restrict__ tmp, int rows,
                            int* __restrict__ lst) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= rows) return;
  const int beg = off[g], d = off[g + 1] - beg;
  for (int p0 = 0; p0 < d; p0 += 32) {
    const int x = p0 + lane < d ? tmp[beg + p0 + lane] : INT_MAX;
    int rank = 0;
    for (int q0 = 0; q0 < d; q0 += 32) {
      const int y = q0 + lane < d ? tmp[beg + q0 + lane] : INT_MAX;
      const int m = min(32, d - q0);
      for (int q = 0; q < m; ++q)
        rank += __shfl_sync(0xffffffffu, y, q) < x ? 1 : 0;
    }
    if (p0 + lane < d) lst[beg + rank] = x;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A warp a row g, CPL channels a lane (C <= 32 * CPL); T the addends' type
// (f32, or bf16 widened to f32 as it is read).
template <int CPL, typename T = float>
__global__ void pull_sum_kernel(const int* __restrict__ off,
                                const int* __restrict__ lst,
                                const T* __restrict__ add, int rows,
                                int C, float* __restrict__ out) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= rows) return;
  float acc[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) acc[u] = 0.f;
  const int end = off[g + 1];
  int p = off[g];
  // D rows' loads in flight at a time, added in list order
  constexpr int D = CPL <= 2 ? 8 : 4;
  for (; p + D <= end; p += D) {
    float v[D][CPL];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const T* row = add + (size_t)lst[p + r] * C;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        v[r][u] = c < C ? widen(row[c]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u) acc[u] = __fadd_rn(acc[u], v[r][u]);
  }
  for (; p < end; ++p) {
    const T* row = add + (size_t)lst[p] * C;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < C) acc[u] = __fadd_rn(acc[u], widen(row[c]));
    }
  }
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < C) out[(size_t)g * C + c] = acc[u];
  }
}

}  // namespace

namespace dg {

cudaError_t build_reverse_lists(const int* idx, int B, int N, int k,
                                int* scratch, const int** off,
                                const int** lst, cudaStream_t st) {
  const int rows = B * N;
  const size_t edges = (size_t)rows * k;
  const int chunks = (rows + CHUNK - 1) / CHUNK;
  int* o = scratch;             // rows + 1
  int* cur = o + rows + 1;      // rows
  int* sums = cur + rows;       // chunks: the scan's
  int* base = sums + chunks;    // chunks + 1
  int* tmp = base + chunks + 1;  // edges
  int* l = tmp + edges;         // edges
  cudaError_t e = cudaMemsetAsync(cur, 0, sizeof(int) * rows, st);
  if (e != cudaSuccess) return e;
  const int eb = (int)((edges + 255) / 256);
  count_kernel<<<eb, 256, 0, st>>>(idx, N, k, edges, cur);
  chunk_sum_kernel<<<chunks, SCAN_THREADS, 0, st>>>(cur, rows, sums);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(sums, chunks, base);
  chunk_scan_kernel<<<chunks, SCAN_THREADS, 0, st>>>(cur, rows, base, chunks,
                                                     o);
  fill_kernel<<<eb, 256, 0, st>>>(idx, N, k, edges, o, cur, tmp);
  sort_kernel<<<(rows + 7) / 8, 256, 0, st>>>(o, tmp, rows, l);
  *off = o;
  *lst = l;
  return cudaGetLastError();
}

cudaError_t launch_pull_sum(const int* off, const int* lst,
                            const float* add, int rows, int C, float* out,
                            cudaStream_t st) {
  const int blocks = (rows + 7) / 8;
  if (C <= 32)
    pull_sum_kernel<1><<<blocks, 256, 0, st>>>(off, lst, add, rows, C, out);
  else if (C <= 64)
    pull_sum_kernel<2><<<blocks, 256, 0, st>>>(off, lst, add, rows, C, out);
  else if (C <= 128)
    pull_sum_kernel<4><<<blocks, 256, 0, st>>>(off, lst, add, rows, C, out);
  else if (C <= 256)
    pull_sum_kernel<8><<<blocks, 256, 0, st>>>(off, lst, add, rows, C, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

cudaError_t launch_pull_sum_bf16(const int* off, const int* lst,
                                 const __nv_bfloat16* add, int rows, int C,
                                 float* out, cudaStream_t st) {
  if (C > 64) return cudaErrorInvalidValue;
  pull_sum_kernel<2, __nv_bfloat16><<<(rows + 7) / 8, 256, 0, st>>>(
      off, lst, add, rows, C, out);
  return cudaGetLastError();
}

}  // namespace dg

// The lists alone, for the checks: idx (B, N, k) int32 on the device,
// scratch dg_reverse_list_ints(B, N, k) ints; the offsets land in
// scratch[0 .. B * N], the edge ids in the last B * N * k ints.  Returns
// the first CUDA error.
extern "C" int dg_reverse_lists(const int* idx, int B, int N, int k,
                                int* scratch, void* stream) {
  if (B < 1 || N < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int *off, *lst;
  return (int)dg::build_reverse_lists(idx, B, N, k, scratch, &off, &lst,
                                      (cudaStream_t)stream);
}

// The pull sum on its own, for the checks: out (B * N, C) f32, each row
// summed over its list of in-edges, in ascending edge id from zero, of the
// addends add (B * N * k, C), f32 (bf16 = 0, C <= 256) or bf16 (bf16 = 1,
// C <= 64: kernel 8 AMP's tensor-core form); scratch as dg_reverse_lists.
// Returns the first CUDA error.
extern "C" int dg_pull_sum(const int* idx, const void* add, int bf16, int B,
                           int N, int k, int C, float* out, int* scratch,
                           void* stream) {
  if (B < 1 || N < 1 || k < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int *off, *lst;
  cudaError_t e = dg::build_reverse_lists(idx, B, N, k, scratch, &off, &lst,
                                          st);
  if (e != cudaSuccess) return (int)e;
  return (int)(bf16 ? dg::launch_pull_sum_bf16(
                          off, lst, static_cast<const __nv_bfloat16*>(add),
                          B * N, C, out, st)
                    : dg::launch_pull_sum(off, lst,
                                          static_cast<const float*>(add),
                                          B * N, C, out, st));
}
