// The earlier form of csrc/edge_reduce_bwd.cu (one warp a centre row, a
// global f32 atomicAdd for every (row, neighbour, channel)), not built
// into the library: tools/reduce_ab.py --kernel edge_reduce_bwd times it
// against the kernel and holds the two to each other (PERF.md, Findings).
// The caller zeroes da.
//
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
// stages, ~0.16 ms at 3.35 TB/s; its ~10 operations per (i, t, channel)
// take ~0.03 ms at 67 TFLOP/s.
//
// Design: one warp per row i (QB = 16 rows a block), lane owns channels
// lane + 32 u.  Pass 1 reads the k neighbour rows of a (coalesced) and
// counts the ties; pass 2 reads them again (from L2) and adds each w_t
// into da's neighbour row with f32 atomicAdd.  Rows that many points pick
// (hubs) take many adds, in an order that changes from run to run, so
// da's last bits do too: the checks compare it within a relative
// tolerance, and exactly only where every addend is an integer.  The
// caller zeroes da.
#include <cuda_runtime.h>

namespace {

constexpr int QB = 16;      // rows (warps) per block
constexpr int MAXCPL = 8;   // channels per lane: Co <= 256

__global__ void __launch_bounds__(QB * 32)
    edge_reduce_bwd_kernel(const int* __restrict__ idx,
                           const float* __restrict__ a,
                           const float* __restrict__ amax,
                           const float* __restrict__ amin,
                           const float* __restrict__ ct_max,
                           const float* __restrict__ ct_min,
                           const float* __restrict__ ct_sum,
                           const float* __restrict__ ct_sumsq, int N, int Co,
                           int k, float* __restrict__ da) {
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

}  // namespace

// idx (B, N, k) int32; a, amax, amin and the cotangents ct_* (B, N, Co)
// f32; da (B, N, Co) f32, zeroed by the caller; all contiguous, on the
// device.  Returns the first CUDA error.
extern "C" int dg_edge_reduce_bwd(const int* idx, const float* a,
                                  const float* amax, const float* amin,
                                  const float* ct_max, const float* ct_min,
                                  const float* ct_sum, const float* ct_sumsq,
                                  float* da, int B, int N, int Co, int k,
                                  void* stream) {
  if (B < 1 || N % 128 != 0 || Co < 1 || Co > 32 * MAXCPL || k < 1 ||
      k > N)
    return (int)cudaErrorInvalidValue;
  edge_reduce_bwd_kernel<<<B * N / QB, QB * 32, 0, (cudaStream_t)stream>>>(
      idx, a, amax, amin, ct_max, ct_min, ct_sum, ct_sumsq, N, Co, k, da);
  return (int)cudaGetLastError();
}
