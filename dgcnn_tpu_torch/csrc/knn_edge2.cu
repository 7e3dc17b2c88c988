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
// Design: the selection of knn_select.cuh (sqnorm, then a warp per query
// row with its N scores in registers and k rounds of warp arg-max), with
// each winner consumed at once: the lanes write the edge's h1 row into the
// warp's row of shared memory (edge2.cuh), then each lane forms its
// second-conv channels as f32 dot products against w2, which the block
// keeps in shared memory beside the graph stage, and folds them into a
// running max.  Neither the (B, N, k, C1) hidden tensor nor idx reaches
// device memory.  Each w2 value read from shared memory feeds one FMA, so
// the per-edge product is shared-memory bound in this simple form.
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"
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
                     float* __restrict__ out) {
  constexpr int QB = E2Block<NPL>::QB;
  extern __shared__ float smem[];
  float* sg = smem;                                          // graph stage
  float* ws = sg + dg::select_smem_bytes<NPL>(N) / sizeof(float);  // w2
  float* hb = ws + C1 * dg::e2_ldw(C2);                      // QB h1 rows
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  // row_scores synchronises the block before its first read of shared
  // memory and after its first write, which covers w2 too
  dg::e2_stage_w2(w2, C1, C2, ws);
  float s[NPL];
  dg::row_scores<NPL>(graph + (size_t)b * N * Cg, Cg, sq + (size_t)b * N, N,
                      i, lane, sg, s);

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
  const float* A = a1 + (size_t)b * N * C1;
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

}  // namespace

// graph (B, N, Cg), a1/b1 (B, N, C1), w2 (C1, C2), s1/t1 (C1,), s2/t2
// (C2,), scratch sq (B*N,), out (B, N, C2); all f32, contiguous, on the
// device.  Returns the first CUDA error.
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
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return (int)e;
  e = dg::with_npl(N, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    constexpr int QB = E2Block<NPL>::QB;
    const size_t smem =
        dg::select_smem_bytes<NPL>(N) +
        sizeof(float) * ((size_t)C1 * dg::e2_ldw(C2) + (size_t)QB * C1);
    cudaError_t err = cudaFuncSetAttribute(
        knn_edge2_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    knn_edge2_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        graph, Cg, sq, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope, N, k, out);
    return cudaGetLastError();
  });
  return (int)e;
}
