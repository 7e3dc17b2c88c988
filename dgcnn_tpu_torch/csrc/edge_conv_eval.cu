// edge_conv_eval: one whole eval EdgeConv stage on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::fused_edge_conv_eval
// (body _edge_conv1_kernel), in its exact (f32) mode:
//
//   a = x @ W_nbr, c = x @ W_ctr                      (projections)
//   nbr(i) = the k highest 2<g_i,g_j> - |g_i|^2 - |g_j|^2, self included,
//            lowest index first among equal scores     (kNN over graph)
//   sel = (s > 0 ? max_{j in nbr(i)} a_j : min_{j in nbr(i)} a_j) + c_i
//   out_i = LeakyReLU(sel * s + t)                     (folded BN)
//
// Bound on an H100 SXM: operations.  At the DGCNNCls shapes (B=64, N=1024,
// k=20) the N x N scores are 2*B*N^2*Cg flops a stage, ~35 GFLOP over the
// four stages, against ~0.2 GB of activations in and out: at the f32
// CUDA-core peak (67 TFLOP/s) the scores alone take ~0.5 ms, the bytes at
// 3.35 TB/s ~0.06 ms.
//
// Design, three launches on the caller's stream:
//   1. sqnorm_kernel   |g_j|^2 per point, into scratch.
//   2. project_kernel  [a | c] = x @ [W_nbr | W_ctr] with the tiled GEMM of
//                      tile_gemm.cuh, into a (B*N, 2*Co) scratch.
//   3. select_kernel   the kNN selection of knn_select.cuh: one warp per
//                      query row with its N scores in registers, then k
//                      rounds of a warp arg-max on (score, -index) pick the
//                      neighbours in torch.topk order; each winner's row of
//                      a is read (coalesced) into a running max/min over the
//                      Co channels, and the epilogue applies the affine and
//                      LeakyReLU.
// No idx, no (B, N, k, Co) edge tensor and no score matrix reach device
// memory.  The scores run on the CUDA cores in f32 (the exact mode needs
// f32 products, which rules out TF32); each graph value read from shared
// memory feeds one FMA, so shared-memory bandwidth, not the FMA rate, is
// the first limit of this simple design.
#include <cuda_runtime.h>
#include <math.h>

#include "knn_select.cuh"
#include "tile_gemm.cuh"

namespace {

using dg::MAX_N;

__global__ void sqnorm_kernel(const float* __restrict__ g, int rows, int C,
                              float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = g + (size_t)r * C;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(p[c], p[c], acc);
  out[r] = acc;
}

__global__ void __launch_bounds__(dg::GEMM_THREADS)
    project_kernel(const float* __restrict__ x, int M, int K,
                   const float* __restrict__ w, int ncols,
                   float* __restrict__ out) {
  __shared__ __align__(16) dg::GemmSmem sm;
  const int m0 = blockIdx.x * dg::GEMM_BM;
  const int n0 = blockIdx.y * dg::GEMM_BN;
  float acc[4][4] = {};
  dg::gemm_tile_accumulate(acc, x, K, m0, M, w, ncols, n0, ncols, K, sm);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < ncols) out[(size_t)gm * ncols + gn] = acc[i][j];
    }
  }
}

template <int NPL>
__global__ void __launch_bounds__(dg::Bucket<NPL>::QB * 32)
    select_kernel(const float* __restrict__ graph, int Cg,
                  const float* __restrict__ sq, const float* __restrict__ ac,
                  int Co, const float* __restrict__ scale,
                  const float* __restrict__ bias, float slope, int N, int k,
                  float* __restrict__ out) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  constexpr int CPL = dg::Bucket<NPL>::CPL;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * dg::Bucket<NPL>::QB + warp;
  float s[NPL];
  dg::row_scores<NPL>(graph + (size_t)b * N * Cg, Cg, sq + (size_t)b * N, N,
                      i, lane, sg, s);

  const int row = 2 * Co;
  const float* A = ac + (size_t)b * N * row;
  float mx[CPL], mn[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    mx[u] = -INFINITY;
    mn[u] = INFINITY;
  }
  for (int r = 0; r < k; ++r) {
    const float* arow = A + (size_t)dg::pop_nearest<NPL>(s, lane) * row;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = arow[c];
        mx[u] = fmaxf(mx[u], v);
        mn[u] = fminf(mn[u], v);
      }
    }
  }

  const float* crow = A + (size_t)i * row + Co;
  float* orow = out + ((size_t)b * N + i) * Co;
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < Co) {
      const float sc = scale[c];
      const float sel = __fadd_rn(sc > 0.f ? mx[u] : mn[u], crow[c]);
      const float y = __fadd_rn(__fmul_rn(sel, sc), bias[c]);
      orow[c] = y >= 0.f ? y : __fmul_rn(slope, y);
    }
  }
}

}  // namespace

namespace dg {

cudaError_t launch_sqnorm(const float* g, int rows, int C, float* out,
                          cudaStream_t st) {
  sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(g, rows, C, out);
  return cudaGetLastError();
}

cudaError_t launch_project(const float* x, int M, int K, const float* w,
                           int ncols, float* out, cudaStream_t st) {
  const dim3 grid((M + GEMM_BM - 1) / GEMM_BM, (ncols + GEMM_BN - 1) / GEMM_BN);
  project_kernel<<<grid, GEMM_THREADS, 0, st>>>(x, M, K, w, ncols, out);
  return cudaGetLastError();
}

}  // namespace dg

extern "C" const char* dg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// graph (B, N, Cg), x (B, N, Cin), wcat (Cin, 2*Co) = [W_nbr | W_ctr],
// scale/bias (Co,), scratch ac (B*N, 2*Co) and sq (B*N,), out (B, N, Co);
// all f32, contiguous, on the device.  Returns the first CUDA error.
extern "C" int dg_edge_conv_eval(const float* graph, const float* x,
                                 const float* wcat, const float* scale,
                                 const float* bias, float* ac, float* sq,
                                 float* out, int B, int N, int Cg, int Cin,
                                 int Co, int k, float slope, void* stream) {
  if (B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 ||
      Co > dg::max_co(N) || Cg < 1 || Cin < 1 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * N;
  cudaError_t e = dg::launch_sqnorm(graph, rows, Cg, sq, st);
  if (e != cudaSuccess) return (int)e;
  e = dg::launch_project(x, rows, Cin, wcat, 2 * Co, ac, st);
  if (e != cudaSuccess) return (int)e;
  e = dg::with_npl(N, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const size_t smem = dg::select_smem_bytes<NPL>(N);
    constexpr int QB = dg::Bucket<NPL>::QB;
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    select_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        graph, Cg, sq, ac, Co, scale, bias, slope, N, k, out);
    return cudaGetLastError();
  });
  return (int)e;
}
