// The earlier form of csrc/knn_reduce.cu (one warp a query row, its N
// scores in registers, k rounds of warp arg-max), not built into the
// library: tools/reduce_ab.py --kernel knn_reduce times it against the
// kernel and holds the two to each other (PERF.md, Findings).
//
// knn_reduce / knn_reduce_xw: the forward of one training EdgeConv stage's
// neighbour reductions on Hopper (sm_90a).
//
// Replace the TPU kernels dgcnn_tpu/ops/pallas_knn.py::fused_knn_reduce
// (body _knn_reduce_kernel) and ::fused_knn_reduce_xw (body
// _knn_reduce_xw_kernel), with with_sumsq=True, in their exact (f32) mode:
//
//   nbr(i) = the k highest 2<g_i,g_j> - |g_i|^2 - |g_j|^2, self included,
//            lowest index first among equal scores      (kNN over graph)
//   idx[i, t] = the t-th member of nbr(i)
//   amax_i, amin_i, asum_i, asumsq_i = max, min, sum, sum of squares over
//            t of a[idx[i, t]]                         (per channel)
//
// where knn_reduce takes a (= x @ W_nbr, projected by the caller) and
// knn_reduce_xw takes the raw features xf and w, a = xf @ w.
//
// Bound on an H100 SXM: operations.  At the DGCNNCls training shapes
// (B=32, N=1024, k=20, Cg = 3 / 64 / 64 / 128) the scores are 2*B*N^2*Cg
// flops, ~17 GFLOP over the four stages: ~0.26 ms at the f32 CUDA-core
// peak (67 TFLOP/s), against ~0.35 GB of a in and reductions out, ~0.1 ms
// at 3.35 TB/s.
//
// Design: the selection of knn_select.cuh (edge_conv_eval's design,
// shared, not copied): sqnorm, then one warp per query row with its N
// scores in registers and k rounds of warp arg-max.  Each winner's index
// goes to idx and its row of a is read whole (coalesced) into running
// max/min/sum/sum-of-squares, t ascending, with _rn intrinsics so that
// nothing is contracted into an FMA.  The rows are read exactly, so amax
// and amin are bit-equal to members' values: the backward kernel
// (edge_reduce_bwd.cu) finds its ties by comparing against them.
// knn_reduce_xw projects the whole cloud once into a scratch a with the
// register-blocked GEMM of project.cu (launch_project) and then runs the
// same selection: for the 128 -> 256 stage that is k = 20 times fewer FMAs
// than projecting each selected raw row as the TPU kernel does.  The
// backward recomputes a with the same launch (dg_project below), which
// sums each element in the same order, so its a and the forward's are the
// same bits.
#include <cuda_runtime.h>
#include <math.h>

#include "knn_select.cuh"

namespace {

using dg::MAX_N;

template <int NPL>
__global__ void __launch_bounds__(dg::Bucket<NPL>::QB * 32)
    knn_reduce_kernel(const float* __restrict__ graph, int Cg,
                      const float* __restrict__ sq,
                      const float* __restrict__ a, int Co, int N, int k,
                      int* __restrict__ idx, float* __restrict__ amax,
                      float* __restrict__ amin, float* __restrict__ asum,
                      float* __restrict__ asumsq) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  constexpr int CPL = dg::Bucket<NPL>::CPL;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * dg::Bucket<NPL>::QB + warp;
  float s[NPL];
  dg::row_scores<NPL>(graph + (size_t)b * N * Cg, Cg, sq + (size_t)b * N, N,
                      i, lane, sg, s);

  const float* A = a + (size_t)b * N * Co;
  const size_t row = (size_t)b * N + i;
  int* irow = idx + row * k;
  float mx[CPL], mn[CPL], sm[CPL], s2[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    mx[u] = -INFINITY;
    mn[u] = INFINITY;
    sm[u] = 0.f;
    s2[u] = 0.f;
  }
  for (int r = 0; r < k; ++r) {
    const int j = dg::pop_nearest<NPL>(s, lane);
    if (lane == 0) irow[r] = j;
    const float* arow = A + (size_t)j * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = arow[c];
        mx[u] = fmaxf(mx[u], v);
        mn[u] = fminf(mn[u], v);
        sm[u] = __fadd_rn(sm[u], v);
        s2[u] = __fadd_rn(s2[u], __fmul_rn(v, v));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < Co) {
      const size_t o = row * Co + c;
      amax[o] = mx[u];
      amin[o] = mn[u];
      asum[o] = sm[u];
      asumsq[o] = s2[u];
    }
  }
}

// sqnorm of the graph, then the selection over a.
cudaError_t reduce(const float* graph, const float* a, float* sq, int* idx,
                   float* amax, float* amin, float* asum, float* asumsq,
                   int B, int N, int Cg, int Co, int k, cudaStream_t st) {
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  return dg::with_npl(N, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const size_t smem = dg::select_smem_bytes<NPL>(N);
    constexpr int QB = dg::Bucket<NPL>::QB;
    cudaError_t err = cudaFuncSetAttribute(
        knn_reduce_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    knn_reduce_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        graph, Cg, sq, a, Co, N, k, idx, amax, amin, asum, asumsq);
    return cudaGetLastError();
  });
}

bool bad_shape(int B, int N, int Cg, int Co, int k) {
  return B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 ||
         Co > dg::max_co(N) || Cg < 1 || k < 1 || k > N;
}

}  // namespace

// graph (B, N, Cg), a (B, N, Co), scratch sq (B*N,); out idx (B, N, k)
// int32 and amax/amin/asum/asumsq (B, N, Co); f32 otherwise, contiguous,
// on the device.  Returns the first CUDA error.
extern "C" int dg_knn_reduce(const float* graph, const float* a, float* sq,
                             int* idx, float* amax, float* amin, float* asum,
                             float* asumsq, int B, int N, int Cg, int Co,
                             int k, void* stream) {
  if (bad_shape(B, N, Cg, Co, k)) return (int)cudaErrorInvalidValue;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, B, N, Cg,
                     Co, k, (cudaStream_t)stream);
}

// As dg_knn_reduce over a = xf (B, N, Cin) @ w (Cin, Co), projected into
// the scratch a (B, N, Co) first.
extern "C" int dg_knn_reduce_xw(const float* graph, const float* xf,
                                const float* w, float* a, float* sq, int* idx,
                                float* amax, float* amin, float* asum,
                                float* asumsq, int B, int N, int Cg, int Cin,
                                int Co, int k, void* stream) {
  if (bad_shape(B, N, Cg, Co, k) || Cin < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dg::launch_project(xf, B * N, Cin, w, Co, a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, B, N, Cg,
                     Co, k, st);
}

// out (M, ncols) = x (M, K) @ w (K, ncols): the projection of
// dg_knn_reduce_xw on its own, for the backward's recomputation of a.
extern "C" int dg_project(const float* x, const float* w, float* out, int M,
                          int K, int ncols, void* stream) {
  if (M < 1 || K < 1 || ncols < 1) return (int)cudaErrorInvalidValue;
  return (int)dg::launch_project(x, M, K, w, ncols, out,
                                 (cudaStream_t)stream);
}
