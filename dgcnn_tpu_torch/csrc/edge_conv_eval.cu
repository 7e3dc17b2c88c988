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
//   3. select_kernel   one warp per query row, QB = 16 rows per block.  The
//                      block stages the graph of its cloud through shared
//                      memory CC channels at a time; each lane keeps the
//                      scores of its N/32 columns (j = 32*t + lane) in
//                      registers, so the N x N score matrix never leaves
//                      the SM.  Then k rounds of a warp arg-max on
//                      (score, -index) pick the neighbours in torch.topk
//                      order; each winner's row of a is read (coalesced)
//                      into a running max/min over the Co channels, and the
//                      epilogue applies the affine and LeakyReLU.
// No idx, no (B, N, k, Co) edge tensor and no score matrix reach device
// memory.  The scores run on the CUDA cores in f32 (the exact mode needs
// f32 products, which rules out TF32); each graph value read from shared
// memory feeds one FMA, so shared-memory bandwidth, not the FMA rate, is
// the first limit of this simple design.
#include <cuda_runtime.h>
#include <math.h>

#include "tile_gemm.cuh"

namespace {

constexpr int QB = 16;       // query rows (warps) per block
constexpr int CC = 8;        // graph channels staged per pass
constexpr int CS = CC + 1;   // padded shared-memory row stride (no bank conflicts)
constexpr int MAXCPL = 8;    // output channels per lane: Co <= 256
constexpr int MAX_N = 2048;  // scores per lane: N / 32 <= 64 registers

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
__global__ void __launch_bounds__(QB * 32)
    select_kernel(const float* __restrict__ graph, int Cg,
                  const float* __restrict__ sq, const float* __restrict__ ac,
                  int Co, const float* __restrict__ scale,
                  const float* __restrict__ bias, float slope, int N, int k,
                  float* __restrict__ out) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const float* G = graph + (size_t)b * N * Cg;

  float s[NPL];
#pragma unroll
  for (int t = 0; t < NPL; ++t) s[t] = 0.f;
  for (int c0 = 0; c0 < Cg; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < N * CC; e += blockDim.x) {
      const int j = e / CC, c = e - j * CC;
      sg[j * CS + c] = (c0 + c < Cg) ? G[(size_t)j * Cg + c0 + c] : 0.f;
    }
    __syncthreads();
    float q[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) q[c] = sg[i * CS + c];
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const int j = t * 32 + lane;
      if (j < N) {
        const float* r = sg + j * CS;
#pragma unroll
        for (int c = 0; c < CC; ++c) s[t] = fmaf(q[c], r[c], s[t]);
      }
    }
  }

  // scores in the reference's operation order: (2 * inner - |g_i|^2) - |g_j|^2
  const float* SQ = sq + (size_t)b * N;
  const float qq = SQ[i];
#pragma unroll
  for (int t = 0; t < NPL; ++t) {
    const int j = t * 32 + lane;
    s[t] = (j < N) ? __fsub_rn(__fsub_rn(__fmul_rn(2.f, s[t]), qq), SQ[j])
                   : -INFINITY;
  }

  const int row = 2 * Co;
  const float* A = ac + (size_t)b * N * row;
  float mx[MAXCPL], mn[MAXCPL];
#pragma unroll
  for (int u = 0; u < MAXCPL; ++u) {
    mx[u] = -INFINITY;
    mn[u] = INFINITY;
  }
  for (int r = 0; r < k; ++r) {
    // lane-local best; t ascending, so the first maximum has the lowest index
    float best = s[0];
    int bj = lane;
#pragma unroll
    for (int t = 1; t < NPL; ++t) {
      if (s[t] > best) {
        best = s[t];
        bj = t * 32 + lane;
      }
    }
    // warp arg-max on (score, -index): every lane ends with the winner
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ob > best || (ob == best && oj < bj)) {
        best = ob;
        bj = oj;
      }
    }
#pragma unroll
    for (int t = 0; t < NPL; ++t)
      if (t * 32 + lane == bj) s[t] = -INFINITY;
    const float* arow = A + (size_t)bj * row;
#pragma unroll
    for (int u = 0; u < MAXCPL; ++u) {
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
  for (int u = 0; u < MAXCPL; ++u) {
    const int c = lane + 32 * u;
    if (c < Co) {
      const float sc = scale[c];
      const float sel = __fadd_rn(sc > 0.f ? mx[u] : mn[u], crow[c]);
      const float y = __fadd_rn(__fmul_rn(sel, sc), bias[c]);
      orow[c] = y >= 0.f ? y : __fmul_rn(slope, y);
    }
  }
}

template <int NPL>
cudaError_t launch_select(const float* graph, int Cg, const float* sq,
                          const float* ac, int Co, const float* scale,
                          const float* bias, float slope, int B, int N, int k,
                          float* out, cudaStream_t st) {
  const size_t smem = (size_t)N * CS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      select_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  select_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
      graph, Cg, sq, ac, Co, scale, bias, slope, N, k, out);
  return cudaGetLastError();
}

}  // namespace

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
  if (B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 || Co > 32 * MAXCPL ||
      Cg < 1 || Cin < 1 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * N;
  sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(graph, rows, Cg, sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 pg((rows + dg::GEMM_BM - 1) / dg::GEMM_BM,
                (2 * Co + dg::GEMM_BN - 1) / dg::GEMM_BN);
  project_kernel<<<pg, dg::GEMM_THREADS, 0, st>>>(x, rows, Cin, wcat, 2 * Co,
                                                  ac);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int npl = N / 32;
  if (npl <= 4)
    e = launch_select<4>(graph, Cg, sq, ac, Co, scale, bias, slope, B, N, k, out, st);
  else if (npl <= 8)
    e = launch_select<8>(graph, Cg, sq, ac, Co, scale, bias, slope, B, N, k, out, st);
  else if (npl <= 16)
    e = launch_select<16>(graph, Cg, sq, ac, Co, scale, bias, slope, B, N, k, out, st);
  else if (npl <= 32)
    e = launch_select<32>(graph, Cg, sq, ac, Co, scale, bias, slope, B, N, k, out, st);
  else if (npl <= 48)
    e = launch_select<48>(graph, Cg, sq, ac, Co, scale, bias, slope, B, N, k, out, st);
  else
    e = launch_select<64>(graph, Cg, sq, ac, Co, scale, bias, slope, B, N, k, out, st);
  return (int)e;
}
