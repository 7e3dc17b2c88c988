// conv_pool: embedding conv + folded BN + LeakyReLU + global max/mean pool
// over the points, on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_pool.py::fused_conv_pool
// (body _conv_pool_kernel), in its f32 mode:
//
//   y = LeakyReLU((concat(xs) @ W) * s + t)     (B, N, E), never stored
//   out[b, 0] = max_n y[b, n],  out[b, 1] = mean_n y[b, n]
//
// Bound on an H100 SXM: operations.  At the DGCNNCls head (B=64, N=1024,
// C=512, E=1024) the product is 2*B*N*C*E ~ 69 GFLOP against ~134 MB of
// stage outputs read: ~1.0 ms at the f32 CUDA-core peak (67 TFLOP/s) and
// ~0.04 ms at 3.35 TB/s.
//
// Design: one block per (E tile of 64 columns, cloud).  The block walks the
// cloud's N points 64 rows at a time; for each row tile it accumulates the
// four inputs' products with their row slices of W (no concat) through the
// shared-memory GEMM tile of tile_gemm.cuh, applies the affine and
// LeakyReLU in registers and folds the tile into per-thread running
// column max and sum.  A shared-memory reduction over the 16 thread rows
// then writes the two pooled rows: no atomics, and neither the concat nor
// the (B, N, E) activation reaches device memory.  The product runs on the
// CUDA cores in f32 (the exact mode rules out TF32).
#include <cuda_runtime.h>
#include <math.h>

#include "tile_gemm.cuh"

namespace {

constexpr int MAX_INPUTS = 4;

struct Inputs {
  const float* p[MAX_INPUTS];
  int c[MAX_INPUTS];
  int n;
};

__global__ void __launch_bounds__(dg::GEMM_THREADS)
    conv_pool_kernel(Inputs xs, int N, const float* __restrict__ w, int E,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float slope,
                     int with_mean, float* __restrict__ out) {
  __shared__ __align__(16) dg::GemmSmem sm;
  __shared__ float red_max[16][dg::GEMM_BN];
  __shared__ float red_sum[16][dg::GEMM_BN];
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * dg::GEMM_BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float sc[4], bi[4], cmax[4], csum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = e0 + tx * 4 + j;
    sc[j] = col < E ? scale[col] : 0.f;
    bi[j] = col < E ? bias[col] : 0.f;
    cmax[j] = -INFINITY;
    csum[j] = 0.f;
  }

  for (int m0 = 0; m0 < N; m0 += dg::GEMM_BM) {
    float acc[4][4] = {};
    int off = 0;
    for (int q = 0; q < xs.n; ++q) {
      const int c = xs.c[q];
      dg::gemm_tile_accumulate(acc, xs.p[q] + (size_t)b * N * c, c, m0, N,
                               w + (size_t)off * E, E, e0, E, c, sm);
      off += c;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + ty * 4 + i >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y = __fadd_rn(__fmul_rn(acc[i][j], sc[j]), bi[j]);
        y = y >= 0.f ? y : __fmul_rn(slope, y);
        cmax[j] = fmaxf(cmax[j], y);
        csum[j] += y;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_max[ty][tx * 4 + j] = cmax[j];
    red_sum[ty][tx * 4 + j] = csum[j];
  }
  __syncthreads();
  if (threadIdx.x < dg::GEMM_BN) {
    const int col = e0 + threadIdx.x;
    if (col < E) {
      float m = -INFINITY, s = 0.f;
      for (int r = 0; r < 16; ++r) {
        m = fmaxf(m, red_max[r][threadIdx.x]);
        s += red_sum[r][threadIdx.x];
      }
      const int rows = with_mean ? 2 : 1;
      out[((size_t)b * rows) * E + col] = m;
      if (with_mean) out[((size_t)b * rows + 1) * E + col] = s / (float)N;
    }
  }
}

}  // namespace

// xs: n_inputs (<= 4) tensors (B, N, c_q); w (sum c_q, E); scale/bias (E,);
// out (B, with_mean ? 2 : 1, E); all f32, contiguous, on the device.
// Returns the first CUDA error.
extern "C" int dg_conv_pool(const float* x0, const float* x1, const float* x2,
                            const float* x3, int c0, int c1, int c2, int c3,
                            int n_inputs, const float* w, const float* scale,
                            const float* bias, float* out, int B, int N, int E,
                            float slope, int with_mean, void* stream) {
  if (n_inputs < 1 || n_inputs > MAX_INPUTS || B < 1 || N < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  Inputs xs;
  const float* ps[MAX_INPUTS] = {x0, x1, x2, x3};
  const int cs[MAX_INPUTS] = {c0, c1, c2, c3};
  for (int q = 0; q < MAX_INPUTS; ++q) {
    xs.p[q] = ps[q];
    xs.c[q] = cs[q];
    if (q < n_inputs && cs[q] < 1) return (int)cudaErrorInvalidValue;
  }
  xs.n = n_inputs;
  const dim3 grid((E + dg::GEMM_BN - 1) / dg::GEMM_BN, B);
  conv_pool_kernel<<<grid, dg::GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      xs, N, w, E, scale, bias, slope, with_mean, out);
  return (int)cudaGetLastError();
}
