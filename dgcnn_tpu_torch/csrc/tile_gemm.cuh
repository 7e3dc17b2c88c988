// Shared-memory tiled f32 GEMM tile, the product of conv_pool.cu's first
// form (conv_pool_kernel): the route of the shapes the register-blocked
// conv_pool_gemm_kernel does not take (an input width or E not a multiple
// of 4, an unaligned input) and dg_conv_pool_tile64, the earlier side of
// kernel 2's A/B.  (Every model's shapes take gemm128.cuh's core.)
//
// A block of GEMM_THREADS = 256 threads owns a 64 x 64 output tile; thread
// (tx, ty) = (tid % 16, tid / 16) owns rows 4*ty..4*ty+3 and columns
// 4*tx..4*tx+3 of it.  K is walked in chunks of 16 staged through shared
// memory by scalar loads (A stored k-major so both operands are read as
// float4), two block barriers a chunk and no copy overlapped with the
// math.  Each output is one fmaf chain over k, 0 ascending, as in
// gemm128.cuh.  Plain FMA on the CUDA cores, f32 throughout.
#pragma once

#include <cuda_runtime.h>

namespace dg {

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;

struct GemmSmem {
  float a[GEMM_BK][GEMM_BM + 4];  // A tile, k-major
  float b[GEMM_BK][GEMM_BN + 4];
};

// acc += A[m0:m0+64, 0:K] @ B[0:K, n0:n0+64], both row-major with leading
// dimensions lda / ldb; rows >= M and columns >= ncols read as zero.
__device__ __forceinline__ void gemm_tile_accumulate(
    float (&acc)[4][4], const float* __restrict__ A, int lda, int m0, int M,
    const float* __restrict__ B, int ldb, int n0, int ncols, int K,
    GemmSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int e = tid; e < GEMM_BM * GEMM_BK; e += GEMM_THREADS) {
      const int m = e / GEMM_BK, kk = e % GEMM_BK;
      const int gm = m0 + m, gk = k0 + kk;
      sm.a[kk][m] = (gm < M && gk < K) ? A[(size_t)gm * lda + gk] : 0.f;
    }
    for (int e = tid; e < GEMM_BK * GEMM_BN; e += GEMM_THREADS) {
      const int kk = e / GEMM_BN, n = e % GEMM_BN;
      const int gk = k0 + kk, gn = n0 + n;
      sm.b[kk][n] = (gk < K && gn < ncols) ? B[(size_t)gk * ldb + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace dg
