// The register-blocked f32 GEMM core of project.cu (project_kernel) and
// conv_pool.cu (conv_pool_gemm_kernel).
//
// A block of G128_THREADS = 256 threads owns a 128 x 128 tile of the
// output, each thread an 8 x 8 register block: rows 4 ty + i and 64 + 4 ty
// + i, columns 4 tx + j and 64 + 4 tx + j (tx, ty = tid % 16, tid / 16;
// i, j < 4).  K is walked in chunks of 32 that g128_load_chunk copies 16
// bytes at a time by cp.async into one of two buffers while the other is
// read by g128_fma_chunk.  x stays row-major in shared memory (rows padded
// by 4 floats) and is read as float4 along k, w as float4 along n: 16
// 128-bit shared loads a thread feed 256 FMAs, every warp's loads
// conflict-free.  Each output element is one fmaf chain over k, 0
// ascending; the zero fill past K adds exact zeros, so a chain's bits do
// not depend on the tiling.  f32 on the CUDA cores: the exact mode rules
// out TF32.
#pragma once

#include <cuda_runtime.h>

namespace dg {

constexpr int G128_THREADS = 256;
constexpr int G128_M = 128;                 // rows of a block tile
constexpr int G128_N = 128;                 // columns of a block tile
constexpr int G128_K = 32;                  // k a chunk
constexpr int G128_AS = G128_K + 4;         // row stride of the x tile
constexpr int G128_A = G128_M * G128_AS;    // floats of an x buffer
constexpr int G128_B = G128_K * G128_N;     // floats of a w buffer
constexpr size_t G128_SMEM =
    sizeof(float) * 2 * (G128_A + G128_B);  // two buffers: 69,632 B

// One 16-byte asynchronous copy, zero-filled when `in` is false.
__device__ __forceinline__ void g128_copy16(float* dst, const float* src,
                                            bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Starts the copies of chunk k0 of rows m0.. of x (M, K), row-major, into
// a, and of rows k0.. of w (K, ncols), row-major, columns n0.., into b,
// 16 bytes a copy, zero past M, K and ncols; then commits the group.
__device__ __forceinline__ void g128_load_chunk(
    float* a, float* b, const float* __restrict__ x, int M, int K, int m0,
    const float* __restrict__ w, int ncols, int n0, int k0) {
#pragma unroll
  for (int e = threadIdx.x; e < G128_M * G128_K / 4; e += G128_THREADS) {
    const int r = e / (G128_K / 4), c = (e % (G128_K / 4)) * 4;
    const bool in = m0 + r < M && k0 + c < K;
    g128_copy16(a + r * G128_AS + c,
                in ? x + (size_t)(m0 + r) * K + k0 + c : x, in);
  }
#pragma unroll
  for (int e = threadIdx.x; e < G128_K * G128_N / 4; e += G128_THREADS) {
    const int r = e / (G128_N / 4), c = (e % (G128_N / 4)) * 4;
    const bool in = k0 + r < K && n0 + c < ncols;
    g128_copy16(b + r * G128_N + c,
                in ? w + (size_t)(k0 + r) * ncols + n0 + c : w, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float4 g128_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += the chunk's x rows . w columns, k ascending; `a` and `b`
// are the chunk's two buffers as g128_load_chunk filled them.  acc[i][j]
// is row (i < 4 ? 4 ty + i : 64 + 4 ty + i - 4), column (j < 4 ? 4 tx + j
// : 64 + 4 tx + j - 4) of the tile.
__device__ __forceinline__ void g128_fma_chunk(float (&acc)[8][8],
                                               const float* a,
                                               const float* b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* as = a + 4 * ty * G128_AS;
  const float* bs = b + 4 * tx;
#pragma unroll
  for (int k4 = 0; k4 < G128_K; k4 += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = g128_ld4(as + ((i & 3) + (i >> 2) * 64) * G128_AS + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = g128_ld4(bs + (k4 + kk) * G128_N);
      const float4 b1 = g128_ld4(bs + (k4 + kk) * G128_N + 64);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = kk == 0   ? av[i].x
                         : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

}  // namespace dg
