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
// Design, two routes decided from the shape before the launch:
//   conv_pool_gemm_kernel  (every input width and E multiples of 4, the
//     inputs and W 16-byte aligned: every model's shapes).  The product
//     runs on the core of gemm128.cuh, project.cu's: 128 x 128 output
//     tiles, 256 threads, an 8 x 8 register block a thread, 32-deep k
//     chunks copied by 16-byte cp.async into a second buffer while the
//     first is read.  The up-to-four inputs are consecutive k segments of
//     one chain (each walked in its own chunks, the last zero-filled past
//     its width): there is no concat.  A tile's rows come from one cloud;
//     the cloud's last tile is masked when N % 128 != 0.  The grid is
//     (column tile, row group, cloud): a row group is a run of `per`
//     consecutive row tiles of one cloud, with enough groups that the grid
//     holds about 1056 blocks (four waves of two blocks an SM on 132 SMs)
//     where the cloud has the tiles.  After each tile the block applies the
//     affine and the LeakyReLU in registers and folds the tile into each
//     thread's running column max and sum, kept in shared memory (registers
//     are full with the product's); at the end it folds its 16 thread rows
//     in order.  One group writes the two pooled rows itself; several write
//     partial rows into a scratch (B, groups, 2, E) that
//     conv_pool_combine_kernel reads in group order.
//   conv_pool_kernel  (any other shape; also dg_conv_pool_tile64, for the
//     A/B): the first form, a block a (64-column tile, cloud) walking the
//     cloud's N points 64 rows at a time through the shared-memory tile of
//     tile_gemm.cuh (4 x 4 registers a thread, 16-deep chunks staged by
//     scalar loads).
// Both compute each y as one fmaf chain from +0 over the concatenated
// channels, ascending, then __fadd_rn(__fmul_rn(acc, s), t) and the
// LeakyReLU's __fmul_rn(slope, y): the same bits on both routes, so the
// max row is bit-equal between them.  The mean's sum runs in another order
// on each route (rows of a thread, then thread rows, then groups, all in a
// fixed order): it is the same bits from call to call.  No atomics; the
// concat and the (B, N, E) activation never reach device memory.  f32 on
// the CUDA cores: the exact mode rules out TF32, and 3xTF32 would lose the
// max row's bits.
//
// The AMP form (dg_conv_pool_amp), fused_conv_pool(compute_dtype=bf16)
// (pallas_pool.py:31-48), the JAX package's default: bf16 operands (the
// bf16 stage outputs as they come, W rounded to bf16), f32 products and
// sums, summed split by split as the Pallas kernel does, h = ((x1 W1 +
// x2 W2) + x3 W3) + x4 W4, each term its own fmaf chain from zero; then
// the f32 epilogue and the max and mean rows.  The inputs go to f32 once
// (upcast_bf16_kernel, and W's rounding), then the register-blocked route
// runs with SPLIT: at the last chunk of each input a thread adds its
// 8 x 8 partial into a second 8 x 8 block of registers, so the instance
// takes one block of 256 threads an SM.  Its bound is bf16 tensor-core
// operations (~0.07 ms at 989 TFLOP/s at the DGCNNCls head); the CUDA
// cores run it at their f32 rate, a route that a later tensor-core form
// would replace (the products of bf16 values are exact in f32 either way,
// the sums' order is not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "gemm128.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr int MAX_INPUTS = 4;
// the blocks the row groups aim at: four waves of two blocks an SM on the
// H100's 132 SMs (a constant, so the partition and the mean's bits depend
// on the shape alone).  Two waves left the last wave's blocks alone on
// the card at K = 128-192 (PERF.md, Findings: the A/B of pool_ab).
constexpr int POOL_BLOCKS = 8 * 132;
constexpr int RED_ROWS = dg::G128_THREADS / 16;  // thread rows of a tile
constexpr size_t GEMM_POOL_SMEM =
    dg::G128_SMEM + sizeof(float) * 2 * RED_ROWS * dg::G128_N;

struct Inputs {
  const float* p[MAX_INPUTS];
  int c[MAX_INPUTS];  // 0 past n
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

// Chunk u of a row tile: its input's rows of cloud b (x, width c) and of W
// (wq), and its first channel k0 within the input.  The inputs are walked
// in order, each in ceil(c / 32) chunks.  The input is picked first and
// its pointers formed once from the pick, so that the compiler keeps no
// per-input pointer live across the block's loop.
__device__ __forceinline__ void locate_chunk(const Inputs& xs, int b, int N,
                                             const float* __restrict__ w,
                                             int E, int u, const float*& x,
                                             int& c, const float*& wq,
                                             int& k0) {
  int q = 0, off = 0;
#pragma unroll
  for (int r = 0; r < MAX_INPUTS - 1; ++r) {
    const int nq = (xs.c[r] + dg::G128_K - 1) / dg::G128_K;
    if (q == r && u >= nq) {
      u -= nq;
      off += xs.c[r];
      q = r + 1;
    }
  }
  const float* p = q == 0 ? xs.p[0] : q == 1 ? xs.p[1] : q == 2 ? xs.p[2]
                                                                : xs.p[3];
  c = q == 0 ? xs.c[0] : q == 1 ? xs.c[1] : q == 2 ? xs.c[2] : xs.c[3];
  x = p + (size_t)b * N * c;
  wq = w + (size_t)off * E;
  k0 = u * dg::G128_K;
}

// The chunks of a row tile up to the end of input q.
__device__ __forceinline__ int split_end(const Inputs& xs, int q) {
  int end = 0;
#pragma unroll
  for (int r = 0; r < MAX_INPUTS; ++r)
    if (r <= q) end += (xs.c[r] + dg::G128_K - 1) / dg::G128_K;
  return end;
}

// A block: column tile blockIdx.x, row tiles [per * g, per * g + per) of
// cloud b = blockIdx.z (g = blockIdx.y).  With groups == 1 it writes out;
// otherwise its partial max and sum rows go to part (B, groups, 2, E).
// SPLIT (the AMP form): each input's product is its own chain, the
// chains added in input order.
template <bool SPLIT>
__global__ void __launch_bounds__(dg::G128_THREADS, SPLIT ? 1 : 2)
    conv_pool_gemm_kernel(Inputs xs, int N, const float* __restrict__ w,
                          int E, const float* __restrict__ scale,
                          const float* __restrict__ bias, float slope,
                          int per, int groups, int with_mean,
                          float* __restrict__ part, float* __restrict__ out) {
  extern __shared__ __align__(16) float gsm[];
  float* red_max = gsm + 2 * (dg::G128_A + dg::G128_B);  // [16][128]
  float* red_sum = red_max + RED_ROWS * dg::G128_N;
  const int n0 = blockIdx.x * dg::G128_N, g = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row_tiles = (N + dg::G128_M - 1) / dg::G128_M;
  const int t0 = g * per;
  const int tiles = min(row_tiles, t0 + per) - t0;
  int chunks = 0;  // chunks a row tile
#pragma unroll
  for (int q = 0; q < MAX_INPUTS; ++q)
    chunks += (xs.c[q] + dg::G128_K - 1) / dg::G128_K;

  // each thread's running max and sum of its eight columns, its own slots
  // of row ty: no other thread touches them before the final fold
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float4*>(red_max + ty * dg::G128_N + 64 * h + 4 * tx) =
        make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    *reinterpret_cast<float4*>(red_sum + ty * dg::G128_N + 64 * h + 4 * tx) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[8][8], tot[8][8];
  {
    const float *x, *wq;
    int c, k0;
    locate_chunk(xs, b, N, w, E, 0, x, c, wq, k0);
    dg::g128_load_chunk(gsm, gsm + 2 * dg::G128_A, x, N, c, t0 * dg::G128_M,
                        wq, E, n0, k0);
  }
  int buf = 0;
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    int split = 0, next_end = split_end(xs, 0);
#pragma unroll 1
    for (int u = 0; u < chunks; ++u) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      // chunk u has landed for every thread, and every thread is done with
      // the previous chunk, whose buffers the next copy fills
      __syncthreads();
      int tn = t, un = u + 1;  // the next chunk
      if (un == chunks) {
        un = 0;
        ++tn;
      }
      if (tn < tiles) {
        const float *x, *wq;
        int c, k0;
        locate_chunk(xs, b, N, w, E, un, x, c, wq, k0);
        dg::g128_load_chunk(gsm + (buf ^ 1) * dg::G128_A,
                            gsm + 2 * dg::G128_A + (buf ^ 1) * dg::G128_B,
                            x, N, c, (t0 + tn) * dg::G128_M, wq, E, n0, k0);
      }
      dg::g128_fma_chunk(acc, gsm + buf * dg::G128_A,
                         gsm + 2 * dg::G128_A + buf * dg::G128_B);
      buf ^= 1;
      if constexpr (SPLIT) {
        if (u + 1 == next_end) {  // input `split` is done: fold its chain
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              tot[i][j] = split == 0 ? acc[i][j]
                                     : __fadd_rn(tot[i][j], acc[i][j]);
              acc[i][j] = 0.f;
            }
          ++split;
          next_end = split_end(xs, split);
        }
      }
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = tot[i][j];
    }
    // the tile is done: affine, LeakyReLU, and the fold into the running
    // column max and sum, rows i ascending (the next tile's first chunk is
    // in flight)
    const int m0 = (t0 + t) * dg::G128_M;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* pmax = red_max + ty * dg::G128_N + 64 * h + 4 * tx;
      float* psum = red_sum + ty * dg::G128_N + 64 * h + 4 * tx;
      const float4 m4 = *reinterpret_cast<const float4*>(pmax);
      const float4 s4 = *reinterpret_cast<const float4*>(psum);
      float mx[4] = {m4.x, m4.y, m4.z, m4.w};
      float sm[4] = {s4.x, s4.y, s4.z, s4.w};
      float sc[4], bi[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = n0 + 64 * h + 4 * tx + jj;
        sc[jj] = col < E ? __ldg(scale + col) : 0.f;
        bi[jj] = col < E ? __ldg(bias + col) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (m0 + (i & 3) + (i >> 2) * 64 + 4 * ty >= N) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float y = __fadd_rn(__fmul_rn(acc[i][4 * h + jj], sc[jj]), bi[jj]);
          y = y >= 0.f ? y : __fmul_rn(slope, y);
          mx[jj] = fmaxf(mx[jj], y);
          sm[jj] = __fadd_rn(sm[jj], y);
        }
      }
      *reinterpret_cast<float4*>(pmax) = make_float4(mx[0], mx[1], mx[2],
                                                     mx[3]);
      *reinterpret_cast<float4*>(psum) = make_float4(sm[0], sm[1], sm[2],
                                                     sm[3]);
    }
  }

  __syncthreads();
  if (threadIdx.x < dg::G128_N) {
    const int col = n0 + threadIdx.x;
    if (col < E) {
      float m = -INFINITY, s = 0.f;
      for (int r = 0; r < RED_ROWS; ++r) {
        m = fmaxf(m, red_max[r * dg::G128_N + threadIdx.x]);
        s = __fadd_rn(s, red_sum[r * dg::G128_N + threadIdx.x]);
      }
      if (groups == 1) {
        const int rows = with_mean ? 2 : 1;
        out[((size_t)b * rows) * E + col] = m;
        if (with_mean)
          out[((size_t)b * rows + 1) * E + col] = __fdiv_rn(s, (float)N);
      } else {
        float* pr = part + ((size_t)b * groups + g) * 2 * E;
        pr[col] = m;
        pr[E + col] = s;
      }
    }
  }
}

// out (B, rows, E) from the groups' partial rows, groups ascending.
__global__ void __launch_bounds__(256)
    conv_pool_combine_kernel(const float* __restrict__ part, int B,
                             int groups, int N, int E, int with_mean,
                             float* __restrict__ out) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= B * E) return;
  const int b = e / E, col = e - b * E;
  float m = -INFINITY, s = 0.f;
  for (int g = 0; g < groups; ++g) {
    const float* pr = part + ((size_t)b * groups + g) * 2 * E;
    m = fmaxf(m, pr[col]);
    s = __fadd_rn(s, pr[E + col]);
  }
  const int rows = with_mean ? 2 : 1;
  out[((size_t)b * rows) * E + col] = m;
  if (with_mean)
    out[((size_t)b * rows + 1) * E + col] = __fdiv_rn(s, (float)N);
}

// The row tiles a group takes (`per`) and the groups a cloud has.
void pool_groups(int B, int N, int E, int* per, int* groups) {
  const int row_tiles = (N + dg::G128_M - 1) / dg::G128_M;
  const int ctiles = (E + dg::G128_N - 1) / dg::G128_N;
  const int want = std::min(row_tiles,
                            (POOL_BLOCKS + B * ctiles - 1) / (B * ctiles));
  *per = std::max(1, row_tiles / want);
  *groups = (row_tiles + *per - 1) / *per;
}

bool aligned16(const void* p) { return (size_t)p % 16 == 0; }

__global__ void upcast_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                   size_t n, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = __bfloat162float(x[e]);
}

__global__ void round_bf16_kernel(const float* __restrict__ w, size_t n,
                                  float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = __bfloat162float(__float2bfloat16_rn(w[e]));
}

// The register-blocked route (groups and combine) on f32 inputs.
template <bool SPLIT>
int launch_gemm(const Inputs& xs, const float* w, const float* scale,
                const float* bias, float* part, float* out, int B, int N,
                int E, float slope, int with_mean, cudaStream_t st) {
  int per, groups;
  pool_groups(B, N, E, &per, &groups);
  if (groups > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_pool_gemm_kernel<SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_POOL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((E + dg::G128_N - 1) / dg::G128_N, groups, B);
  conv_pool_gemm_kernel<SPLIT><<<grid, dg::G128_THREADS, GEMM_POOL_SMEM,
                                 st>>>(xs, N, w, E, scale, bias, slope, per,
                                       groups, with_mean, part, out);
  e = cudaGetLastError();
  if (e != cudaSuccess || groups == 1) return (int)e;
  conv_pool_combine_kernel<<<(B * E + 255) / 256, 256, 0, st>>>(
      part, B, groups, N, E, with_mean, out);
  return (int)cudaGetLastError();
}

int check_inputs(const float* const* ps, const int* cs, int n_inputs, int B,
                 int N, int E, Inputs* xs) {
  if (n_inputs < 1 || n_inputs > MAX_INPUTS || B < 1 || N < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < MAX_INPUTS; ++q) {
    xs->p[q] = ps[q];
    xs->c[q] = q < n_inputs ? cs[q] : 0;
    if (q < n_inputs && cs[q] < 1) return (int)cudaErrorInvalidValue;
  }
  xs->n = n_inputs;
  return 0;
}

int launch_tile64(const Inputs& xs, const float* w, const float* scale,
                  const float* bias, float* out, int B, int N, int E,
                  float slope, int with_mean, cudaStream_t st) {
  const dim3 grid((E + dg::GEMM_BN - 1) / dg::GEMM_BN, B);
  conv_pool_kernel<<<grid, dg::GEMM_THREADS, 0, st>>>(
      xs, N, w, E, scale, bias, slope, with_mean, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the scratch `part` that dg_conv_pool needs at this shape (0
// when one group a cloud writes the output itself).
extern "C" int dg_conv_pool_scratch_floats(int B, int N, int E) {
  if (B < 1 || N < 1 || E < 1) return 0;
  int per, groups;
  pool_groups(B, N, E, &per, &groups);
  return groups > 1 ? B * groups * 2 * E : 0;
}

// xs: n_inputs (<= 4) tensors (B, N, c_q); w (sum c_q, E); scale/bias (E,);
// part: dg_conv_pool_scratch_floats(B, N, E) floats of scratch; out (B,
// with_mean ? 2 : 1, E); all f32, contiguous, on the device.  Returns the
// first CUDA error.
extern "C" int dg_conv_pool(const float* x0, const float* x1, const float* x2,
                            const float* x3, int c0, int c1, int c2, int c3,
                            int n_inputs, const float* w, const float* scale,
                            const float* bias, float* part, float* out, int B,
                            int N, int E, float slope, int with_mean,
                            void* stream) {
  const float* ps[MAX_INPUTS] = {x0, x1, x2, x3};
  const int cs[MAX_INPUTS] = {c0, c1, c2, c3};
  Inputs xs;
  if (int rc = check_inputs(ps, cs, n_inputs, B, N, E, &xs)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  bool gemm = E % 4 == 0 && aligned16(w);
  for (int q = 0; q < n_inputs; ++q)
    gemm = gemm && cs[q] % 4 == 0 && aligned16(ps[q]);
  if (!gemm)
    return launch_tile64(xs, w, scale, bias, out, B, N, E, slope, with_mean,
                         st);
  return launch_gemm<false>(xs, w, scale, bias, part, out, B, N, E, slope,
                            with_mean, st);
}

// The AMP form: xs bf16 (B, N, c_q), c_q and E multiples of 4; w (sum
// c_q, E), scale/bias (E,) f32; scratch xf (B * N * sum c_q floats: the
// inputs in f32, one after another) and wb (sum c_q * E floats: w rounded
// to bf16), part as dg_conv_pool; out (B, with_mean ? 2 : 1, E) f32.
// Returns the first CUDA error.
extern "C" int dg_conv_pool_amp(const void* x0, const void* x1,
                                const void* x2, const void* x3, int c0,
                                int c1, int c2, int c3, int n_inputs,
                                const float* w, const float* scale,
                                const float* bias, float* xf, float* wb,
                                float* part, float* out, int B, int N, int E,
                                float slope, int with_mean, void* stream) {
  const void* ps[MAX_INPUTS] = {x0, x1, x2, x3};
  const int cs[MAX_INPUTS] = {c0, c1, c2, c3};
  const float* fs[MAX_INPUTS] = {nullptr, nullptr, nullptr, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (n_inputs < 1 || n_inputs > MAX_INPUTS || E % 4 != 0 || B < 1 ||
      N < 1)
    return (int)cudaErrorInvalidValue;
  size_t off = 0;
  for (int q = 0; q < n_inputs; ++q) {
    if (cs[q] < 1 || cs[q] % 4 != 0) return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)B * N * cs[q];
    upcast_bf16_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        reinterpret_cast<const __nv_bfloat16*>(ps[q]), n, xf + off);
    fs[q] = xf + off;
    off += n;
  }
  const size_t wn = (off / ((size_t)B * N)) * E;
  round_bf16_kernel<<<(wn + 255) / 256, 256, 0, st>>>(w, wn, wb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Inputs xs;
  if (int rc = check_inputs(fs, cs, n_inputs, B, N, E, &xs)) return rc;
  return launch_gemm<true>(xs, wb, scale, bias, part, out, B, N, E, slope,
                           with_mean, st);
}

// As dg_conv_pool at any shape on the first form (conv_pool_kernel): the
// earlier side of the A/B and of chip_smoke.py's checks.
extern "C" int dg_conv_pool_tile64(const float* x0, const float* x1,
                                   const float* x2, const float* x3, int c0,
                                   int c1, int c2, int c3, int n_inputs,
                                   const float* w, const float* scale,
                                   const float* bias, float* out, int B,
                                   int N, int E, float slope, int with_mean,
                                   void* stream) {
  const float* ps[MAX_INPUTS] = {x0, x1, x2, x3};
  const int cs[MAX_INPUTS] = {c0, c1, c2, c3};
  Inputs xs;
  if (int rc = check_inputs(ps, cs, n_inputs, B, N, E, &xs)) return rc;
  return launch_tile64(xs, w, scale, bias, out, B, N, E, slope, with_mean,
                       (cudaStream_t)stream);
}
