// conv_pool_wgmma: kernel 2's AMP form on Hopper's tensor cores (wgmma,
// fed by TMA), the route of every model's shapes.
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_pool.py::fused_conv_pool in
// its AMP mode (compute_dtype=bf16, :31-55), the JAX package's default:
//
//   h = sum_q bf16(x_q) @ bf16(W_q)    f32 sums, the inputs in order
//   y = LeakyReLU(h * s + t)           (B, N, E), never stored
//   out[b, 0] = max_n y[b, n],  out[b, 1] = mean_n y[b, n]
//
// x_q (B, N, c_q) are the bf16 stage outputs as they come; W (sum c_q, E)
// f32 is rounded to bf16 once a call and written transposed, (E, sum
// c_q), so that both operands are K-major (wt_round_kernel).
//
// Bound on an H100 SXM: operations.  At the DGCNNCls head (B=64, N=1024,
// C=512, E=1024) the product is 2*B*N*C*E ~ 69 GFLOP: ~0.07 ms at the
// dense bf16 tensor-core rate (989 TFLOP/s), against ~67 MB of bf16 stage
// outputs read (~0.02 ms at 3.35 TB/s).  The earlier AMP form
// (conv_pool.cu, dg_conv_pool_amp) ran it at the CUDA cores' f32 rate
// after an f32 copy of the inputs.
//
// Design: a block of two warpgroups (256 threads) owns one 128-column
// tile of E (blockIdx.x) and walks a run of `per` consecutive 128-row
// tiles of one cloud (blockIdx.z; row group blockIdx.y: pool_groups, the
// earlier routes' partition, sized here for one block an SM).  Lane 0 of
// warp 0 also feeds the block, between its own steps: it loads the column
// tile's 128 rows of W^T once (all C channels, 128-byte swizzle, in
// blocks of 64 channels: at most 160 KB), then streams the row tiles' k
// chunks (64 channels of one input, 128 rows of x_q, 16 KB) by TMA into a
// ring of stages, each completed on its `full` mbarrier; a row tile's rows
// past N (and W^T's past E) arrive as zeros.  Keeping W^T resident halves
// what the blocks read from L2: the product reads only x's chunks, at 128
// flops a byte.  (A producer warp of its own would make ptxas hold every
// thread to the registers of three warpgroups, 168.)  Each warpgroup takes
// 64 of a tile's rows: one chain of m64n128k16 wgmma (four a chunk) over
// every input's chunks in order into an f32 accumulator.  The TPU kernel
// sums each input's product apart and adds them in f32; one chain keeps
// the tensor core from draining at each input's end, and its sums stay
// within rel 1e-5 of the split ones (the contract of chip_smoke.py's
// phases 34 and 84; the tensor core's sum truncates: at most 512 channels,
// 32 steps, a chain in every model).  A chunk's stage is released
// (`empty`, each warp) once the next chunk's products are under way and its
// own are done.  The epilogue stays in registers: the folded BN affine
// and the LeakyReLU (__fmul_rn, __fadd_rn: no FMA) of the thread's two
// rows, folded into its running max and sum of its 32 columns, rows and
// tiles ascending; after the last tile each column is folded over the
// warp's row lanes by shuffles and over the 8 warps in warp order.  One
// group writes the pooled rows; several write partial rows that
// conv_pool.cu's combine kernel adds in group order.  No atomics: the same
// bits from call to call.
//
// Shapes: every input width a multiple of 64 (the chunk; 64, 128, 192,
// 256 in every model), at most 640 channels in all (W^T's slice; 512 at
// most in every model), E a multiple of 8 (the map's row stride), 16-byte
// aligned bases.  ops/conv_pool_kernel.py::amp_route decides before the
// launch; other shapes take the earlier form.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cstdint>

#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace dg {
// conv_pool.cu: the row groups of the earlier routes, sized for `blocks`
// blocks, and the combine of their partial rows.
void pool_groups_for(int B, int N, int E, int blocks, bool balanced,
                     int* per, int* groups);
cudaError_t launch_pool_combine(const float* part, int B, int groups, int N,
                                int E, int with_mean, float* out,
                                cudaStream_t st);
}  // namespace dg

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_INPUTS = 4;
constexpr int BM = 128, BN = 128, BK = 64;  // row tile, column tile, chunk
constexpr int THREADS = 256;                // two warpgroups
constexpr int XTILE = BM * BK * 2;          // 16 KB: a chunk of x's rows
constexpr int WBLK = BN * BK * 2;           // 16 KB: 64 channels of W^T's
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 640;                  // the most channels W^T holds
constexpr int MAX_ST = 8;                   // stages of the ring, at most
// one block an SM (W^T's slice and the ring take most of its shared
// memory): two waves
constexpr int WG_POOL_BLOCKS = 2 * 132;
constexpr size_t FIXED = 1024 + sizeof(float) * (2 * WARPS * BN + 2 * BN) +
                         sizeof(uint64_t) * (2 * MAX_ST + 1);
constexpr size_t SMEM_MAX = 232448;

// The ring's stages at C channels: as many as fit beside W^T's slice.
int stages(int C) {
  const size_t left = SMEM_MAX - FIXED - (size_t)(C / BK) * WBLK;
  return (int)std::min<size_t>(MAX_ST, left / XTILE);
}
size_t smem_bytes(int C) {
  return FIXED + (size_t)(C / BK) * WBLK + (size_t)stages(C) * XTILE;
}

struct Args {
  int c[MAX_INPUTS];  // input widths, 0 past n
  int n, N, E;
  const float* scale;
  const float* bias;
  float slope;
  int per, groups, with_mean;
  int st;  // stages of the ring
  float* part;
  float* out;
};

// Input q's width (selected, not indexed: a runtime index into the
// parameter array would copy it to local memory).
__device__ __forceinline__ int width(const Args& a, int q) {
  return q == 0 ? a.c[0] : q == 1 ? a.c[1] : q == 2 ? a.c[2] : a.c[3];
}

__global__ void __launch_bounds__(THREADS, 1)
    conv_pool_wgmma_kernel(const __grid_constant__ CUtensorMap mx0,
                           const __grid_constant__ CUtensorMap mx1,
                           const __grid_constant__ CUtensorMap mx2,
                           const __grid_constant__ CUtensorMap mx3,
                           const __grid_constant__ CUtensorMap mw, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int C = a.c[0] + a.c[1] + a.c[2] + a.c[3], ST = a.st;
  uint8_t* Ws = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* ring = Ws + (C / BK) * WBLK;
  float* red_max = reinterpret_cast<float*>(ring + ST * XTILE);
  float* red_sum = red_max + WARPS * BN;  // [WARPS][BN] each
  float* sc = red_sum + WARPS * BN;       // the tile's scale and bias
  float* bi = sc + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + BN);
  uint64_t* empty = full + MAX_ST;
  uint64_t* wbar = empty + MAX_ST;

  const int n0 = blockIdx.x * BN, g = blockIdx.y, b = blockIdx.z;
  const int N = a.N, E = a.E;
  const int t0 = g * a.per;
  const int tiles = min((N + BM - 1) / BM, t0 + a.per) - t0;
  const int chunks = C / BK;  // a row tile's; chunk u meets W^T's block u
  const int total = tiles * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      dg_tma::bar_init(&full[s], 1);
      dg_tma::bar_init(&empty[s], WARPS);
    }
    dg_tma::bar_init(wbar, 1);
    dg_tma::fence_barrier_init();
  }
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, gq = lane >> 2, tq = lane & 3;
  // The producer is lane 0 of warp 0, between its own steps: the column
  // tile's rows of W^T once, then the row tiles' chunks in order, each into
  // its stage once every warp has released the chunk before it there.  The
  // warp waits for its lane 0 before it goes on (wgmma takes the whole
  // warpgroup).
  int loaded = 0, pq = 0, pk0 = 0, pt = 0;
  auto refill = [&](int upto) {
    if (tid < 32) {
      if (tid == 0)
        for (; loaded < upto && loaded < total; ++loaded) {
          const int s = loaded % ST;
          dg_tma::wait(&empty[s], ((loaded / ST) & 1) ^ 1);
          dg_tma::arrive_expect_tx(&full[s], XTILE);
          const CUtensorMap* m = pq == 0 ? &mx0 : pq == 1 ? &mx1
                                 : pq == 2 ? &mx2 : &mx3;
          dg_tma::load_3d(ring + s * XTILE, m, &full[s], pk0,
                          (t0 + pt) * BM, b);
          // the next chunk: the inputs in order, then the next row tile
          pk0 += BK;
          if (pk0 == width(a, pq)) {
            pk0 = 0;
            if (++pq == a.n) {
              pq = 0;
              ++pt;
            }
          }
        }
      __syncwarp();
    }
  };
  if (tid == 0) {
    dg_tma::arrive_expect_tx(wbar, chunks * WBLK);
    for (int u = 0; u < chunks; ++u)
      dg_tma::load_2d(Ws + u * WBLK, &mw, wbar, u * BK, n0);
  }
  refill(ST);
  if (tid < BN) {
    const int col = n0 + tid;
    sc[tid] = col < E ? a.scale[col] : 0.f;
    bi[tid] = col < E ? a.bias[col] : 0.f;
  }
  __syncthreads();
  dg_tma::wait(wbar, 0);

  // each thread's running max and sum of its rows in its 32 columns,
  // c[2 j + c]: column 8 j + 2 tq + c
  float cmax[BN / 4], csum[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
    cmax[i] = -INFINITY;
    csum[i] = 0.f;
  }
  // tot: the tile's sum, one chain over every input's chunks in order
  float tot[BN / 2];
  int it = 0;
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
#pragma unroll 1
    for (int u = 0; u < chunks; ++u, ++it) {
      const int s = it % ST;
      // this warp still holds chunk it - 1 (released below, once chunk
      // it's products are under way): fill up to the stage before it
      refill(it + ST - 1);
      dg_tma::wait(&full[s], (it / ST) & 1);
      const uint64_t da =
          dg_wgmma::desc(ring + s * XTILE + wg * (XTILE / 2));
      const uint64_t db = dg_wgmma::desc(Ws + u * WBLK);
      if (u == 0) dg_wgmma::fence();  // the tile's chain starts
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        dg_wgmma::mma_ss_n128<0>(tot, da + 2 * kk, db + 2 * kk,
                                 u > 0 || kk > 0);
      dg_wgmma::commit();
      // the previous chunk's products are done: its stage is free
      if (u > 0) {
        dg_wgmma::wait<1>();
        dg_tma::arrive_warp(&empty[(it - 1) % ST]);
      }
    }
    dg_wgmma::wait<0>();
    dg_tma::arrive_warp(&empty[(it - 1) % ST]);
    dg_wgmma::hold(tot);
    // the tile is done: affine, LeakyReLU, and the fold of the thread's
    // two rows into its running max and sum, rows ascending
    const int r0 = (t0 + t) * BM + 64 * wg + 16 * (warp & 3) + gq;
    const bool v0 = r0 < N, v1 = r0 + 8 < N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tq + c;
        float y0 = __fadd_rn(__fmul_rn(tot[4 * j + c], sc[col]), bi[col]);
        float y1 = __fadd_rn(__fmul_rn(tot[4 * j + 2 + c], sc[col]),
                             bi[col]);
        y0 = y0 >= 0.f ? y0 : __fmul_rn(a.slope, y0);
        y1 = y1 >= 0.f ? y1 : __fmul_rn(a.slope, y1);
        float& mx = cmax[2 * j + c];
        float& sm = csum[2 * j + c];
        if (v0) {
          mx = fmaxf(mx, y0);
          sm = __fadd_rn(sm, y0);
        }
        if (v1) {
          mx = fmaxf(mx, y1);
          sm = __fadd_rn(sm, y1);
        }
      }
  }

  // each column over the warp's 8 row lanes by shuffles, then the 8 warps
  // in warp order
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float mx = cmax[2 * j + c], sm = csum[2 * j + c];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        sm = __fadd_rn(sm, __shfl_xor_sync(0xffffffffu, sm, o));
      }
      if (gq == 0) {
        red_max[warp * BN + 8 * j + 2 * tq + c] = mx;
        red_sum[warp * BN + 8 * j + 2 * tq + c] = sm;
      }
    }
  __syncthreads();
  if (tid < BN) {
    const int col = n0 + tid;
    if (col < E) {
      float m = -INFINITY, s = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        m = fmaxf(m, red_max[w * BN + tid]);
        s = __fadd_rn(s, red_sum[w * BN + tid]);
      }
      if (a.groups == 1) {
        const int rows = a.with_mean ? 2 : 1;
        a.out[((size_t)b * rows) * E + col] = m;
        if (a.with_mean)
          a.out[((size_t)b * rows + 1) * E + col] = __fdiv_rn(s, (float)N);
      } else {
        float* pr = a.part + ((size_t)b * a.groups + g) * 2 * E;
        pr[col] = m;
        pr[E + col] = s;
      }
    }
  }
}

// wt (E, C) = bf16(w (C, E)), transposed.
__global__ void wt_round_kernel(const float* __restrict__ w, int C, int E,
                                bf16* __restrict__ wt) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.y * 32, e0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, e = e0 + threadIdx.x;
    tile[r][threadIdx.x] = c < C && e < E ? w[(size_t)c * E + e] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int e = e0 + r, c = c0 + threadIdx.x;
    if (e < E && c < C)
      wt[(size_t)e * C + c] = __float2bfloat16_rn(tile[threadIdx.x][r]);
  }
}

void groups_of(int B, int N, int E, int* per, int* groups) {
  dg::pool_groups_for(B, N, E, WG_POOL_BLOCKS, true, per, groups);
}

}  // namespace

// Floats of the scratch `part` that dg_conv_pool_amp_wgmma needs (0 when
// one group a cloud writes the output itself).
extern "C" int dg_conv_pool_wgmma_scratch_floats(int B, int N, int E) {
  if (B < 1 || N < 1 || E < 1) return 0;
  int per, groups;
  groups_of(B, N, E, &per, &groups);
  return groups > 1 ? B * groups * 2 * E : 0;
}

// The AMP form on the tensor cores: xs bf16 (B, N, c_q), each c_q a
// multiple of 64, 16-byte aligned; w (sum c_q, E) f32, E a multiple of 8;
// scale/bias (E,) f32; scratch wt (E * sum c_q bf16: w rounded and
// transposed) and part (dg_conv_pool_wgmma_scratch_floats); out (B,
// with_mean ? 2 : 1, E) f32.  Returns the first CUDA error
// (cudaErrorNotSupported: cuTensorMapEncodeTiled refused a tensor map).
extern "C" int dg_conv_pool_amp_wgmma(const void* x0, const void* x1,
                                      const void* x2, const void* x3, int c0,
                                      int c1, int c2, int c3, int n_inputs,
                                      const float* w, const float* scale,
                                      const float* bias, void* wt,
                                      float* part, float* out, int B, int N,
                                      int E, float slope, int with_mean,
                                      void* stream) {
  const void* ps[MAX_INPUTS] = {x0, x1, x2, x3};
  const int cs[MAX_INPUTS] = {c0, c1, c2, c3};
  if (n_inputs < 1 || n_inputs > MAX_INPUTS || B < 1 || N < 1 || E < 8 ||
      E % 8 != 0 || (size_t)wt % 16 != 0 || c0 + c1 + c2 + c3 > MAX_C)
    return (int)cudaErrorInvalidValue;
  Args a{};
  int C = 0;
  for (int q = 0; q < MAX_INPUTS; ++q) {
    a.c[q] = q < n_inputs ? cs[q] : 0;
    if (q < n_inputs &&
        (cs[q] < BK || cs[q] % BK != 0 || (size_t)ps[q] % 16 != 0))
      return (int)cudaErrorInvalidValue;
    C += a.c[q];
  }
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap maps[MAX_INPUTS + 1];
  for (int q = 0; q < MAX_INPUTS; ++q) {
    const int src = q < n_inputs ? q : 0;  // unread maps repeat input 0
    const uint64_t dims[3] = {(uint64_t)cs[src], (uint64_t)N, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)cs[src] * 2,
                                 (uint64_t)cs[src] * 2 * N};
    const uint32_t box[3] = {BK, BM, 1};
    if (!dg_tma::encode_bf16(&maps[q], ps[src], 3, dims, strides, box))
      return (int)cudaErrorNotSupported;
  }
  {
    const uint64_t dims[2] = {(uint64_t)C, (uint64_t)E};
    const uint64_t strides[1] = {(uint64_t)C * 2};
    const uint32_t box[2] = {BK, BN};
    if (!dg_tma::encode_bf16(&maps[MAX_INPUTS], wt, 2, dims, strides, box))
      return (int)cudaErrorNotSupported;
  }
  wt_round_kernel<<<dim3((E + 31) / 32, (C + 31) / 32), dim3(32, 8), 0,
                    st>>>(w, C, E, static_cast<bf16*>(wt));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  a.n = n_inputs;
  a.N = N;
  a.E = E;
  a.scale = scale;
  a.bias = bias;
  a.slope = slope;
  a.with_mean = with_mean;
  a.part = part;
  a.out = out;
  groups_of(B, N, E, &a.per, &a.groups);
  if (a.groups > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  a.st = stages(C);
  e = cudaFuncSetAttribute(conv_pool_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((E + BN - 1) / BN, a.groups, B);
  conv_pool_wgmma_kernel<<<grid, THREADS, smem_bytes(C), st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.groups == 1) return (int)e;
  return (int)dg::launch_pool_combine(part, B, a.groups, N, E, with_mean,
                                      out, st);
}
