// An earlier form of csrc/attention_fwd.cu, not built into the library:
// tools/attention_ab.py times it against the kernel (PERF.md, Findings).
// Against the kernel's first form it pads shared rows by 4 floats so that
// every read of both products is a 16-byte float4 load, and each thread
// owns 4 adjacent output columns; it still copies 4 bytes a cp.async and
// leaves ptxas the default register budget.
//
// attention_fwd: multi-head softmax attention, forward, in f32 on Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::_attn_fwd_impl
// (body _attn_fwd_kernel) at dropout rate 0, the attention of every
// TorchMultiheadAttention of the fusion Net:
//
//   o[b, h] = softmax(q[b, h] k[b, h]^T * scale) v[b, h]
//
// q (B, h, Nq, d), k and v (B, h, Nk, d), o (B, h, Nq, d), each given by
// its base and its (b, h, row) strides with unit stride along d, so that
// the heads of a (B, N, h * d) projection are read in place and o can be
// written as (B, Nq, h * d).  The TPU kernel takes bf16 or f32 products on
// the MXU; here every product and sum is f32 on the CUDA cores (no TF32),
// the dense exact function to rounding.
//
// Bound on an H100 SXM: operations.  At the fusion Net's stacked shape
// (B=32, h=2, N=2048, d=256) one call is 2 products of 2*B*h*N^2*d flops,
// 2.7e11, ~4.1 ms at the f32 CUDA-core peak (67 TFLOP/s), plus B*h*N^2
// exponentials; q, k, v and o are 4 * 134 MB, ~0.16 ms at 3.35 TB/s.
//
// Design: flash attention's online softmax, so the (Nq, Nk) scores never
// reach device memory.  A block of 256 threads (16 x 16) owns BQ query rows
// of one (b, h): the Q tile stays in shared memory, key and value tiles of
// BK rows stream through shared memory by cp.async (V of a tile lands while
// its scores are computed, K of the next tile while P.V runs).  Thread
// (ty, tx) computes the scores of rows ty + 16 i and columns tx + 16 j of a
// tile, keeps the running max and sum of its rows (reduced over the 16 tx
// lanes by shuffles), writes P = exp(s - max) to shared memory, and
// accumulates columns 4 tx + 64 g .. + 3 of its rows of O in registers
// (D / 16 * BQ / 16 floats: 64 at d = 256 and d = 512, where BQ drops to
// 32).  Shared rows are padded by 4 floats.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16

template <int D>
struct Tile {
  static constexpr int BQ = D >= 512 ? 32 : 64;  // query rows a block
  static constexpr int BK = D >= 512 ? 32 : 64;  // keys a tile
  static constexpr int RQ = BQ / 16;             // rows a thread
  static constexpr int CS = BK / 16;             // score columns a thread
  static constexpr int CG = D / 64;              // output float4s a thread
  static constexpr int QS = D + 4;               // Q/K/V row stride (floats)
  static constexpr int PS = BK + 4;              // P row stride (floats)
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * QS + (size_t)BQ * PS);
};

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows [r0, r0 + rows) of a (nrows, D) matrix with row
// stride `stride` into `dst` (row stride D + 4); rows past nrows are zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int rows,
                                          int nrows) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    const bool in = r0 + r < nrows;
    copy4(dst + r * (D + 4) + c, in ? src + (r0 + r) * stride + c : src, in);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int Nq, int Nk, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RQ = T::RQ, CS = T::CS, CG = T::CG;
  constexpr int QS = T::QS, PS = T::PS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * QS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = q + bz * sq.b + hh * sq.h;
  const float* kb = k + bz * sk.b + hh * sk.h;
  const float* vb = v + bz * sv.b + hh * sv.h;

  load_rows<D>(Qs, qb, sq.n, q0, BQ, Nq);
  load_rows<D>(Ks, kb, sk.n, 0, BK, Nk);
  commit();
  wait_groups<0>();
  __syncthreads();

  // acc[i][g]: row ty + 16 i, columns 4 tx + 64 g .. + 3 of the output
  float4 acc[RQ][CG];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    load_rows<D>(Vs, vb, sv.n, k0, BK, Nk);
    commit();
    // scores of rows ty + 16 i and columns tx + 16 j, four d at a time
    float s[RQ][CS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      float4 qr[RQ], kc[CS];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qr[i] = ld4(Qs + (ty + 16 * i) * QS + dd);
#pragma unroll
      for (int j = 0; j < CS; ++j) kc[j] = ld4(Ks + (tx + 16 * j) * QS + dd);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          s[i][j] = fmaf(qr[i].x, kc[j].x, s[i][j]);
          s[i][j] = fmaf(qr[i].y, kc[j].y, s[i][j]);
          s[i][j] = fmaf(qr[i].z, kc[j].z, s[i][j]);
          s[i][j] = fmaf(qr[i].w, kc[j].w, s[i][j]);
        }
    }
    // online softmax: running max and sum of each row over the 16 tx lanes
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        s[i][j] = k0 + tx + 16 * j < Nk ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        acc[i][g].x *= alpha;
        acc[i][g].y *= alpha;
        acc[i][g].z *= alpha;
        acc[i][g].w *= alpha;
      }
    }
    __syncthreads();  // every thread is done with Ks; Ps is complete
    if (k0 + BK < Nk) load_rows<D>(Ks, kb, sk.n, k0 + BK, BK, Nk);
    commit();
    wait_groups<1>();  // this thread's copies of V have landed
    __syncthreads();   // and every thread's
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float4 pr[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pr[i] = ld4(Ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 vv = ld4(Vs + (c + u) * QS + 4 * tx + 64 * g);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float p = u == 0 ? pr[i].x
                            : u == 1 ? pr[i].y
                            : u == 2 ? pr[i].z
                                     : pr[i].w;
            acc[i][g].x = fmaf(p, vv.x, acc[i][g].x);
            acc[i][g].y = fmaf(p, vv.y, acc[i][g].y);
            acc[i][g].z = fmaf(p, vv.z, acc[i][g].z);
            acc[i][g].w = fmaf(p, vv.w, acc[i][g].w);
          }
        }
      }
    }
    wait_groups<0>();  // the next K tile
    __syncthreads();   // and every thread is done with Vs and Ps
  }

  float* ob = o + bz * so.b + hh * so.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Nq) {
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        float* dst = ob + r * so.n + 4 * tx + 64 * g;
        dst[0] = acc[i][g].x / l[i];
        dst[1] = acc[i][g].y / l[i];
        dst[2] = acc[i][g].z / l[i];
        dst[3] = acc[i][g].w / l[i];
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int Nq, int Nk, const long long* st,
                   float scale, cudaStream_t stream) {
  using T = Tile<D>;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Nq + T::BQ - 1) / T::BQ, H, B);
  attn_fwd_kernel<D><<<grid, THREADS, T::SMEM, stream>>>(
      q, k, v, o, Nq, Nk, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D), o (B, H, Nq, D), f32 on the
// device, unit stride along D; strides (host, 12 values) are the (b, h,
// row) strides in elements of q, k, v and o.  D is 128, 256 or 512.
// Returns the first CUDA error.
extern "C" int dg_attention_fwd(const float* q, const float* k,
                                const float* v, float* o, int B, int H,
                                int Nq, int Nk, int D,
                                const long long* strides, float scale,
                                void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 128:
      return (int)launch<128>(q, k, v, o, B, H, Nq, Nk, strides, scale, st);
    case 256:
      return (int)launch<256>(q, k, v, o, B, H, Nq, Nk, strides, scale, st);
    case 512:
      return (int)launch<512>(q, k, v, o, B, H, Nq, Nk, strides, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
