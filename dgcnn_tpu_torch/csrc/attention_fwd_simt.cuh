// The CUDA-core form of kernel 14 (attention_fwd.cu): every product and
// sum in f32 FFMA on the CUDA cores.  attention_fwd.cu runs it at d = 512,
// where the tensor-core form's output accumulator (16 rows of 512 columns
// a warp) does not fit in registers; tools/attention_forms/
// attention_fwd_simt.cu runs it at every head dim, for tools/attention_ab.py
// to time against the tensor-core form.
//
// o[b, h] = dropout(softmax(q[b, h] k[b, h]^T * scale)) v[b, h], as in
// attention_fwd.cu: dropout keeps a probability when its bit of the stream
// of attention.cuh says so and scales it by 1 / (1 - rate); the row's
// softmax sum is taken over the probabilities before the mask.  Training
// also writes each row's log-sum-exp.
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
// lanes by shuffles), writes P = exp(s - max) (dropped and scaled in
// training) to shared memory, and accumulates columns 4 tx + 64 g .. + 3
// of its rows of O in registers (D / 16 * BQ / 16 floats: 64 at d = 256
// and d = 512, where BQ drops to 32).  Shared rows are padded by 4 floats,
// so every read of both products is a 16-byte float4 load and a warp's K
// and V reads are conflict-free.  The tiles take ~212 KB of shared memory
// at d = 256, one block an SM (up to 255 registers a thread); every row of
// q, k and v starts 16-byte aligned (the wrapper, ops/attention.py, copies
// an input that does not).  It reaches ~0.48 of its f32 bound on an H100
// (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"

namespace dg_simt {

using namespace dg_attn;

template <int D>
struct SimtTile {
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

// Training adds the dropout of the probabilities (DROPOUT: the stream of
// `seed`, kept when the draw is >= thresh, scaled by inv) and the
// log-sum-exp of each row, written to lse (LSE; (B, H, Nq) contiguous).
template <int D, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    attn_fwd_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int Nq, int Nk, Strides sq, Strides sk, Strides sv,
                         Strides so, float scale, const long long* seed,
                         unsigned thresh, float inv,
                         float* __restrict__ lse) {
  using T = SimtTile<D>;
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
  unsigned long long key[DROPOUT ? RQ : 1];
  if constexpr (DROPOUT) {
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      key[i] = row_key(*seed, bz, hh, q0 + ty + 16 * i);
  }
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
#pragma unroll 4
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
        if constexpr (DROPOUT)
          Ps[(ty + 16 * i) * PS + tx + 16 * j] =
              keep(key[i], k0 + tx + 16 * j, thresh) ? p * inv : 0.f;
        else
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
    if constexpr (LSE) {
      if (tx == 0 && r < Nq)
        lse[((long long)bz * gridDim.y + hh) * Nq + r] = m[i] + logf(l[i]);
    }
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

template <int D, bool DROPOUT, bool LSE>
inline cudaError_t launch_simt(const float* q, const float* k,
                               const float* v, float* o, int B, int H,
                               int Nq, int Nk, const long long* st,
                               float scale, const long long* seed,
                               unsigned thresh, float inv, float* lse,
                               cudaStream_t stream) {
  using T = SimtTile<D>;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_simt_kernel<D, DROPOUT, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Nq + T::BQ - 1) / T::BQ, H, B);
  attn_fwd_simt_kernel<D, DROPOUT, LSE><<<grid, THREADS, T::SMEM, stream>>>(
      q, k, v, o, Nq, Nk, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale, seed, thresh, inv, lse);
  return cudaGetLastError();
}

}  // namespace dg_simt
