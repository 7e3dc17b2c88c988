// The earlier form of csrc/attention_bwd.cu (every product an FFMA loop on
// the CUDA cores), not built into the library: tools/attention_ab.py
// --kernel bwd times it against the kernel (PERF.md, Findings).
//
// attention_bwd: the backward of multi-head softmax attention with dropout
// on the probabilities, in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::_attn_bwd_impl
// (body _attn_bwd_kernel).  From q, k, v, the forward's output o and
// log-sum-exp lse (attention_fwd.cu, training form), the dropout seed and
// the output's cotangent dO, with s = q k^T * scale:
//
//   P  = exp(s - lse)                   the softmax, rebuilt in one pass
//   P~ = mask * P / (1 - rate)          the mask regenerated from the seed
//   dv = P~^T dO
//   dP = mask * (dO v^T) / (1 - rate)
//   dS = P * (dP - Delta),  Delta_i = rowsum(dO_i * o_i)
//   dq = dS k * scale,      dk = dS^T q * scale
//
// Delta equals the TPU kernel's rowsum(dP * P) (o_i = sum_j P~_ij v_j).
// Nothing of size (Nq, Nk) reaches device memory, the mask neither: each
// kernel draws its bits from the stream of attention.cuh.
//
// Bound on an H100 SXM: operations.  The five products the TPU kernel
// counts (s, dO v^T, dv, dq, dk: 5 * 2 * B*h*Nq*Nk*d flops) are 6.9e11 at
// the fusion Net's stacked shape (B=32, h=2, N=2048, d=256), ~10.3 ms at
// the f32 CUDA-core peak (67 TFLOP/s); q, k, v, o, dO, dq, dk and dv are
// 8 * 134 MB, ~0.3 ms at 3.35 TB/s.
//
// Design: three launches, and no atomics, so that every sum runs in an
// order fixed from run to run:
//   1. delta_kernel: a warp a row, Delta = rowsum(dO * o).
//   2. dkdv_kernel: a block per (b, h, tile of BK keys) holds its K and V
//      tiles in shared memory and loops over the query tiles of BQ rows:
//      it recomputes s and dO v^T for the tile (both products in one pass
//      over d), forms P~ and dS * scale in shared memory, and adds P~^T dO
//      and dS^T q into dv and dk, held in registers (BK * D * 2 / 256 = 64
//      floats a thread).  The key tiles are independent: no cross-block
//      sum, unlike the TPU kernel's accumulation over its sequential grid.
//   3. dq_kernel: a block per (b, h, tile of BQ queries) holds its Q and dO
//      tiles and loops over the key tiles: the same scores, then dS k into
//      dq in registers.
// The tiles (BK = 8192 / D keys, BQ = 64 queries, 32 at d = 512) keep each
// block's shared memory under 227 KB at one block an SM; rows are padded
// by 4 floats, so that every read of a product is a float4 or a broadcast.
// Thread (ty, tx) computes the scores of rows ty + 16 i and columns tx +
// 16 j of a tile, and owns output columns 4 tx + 64 g .. + 3.  A first
// form: the copies are not overlapped with the products.  Its times on an
// H100 against its bound are in PERF.md (chip_smoke.py, phase 31).
#include <cuda_runtime.h>
#include <math.h>

#include "../../csrc/attention.cuh"

namespace {

using namespace dg_attn;

template <int D>
struct BwdTile {
  static constexpr int BK = 8192 / D;            // keys a tile
  static constexpr int BQ = D >= 512 ? 32 : 64;  // queries a tile
  static constexpr int RQ = BQ / 16;             // score rows a thread
  static constexpr int CK = BK / 16;             // score columns a thread
  static constexpr int RK = BK / 16;             // dk / dv rows a thread
  static constexpr int CG = D / 64;              // output float4s a row
  static constexpr int QS = D + 4;               // Q/dO/K/V row stride
  static constexpr int PS = BK + 4;              // P~ / dS row stride
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * QS + 2 * (size_t)BQ * PS +
                       2 * BQ);
};

// Delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d]: a warp a row, the
// lanes' partial sums reduced in a fixed order.
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int Nq, int D, Strides so,
                 Strides sdo) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= Nq) return;
  const int bz = blockIdx.z, hh = blockIdx.y;
  const float* orow = o + bz * so.b + hh * so.h + row * so.n;
  const float* drow = dout + bz * sdo.b + hh * sdo.h + row * sdo.n;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)bz * gridDim.y + hh) * Nq + row] = acc;
}

// The scores of one (query tile, key tile) pair: s = Qs Ks^T and dp = dOs
// Vs^T for rows ty + 16 i and columns tx + 16 j, four d at a time.
template <int D, int RQ, int CK>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            float (&s)[RQ][CK],
                                            float (&dp)[RQ][CK]) {
  constexpr int QS = D + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int dd = 0; dd < D; dd += 4) {
    float4 qr[RQ], dr[RQ], kc[CK], vc[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qr[i] = ld4(Qs + (ty + 16 * i) * QS + dd);
      dr[i] = ld4(dOs + (ty + 16 * i) * QS + dd);
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kc[j] = ld4(Ks + (tx + 16 * j) * QS + dd);
      vc[j] = ld4(Vs + (tx + 16 * j) * QS + dd);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(qr[i].x, kc[j].x, s[i][j]);
        s[i][j] = fmaf(qr[i].y, kc[j].y, s[i][j]);
        s[i][j] = fmaf(qr[i].z, kc[j].z, s[i][j]);
        s[i][j] = fmaf(qr[i].w, kc[j].w, s[i][j]);
        dp[i][j] = fmaf(dr[i].x, vc[j].x, dp[i][j]);
        dp[i][j] = fmaf(dr[i].y, vc[j].y, dp[i][j]);
        dp[i][j] = fmaf(dr[i].z, vc[j].z, dp[i][j]);
        dp[i][j] = fmaf(dr[i].w, vc[j].w, dp[i][j]);
      }
  }
}

// From the scores of a tile: P~ (when Pt is given) and dS * scale into
// shared memory, rows ty + 16 i and columns tx + 16 j; entries past Nq or
// Nk are 0.  lse_s and delta_s hold the tile's rows.
template <bool DROPOUT, int RQ, int CK, int PS>
__device__ __forceinline__ void tile_probs(
    const float (&s)[RQ][CK], const float (&dp)[RQ][CK], const float* lse_s,
    const float* delta_s, const unsigned long long* key, int q0, int k0,
    int Nq, int Nk, float scale, unsigned thresh, float inv, float* Pt,
    float* dS) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int ri = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int cj = tx + 16 * j;
      const bool in = q0 + ri < Nq && k0 + cj < Nk;
      const float p = in ? expf(s[i][j] * scale - lse_s[ri]) : 0.f;
      float pt = p, dpv = dp[i][j];
      if constexpr (DROPOUT) {
        const bool kept = keep(key[i], k0 + cj, thresh);
        pt = kept ? p * inv : 0.f;
        dpv = kept ? dpv * inv : 0.f;
      }
      if (Pt != nullptr) Pt[ri * PS + cj] = pt;
      dS[ri * PS + cj] = p * (dpv - delta_s[ri]) * scale;
    }
  }
}

// The rows [q0, q0 + BQ) of lse and Delta into shared memory (0 past Nq),
// and the dropout keys of the thread's score rows.
template <bool DROPOUT, int BQ, int RQ>
__device__ __forceinline__ void load_row_stats(
    const float* lse, const float* delta, long long base, int q0, int Nq,
    float* lse_s, float* delta_s, const long long* seed, int bz, int hh,
    unsigned long long* key) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < Nq;
    lse_s[r] = in ? lse[base + q0 + r] : 0.f;
    delta_s[r] = in ? delta[base + q0 + r] : 0.f;
  }
  if constexpr (DROPOUT) {
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      key[i] = row_key(*seed, bz, hh, q0 + ty + 16 * i);
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int Nq, int Nk, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk,
                Strides sdv, float scale, const long long* seed,
                unsigned thresh, float inv) {
  using T = BwdTile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RQ = T::RQ, CK = T::CK, RK = T::RK;
  constexpr int CG = T::CG, QS = T::QS, PS = T::PS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * QS;
  float* Qs = Vs + BK * QS;
  float* dOs = Qs + BQ * QS;
  float* Pt = dOs + BQ * QS;
  float* dS = Pt + BQ * PS;
  float* lse_s = dS + BQ * PS;
  float* delta_s = lse_s + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bz = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * BK;
  const long long rows = ((long long)bz * gridDim.y + hh) * Nq;
  const float* qb = q + bz * sq.b + hh * sq.h;
  const float* dob = dout + bz * sdo.b + hh * sdo.h;

  load_rows<D>(Ks, k + bz * sk.b + hh * sk.h, sk.n, k0, BK, Nk);
  load_rows<D>(Vs, v + bz * sv.b + hh * sv.h, sv.n, k0, BK, Nk);
  commit();

  // adk / adv [i][g]: key row ty + 16 i, columns 4 tx + 64 g .. + 3
  float4 adk[RK][CG], adv[RK][CG];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int g = 0; g < CG; ++g)
      adk[i][g] = adv[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned long long key[DROPOUT ? RQ : 1];

  for (int q0 = 0; q0 < Nq; q0 += BQ) {
    load_rows<D>(Qs, qb, sq.n, q0, BQ, Nq);
    load_rows<D>(dOs, dob, sdo.n, q0, BQ, Nq);
    commit();
    load_row_stats<DROPOUT, BQ, RQ>(lse, delta, rows, q0, Nq, lse_s, delta_s,
                                    seed, bz, hh, key);
    wait_groups<0>();
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
    tile_scores<D, RQ, CK>(Qs, dOs, Ks, Vs, s, dp);
    tile_probs<DROPOUT, RQ, CK, PS>(s, dp, lse_s, delta_s, key, q0, k0, Nq,
                                    Nk, scale, thresh, inv, Pt, dS);
    __syncthreads();
    // dv += P~^T dO and dk += dS^T Q over the tile's BQ query rows, in
    // ascending row order
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pr[RK], sr[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pr[i] = Pt[r * PS + ty + 16 * i];
        sr[i] = dS[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 dov = ld4(dOs + r * QS + 4 * tx + 64 * g);
        const float4 qv = ld4(Qs + r * QS + 4 * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          adv[i][g].x = fmaf(pr[i], dov.x, adv[i][g].x);
          adv[i][g].y = fmaf(pr[i], dov.y, adv[i][g].y);
          adv[i][g].z = fmaf(pr[i], dov.z, adv[i][g].z);
          adv[i][g].w = fmaf(pr[i], dov.w, adv[i][g].w);
          adk[i][g].x = fmaf(sr[i], qv.x, adk[i][g].x);
          adk[i][g].y = fmaf(sr[i], qv.y, adk[i][g].y);
          adk[i][g].z = fmaf(sr[i], qv.z, adk[i][g].z);
          adk[i][g].w = fmaf(sr[i], qv.w, adk[i][g].w);
        }
      }
    }
    __syncthreads();  // every thread is done with Qs, dOs, Pt and dS
  }

  float* dkb = dk + bz * sdk.b + hh * sdk.h;
  float* dvb = dv + bz * sdv.b + hh * sdv.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Nk) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float* a = dkb + r * sdk.n + 4 * tx + 64 * g;
      a[0] = adk[i][g].x;
      a[1] = adk[i][g].y;
      a[2] = adk[i][g].z;
      a[3] = adk[i][g].w;
      float* b = dvb + r * sdv.n + 4 * tx + 64 * g;
      b[0] = adv[i][g].x;
      b[1] = adv[i][g].y;
      b[2] = adv[i][g].z;
      b[3] = adv[i][g].w;
    }
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Nq, int Nk, Strides sq, Strides sk,
              Strides sv, Strides sdo, Strides sdq, float scale,
              const long long* seed, unsigned thresh, float inv) {
  using T = BwdTile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, RQ = T::RQ, CK = T::CK;
  constexpr int CG = T::CG, QS = T::QS, PS = T::PS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * QS;
  float* Qs = Vs + BK * QS;
  float* dOs = Qs + BQ * QS;
  float* dS = dOs + BQ * QS;
  float* lse_s = dS + BQ * PS;
  float* delta_s = lse_s + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* kb = k + bz * sk.b + hh * sk.h;
  const float* vb = v + bz * sv.b + hh * sv.h;

  load_rows<D>(Qs, q + bz * sq.b + hh * sq.h, sq.n, q0, BQ, Nq);
  load_rows<D>(dOs, dout + bz * sdo.b + hh * sdo.h, sdo.n, q0, BQ, Nq);
  commit();
  unsigned long long key[DROPOUT ? RQ : 1];
  load_row_stats<DROPOUT, BQ, RQ>(lse, delta,
                                  ((long long)bz * gridDim.y + hh) * Nq, q0,
                                  Nq, lse_s, delta_s, seed, bz, hh, key);

  // acc[i][g]: query row ty + 16 i, columns 4 tx + 64 g .. + 3
  float4 acc[RQ][CG];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    load_rows<D>(Ks, kb, sk.n, k0, BK, Nk);
    load_rows<D>(Vs, vb, sv.n, k0, BK, Nk);
    commit();
    wait_groups<0>();
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
    tile_scores<D, RQ, CK>(Qs, dOs, Ks, Vs, s, dp);
    tile_probs<DROPOUT, RQ, CK, PS>(s, dp, lse_s, delta_s, key, q0, k0, Nq,
                                    Nk, scale, thresh, inv, nullptr, dS);
    __syncthreads();
    // dq += dS K over the tile's BK keys, in ascending key order
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float4 sr[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sr[i] = ld4(dS + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 kv = ld4(Ks + (c + u) * QS + 4 * tx + 64 * g);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float w = u == 0 ? sr[i].x
                            : u == 1 ? sr[i].y
                            : u == 2 ? sr[i].z
                                     : sr[i].w;
            acc[i][g].x = fmaf(w, kv.x, acc[i][g].x);
            acc[i][g].y = fmaf(w, kv.y, acc[i][g].y);
            acc[i][g].z = fmaf(w, kv.z, acc[i][g].z);
            acc[i][g].w = fmaf(w, kv.w, acc[i][g].w);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with Ks, Vs and dS
  }

  float* dqb = dq + bz * sdq.b + hh * sdq.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Nq) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float* a = dqb + r * sdq.n + 4 * tx + 64 * g;
      a[0] = acc[i][g].x;
      a[1] = acc[i][g].y;
      a[2] = acc[i][g].z;
      a[3] = acc[i][g].w;
    }
  }
}

template <int D, bool DROPOUT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* delta, float* dq, float* dk, float* dv, int B,
                   int H, int Nq, int Nk, const long long* st, float scale,
                   const long long* seed, unsigned thresh, float inv,
                   cudaStream_t stream) {
  using T = BwdTile<D>;
  auto S = [st](int t) { return Strides{st[3 * t], st[3 * t + 1],
                                        st[3 * t + 2]}; };
  // strides: q 0, k 1, v 2, o 3, dO 4, dq 5, dk 6, dv 7
  delta_kernel<<<dim3((Nq + THREADS / 32 - 1) / (THREADS / 32), H, B),
                 THREADS, 0, stream>>>(o, dout, delta, Nq, D, S(3), S(4));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkdv_kernel<D, DROPOUT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)T::SMEM);
  if (e != cudaSuccess) return e;
  dkdv_kernel<D, DROPOUT>
      <<<dim3((Nk + T::BK - 1) / T::BK, H, B), THREADS, T::SMEM, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, Nq, Nk, S(0), S(1), S(2), S(4),
          S(6), S(7), scale, seed, thresh, inv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dq_kernel<D, DROPOUT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)T::SMEM);
  if (e != cudaSuccess) return e;
  dq_kernel<D, DROPOUT>
      <<<dim3((Nq + T::BQ - 1) / T::BQ, H, B), THREADS, T::SMEM, stream>>>(
          q, k, v, dout, lse, delta, dq, Nq, Nk, S(0), S(1), S(2), S(4),
          S(5), scale, seed, thresh, inv);
  return cudaGetLastError();
}

template <bool DROPOUT>
int launch_d(const float* q, const float* k, const float* v, const float* o,
             const float* dout, const float* lse, float* delta, float* dq,
             float* dk, float* dv, int B, int H, int Nq, int Nk, int D,
             const long long* st, float scale, const long long* seed,
             unsigned thresh, float inv, cudaStream_t stream) {
  switch (D) {
    case 128:
      return (int)launch<128, DROPOUT>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, Nq, Nk, st, scale, seed,
                                       thresh, inv, stream);
    case 256:
      return (int)launch<256, DROPOUT>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, Nq, Nk, st, scale, seed,
                                       thresh, inv, stream);
    case 512:
      return (int)launch<512, DROPOUT>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, H, Nq, Nk, st, scale, seed,
                                       thresh, inv, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D), o and dO (B, H, Nq, D), dq (B, H,
// Nq, D), dk and dv (B, H, Nk, D): f32 on the device with unit stride
// along D; strides (host, 24 values) are the (b, h, row) strides in
// elements of q, k, v, o, dO, dq, dk and dv.  q, k, v and dO start 16-byte
// aligned with strides that are multiples of 4.  lse (the forward's) and
// delta (scratch) are (B, H, Nq) f32 contiguous.  With `seed` (one int64
// on the device) the mask of the stream of attention.cuh at threshold
// `thresh` applies, kept entries scaled by `inv`; a null seed is rate 0.
// D is 128, 256 or 512.  Three launches on `stream`; returns the first
// CUDA error.
extern "C" int dg_attention_bwd(const float* q, const float* k,
                                const float* v, const float* o,
                                const float* dout, const float* lse,
                                float* delta, float* dq, float* dk,
                                float* dv, int B, int H, int Nq, int Nk,
                                int D, const long long* strides, float scale,
                                const long long* seed, unsigned thresh,
                                float inv, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (const float* p : {q, k, v, dout})
    if ((size_t)p % 16) return (int)cudaErrorMisalignedAddress;
  for (int t : {0, 1, 2, 4})
    for (int i = 0; i < 3; ++i)
      if (strides[3 * t + i] % 4) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (seed != nullptr)
    return launch_d<true>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Nq,
                          Nk, D, strides, scale, seed, thresh, inv, st);
  return launch_d<false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Nq,
                         Nk, D, strides, scale, nullptr, 0u, 1.f, st);
}
