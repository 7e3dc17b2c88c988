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
// Bound on an H100 SXM, at the fusion Net's training call (B, h, N, d) =
// (64, 2, 2048, 256): operations.  The five products the TPU kernel counts
// (s, dO v^T, dv, dq, dk: 5 * 2 * B*h*Nq*Nk*d = 1.37e12 flops) take 20.5
// ms at the f32 CUDA-core peak (67 TFLOP/s); in three TF32 terms each
// (4.12e12 tensor flops) 8.3 ms at the dense TF32 peak (495 TFLOP/s), plus
// ~0.05 ms of per-score arithmetic on the CUDA cores.  q, k, v, o, dO, dq,
// dk and dv are 8 * 268 MB, 0.64 ms at 3.35 TB/s.
//
// Design: three launches, and no atomics, so that every sum runs in an
// order fixed from run to run:
//   1. delta_kernel: a warp a row, Delta = rowsum(dO * o).
//   2. dkdv_kernel: a block per (b, h, tile of BK keys) holds its K and V
//      tiles in shared memory and loops over the query tiles of BQ rows:
//      it recomputes s and dO v^T for the tile, forms P~ and dS * scale in
//      shared memory, and adds P~^T dO and dS^T q into dv and dk, held in
//      registers (2 * BK * D / 256 = 64 floats a thread).  The key tiles
//      are independent: no cross-block sum, unlike the TPU kernel's
//      accumulation over its sequential grid.
//   3. dq_kernel: a block per (b, h, tile of BQ queries) holds its Q and dO
//      tiles and loops over the key tiles: the same scores, then dS k into
//      dq in registers.
// So the kernel runs 7 products where the bound counts 5: the dq pass
// recomputes s and dO v^T rather than sum dq across blocks.
//
// Every product is mma.sync m16n8k8 on the tensor cores in three TF32
// terms (mma_tf32.cuh: lo*hi, hi*lo, then hi*hi into one f32
// accumulator), near f32 roundoff; the operands are split as each
// fragment is read from shared memory.  The tensor core's sum cuts toward
// zero, so every chain of MMAs starts from a fresh accumulator (32 columns
// of d in a score, a query tile in dk and dv, a key tile in dq), added to
// the running sum in f32: one chain over all 2048 queries drifted to 4e-5
// of a row's norm, the short chains hold 5e-6.  The per-score work (the
// exponential, the mask, dS) runs on the CUDA cores on the accumulator
// fragments, and P~ and dS pass through shared memory to become the next
// product's A operand.  Shared tiles are swizzled (mma_tf32.cuh), since
// Q, dO and K are read both along and across their rows.  Tiles: BK = 8192
// / D keys, BQ = 64 queries (32 at d = 512), under 227 KB of shared memory
// at one block an SM.  In the score phase a warp owns one 16-row m-tile
// and SN 8-column n-tiles of both s and dO v^T (at d = 512 the tile holds
// four warps' worth, and four warps wait); in dkdv's accumulation warps
// 0-3 own dv and 4-7 dk, each all BK rows and a quarter of the columns;
// in dq's, a warp owns BQ / 2 rows and a quarter of the columns.  The
// copies are not overlapped with the products (one block an SM holds no
// second buffer).  Times against the bound are in PERF.md (chip_smoke.py,
// phase 31).
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace dg_attn;
using dg_mma::at;
using dg_mma::FragA;
using dg_mma::FragB;

template <int D>
struct BwdTile {
  static constexpr int BK = 8192 / D;            // keys a tile
  static constexpr int BQ = D >= 512 ? 32 : 64;  // queries a tile
  static constexpr int PS = BK < 32 ? 32 : BK;   // P~ / dS row (swizzled)
  // the score phase: MQ x NK m16n8 tiles of s and of dO v^T; a warp owns
  // one m-tile and SN n-tiles of both, SWARPS warps in all
  static constexpr int MQ = BQ / 16, NK = BK / 8;
  static constexpr int SWN = 8 / MQ < NK ? 8 / MQ : NK;
  static constexpr int SN = NK / SWN, SWARPS = MQ * SWN;
  // dkdv's accumulation: a warp owns KM x KN tiles of dv or dk
  static constexpr int KM = BK / 16, KN = D / 32;
  // dq's: a warp owns QM x KN tiles of dq
  static constexpr int QM = BQ / 32;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * D + 2 * (size_t)BQ * PS +
                       2 * BQ);
  static_assert(SWARPS <= THREADS / 32 && SWN * SN == NK, "score warps");
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

// The scores of the warp's part of one (query tile, key tile) pair: s = Qs
// Ks^T and dp = dOs Vs^T for tile rows m0 .. m0 + 15 and columns n0 .. n0
// + 8 SN - 1, as m16n8 accumulator fragments.  Both products in one pass
// over d keep 2 SN chains of MMAs in flight; each 32 columns of d sum into
// a fresh accumulator, added to s and dp in f32.
template <int D, int SN>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int m0, int n0,
                                            float (&s)[1][SN][4],
                                            float (&dp)[1][SN][4]) {
  using namespace dg_mma;
  const int g = lane_g();
  float ps[1][SN][4], pd[1][SN][4];
  zero_tiles(s);
  zero_tiles(dp);
  zero_tiles(ps);
  zero_tiles(pd);
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 32) {
#pragma unroll
    for (int h = 0; h < 32; h += 16) {
      FragA qa[2], da[2];
      split_a_quads(load_quad<D>(Qs, m0 + g, c0, h),
                    load_quad<D>(Qs, m0 + g + 8, c0, h), qa[0], qa[1]);
      split_a_quads(load_quad<D>(dOs, m0 + g, c0, h),
                    load_quad<D>(dOs, m0 + g + 8, c0, h), da[0], da[1]);
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        FragB kb[2], vb[2];
        split_b_quad(load_quad<D>(Ks, n0 + 8 * j + g, c0, h), kb[0], kb[1]);
        split_b_quad(load_quad<D>(Vs, n0 + 8 * j + g, c0, h), vb[0], vb[1]);
        mma3(ps[0][j], qa[0], kb[0]);
        mma3(ps[0][j], qa[1], kb[1]);
        mma3(pd[0][j], da[0], vb[0]);
        mma3(pd[0][j], da[1], vb[1]);
      }
    }
    add_tiles(s, ps);
    add_tiles(dp, pd);
  }
}

// From the warp's scores: P~ (when Pt is given) and dS * scale into the
// swizzled shared tiles, entries past Nq or Nk 0.  lse_s and delta_s hold
// the tile's rows, key the dropout keys of rows m0 + g and m0 + g + 8.
template <bool DROPOUT, int SN, int PS>
__device__ __forceinline__ void tile_probs(
    const float (&s)[1][SN][4], const float (&dp)[1][SN][4],
    const float* lse_s,
    const float* delta_s, const unsigned long long (&key)[2], int m0, int n0,
    int q0, int k0, int Nq, int Nk, float scale, unsigned thresh, float inv,
    float* Pt, float* dS) {
  const int g = dg_mma::lane_g(), t = dg_mma::lane_t();
#pragma unroll
  for (int j = 0; j < SN; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half, c = n0 + 8 * j + 2 * t;
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = q0 + r < Nq && k0 + c + e < Nk;
        const float p =
            in ? expf(s[0][j][2 * half + e] * scale - lse_s[r]) : 0.f;
        float pt = p, dpv = dp[0][j][2 * half + e];
        if constexpr (DROPOUT) {
          const bool kept = keep(key[half], k0 + c + e, thresh);
          pt = kept ? p * inv : 0.f;
          dpv = kept ? dpv * inv : 0.f;
        }
        pv[e] = pt;
        dsv[e] = p * (dpv - delta_s[r]) * scale;
      }
      if (Pt != nullptr)
        *reinterpret_cast<float2*>(Pt + at<PS>(r, c)) =
            make_float2(pv[0], pv[1]);
      *reinterpret_cast<float2*>(dS + at<PS>(r, c)) =
          make_float2(dsv[0], dsv[1]);
    }
}

// The rows [q0, q0 + BQ) of lse and Delta into shared memory (0 past Nq),
// and the dropout keys of the warp's score rows q0 + m0 + g (+ 8).
template <bool DROPOUT, int BQ>
__device__ __forceinline__ void load_row_stats(
    const float* lse, const float* delta, long long base, int q0, int Nq,
    int m0, float* lse_s, float* delta_s, const long long* seed, int bz,
    int hh, unsigned long long (&key)[2]) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < Nq;
    lse_s[r] = in ? lse[base + q0 + r] : 0.f;
    delta_s[r] = in ? delta[base + q0 + r] : 0.f;
  }
  if constexpr (DROPOUT) {
    const int g = dg_mma::lane_g();
    key[0] = row_key(*seed, bz, hh, q0 + m0 + g);
    key[1] = row_key(*seed, bz, hh, q0 + m0 + g + 8);
  }
}

// Writes a warp's MI x NI accumulator tiles to rows r0 + 16 mi + g (+ 8)
// and columns c0 + 8 ni + 2t (+ 1) of out (rows past nrows skipped).
template <int MI, int NI>
__device__ __forceinline__ void store_tiles(const float (&acc)[MI][NI][4],
                                            float* out, long long stride,
                                            int r0, int c0, int nrows) {
  const int g = dg_mma::lane_g(), t = dg_mma::lane_t();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * mi + g + 8 * half;
      if (r >= nrows) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float* a = out + r * stride + c0 + 8 * ni + 2 * t;
        a[0] = acc[mi][ni][2 * half];
        a[1] = acc[mi][ni][2 * half + 1];
      }
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
  constexpr int BQ = T::BQ, BK = T::BK, PS = T::PS, SN = T::SN;
  constexpr int KM = T::KM, KN = T::KN;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * D;
  float* Qs = Vs + BK * D;
  float* dOs = Qs + BQ * D;
  float* Pt = dOs + BQ * D;
  float* dS = Pt + BQ * PS;
  float* lse_s = dS + BQ * PS;
  float* delta_s = lse_s + BQ;
  const int warp = threadIdx.x >> 5;
  const int bz = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * BK;
  const long long rows = ((long long)bz * gridDim.y + hh) * Nq;
  const float* qb = q + bz * sq.b + hh * sq.h;
  const float* dob = dout + bz * sdo.b + hh * sdo.h;
  // the warp's score tile, and its part of the accumulation: warps 0-3 dv
  // += P~^T dO, warps 4-7 dk += dS^T Q, columns nb .. nb + D / 4 - 1
  const bool scores = warp < T::SWARPS;
  const int m0 = 16 * (warp % T::MQ), n0 = 8 * SN * (warp / T::MQ);
  const float* As = warp < 4 ? Pt : dS;
  const float* Bs = warp < 4 ? dOs : Qs;
  const int nb = (warp & 3) * (D / 4);

  dg_mma::load_rows<D>(Ks, k + bz * sk.b + hh * sk.h, sk.n, k0, BK, Nk);
  dg_mma::load_rows<D>(Vs, v + bz * sv.b + hh * sv.h, sv.n, k0, BK, Nk);
  commit();

  // acc: the sum over the query tiles so far; part: this tile's
  float acc[KM][KN][4], part[KM][KN][4];
  dg_mma::zero_tiles(acc);
  dg_mma::zero_tiles(part);
  unsigned long long key[2];

  for (int q0 = 0; q0 < Nq; q0 += BQ) {
    dg_mma::load_rows<D>(Qs, qb, sq.n, q0, BQ, Nq);
    dg_mma::load_rows<D>(dOs, dob, sdo.n, q0, BQ, Nq);
    commit();
    load_row_stats<DROPOUT, BQ>(lse, delta, rows, q0, Nq, m0, lse_s,
                                delta_s, seed, bz, hh, key);
    wait_groups<0>();
    __syncthreads();
    if (scores) {
      float s[1][SN][4], dp[1][SN][4];
      tile_scores<D, SN>(Qs, dOs, Ks, Vs, m0, n0, s, dp);
      tile_probs<DROPOUT, SN, PS>(s, dp, lse_s, delta_s, key, m0, n0, q0,
                                  k0, Nq, Nk, scale, thresh, inv, Pt, dS);
    }
    __syncthreads();
    // over the tile's BQ query rows, 8 at a time in ascending order
#pragma unroll 2
    for (int kk = 0; kk < BQ; kk += 8) {
      FragA a[KM];
#pragma unroll
      for (int mi = 0; mi < KM; ++mi)
        a[mi] = dg_mma::load_a_cols<PS>(As, 16 * mi, kk);
#pragma unroll
      for (int ni = 0; ni < KN; ++ni) {
        const FragB b = dg_mma::load_b_cols<D>(Bs, nb + 8 * ni, kk);
#pragma unroll
        for (int mi = 0; mi < KM; ++mi) dg_mma::mma3(part[mi][ni], a[mi], b);
      }
    }
    dg_mma::add_tiles(acc, part);
    __syncthreads();  // every warp is done with Qs, dOs, Pt and dS
  }

  if (warp < 4)
    store_tiles<KM, KN>(acc, dv + bz * sdv.b + hh * sdv.h, sdv.n, k0, nb, Nk);
  else
    store_tiles<KM, KN>(acc, dk + bz * sdk.b + hh * sdk.h, sdk.n, k0, nb, Nk);
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
  constexpr int BQ = T::BQ, BK = T::BK, PS = T::PS, SN = T::SN;
  constexpr int QM = T::QM, KN = T::KN;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * D;
  float* Qs = Vs + BK * D;
  float* dOs = Qs + BQ * D;
  float* dS = dOs + BQ * D;
  float* lse_s = dS + BQ * PS;
  float* delta_s = lse_s + BQ;
  const int warp = threadIdx.x >> 5;
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* kb = k + bz * sk.b + hh * sk.h;
  const float* vb = v + bz * sv.b + hh * sv.h;
  // the warp's score tile, and its part of dq += dS K: rows mb .. mb + BQ
  // / 2 - 1, columns nb .. nb + D / 4 - 1
  const bool scores = warp < T::SWARPS;
  const int m0 = 16 * (warp % T::MQ), n0 = 8 * SN * (warp / T::MQ);
  const int mb = 16 * QM * (warp & 1), nb = (warp >> 1) * (D / 4);

  dg_mma::load_rows<D>(Qs, q + bz * sq.b + hh * sq.h, sq.n, q0, BQ, Nq);
  dg_mma::load_rows<D>(dOs, dout + bz * sdo.b + hh * sdo.h, sdo.n, q0, BQ,
                       Nq);
  commit();
  unsigned long long key[2];
  load_row_stats<DROPOUT, BQ>(lse, delta,
                              ((long long)bz * gridDim.y + hh) * Nq, q0, Nq,
                              m0, lse_s, delta_s, seed, bz, hh, key);

  // acc: the sum over the key tiles so far; part: this tile's
  float acc[QM][KN][4], part[QM][KN][4];
  dg_mma::zero_tiles(acc);
  dg_mma::zero_tiles(part);

  for (int k0 = 0; k0 < Nk; k0 += BK) {
    dg_mma::load_rows<D>(Ks, kb, sk.n, k0, BK, Nk);
    dg_mma::load_rows<D>(Vs, vb, sv.n, k0, BK, Nk);
    commit();
    wait_groups<0>();
    __syncthreads();
    if (scores) {
      float s[1][SN][4], dp[1][SN][4];
      tile_scores<D, SN>(Qs, dOs, Ks, Vs, m0, n0, s, dp);
      tile_probs<DROPOUT, SN, PS>(s, dp, lse_s, delta_s, key, m0, n0, q0,
                                  k0, Nq, Nk, scale, thresh, inv, nullptr,
                                  dS);
    }
    __syncthreads();
    // over the tile's BK keys, 8 at a time in ascending order
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragA a[QM];
#pragma unroll
      for (int mi = 0; mi < QM; ++mi)
        a[mi] = dg_mma::load_a_rows<PS>(dS, mb + 16 * mi, kk);
#pragma unroll
      for (int ni = 0; ni < KN; ++ni) {
        const FragB b = dg_mma::load_b_cols<D>(Ks, nb + 8 * ni, kk);
#pragma unroll
        for (int mi = 0; mi < QM; ++mi) dg_mma::mma3(part[mi][ni], a[mi], b);
      }
    }
    dg_mma::add_tiles(acc, part);
    __syncthreads();  // every warp is done with Ks, Vs and dS
  }

  store_tiles<QM, KN>(acc, dq + bz * sdq.b + hh * sdq.h, sdq.n, q0 + mb, nb,
                      Nq);
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
