// attention_bwd_bf16: kernel 15's bf16 form, the backward of multi-head
// softmax attention with dropout on the probabilities, on bf16 q, k, v and
// dO, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::_attn_bwd_impl
// (body _attn_bwd_kernel, :131-180) on the bf16 inputs of the AMP fusion
// Net's training.  From q, k, v, the forward's row max m and sum l
// (attention_fwd_bf16.cu, training form), the dropout seed and the output's
// cotangent dO, with s = q k^T (bf16 products, f32 sums):
//
//   p    = exp(s * scale - m) / l   the forward's instructions and bits
//   p~   = keep ? p * inv : 0       the mask regenerated, inv = 1/(1-rate)
//   dv   = bf16(p~)^T dO            f32 sums, rounded to bf16 once
//   dp~  = dO v^T,  dp = keep ? dp~ * inv : 0
//   Delta_i = sum_j dp_ij p_ij      in f32, as the TPU kernel takes it
//   dS   = p (dp - Delta),  dSb = bf16(dS * scale)
//   dq   = dSb k,  dk = dSb^T q     f32 sums, rounded to bf16 once
//
// Delta is the TPU kernel's sum over the rebuilt f32 p, not rowsum(dO * o):
// the bf16 o, bf16(bf16(p~) v), would move it by up to ~2^-9 of |dO||o|.
// The TPU adds dk and dv into bf16 outputs query tile by query tile (two
// tiles at N = 2048, d = 256); here every query row sums in f32 and the
// result rounds once, the tile-free function (ROADMAP C: at most one bf16
// rounding a tile apart).  Nothing of size (Nq, Nk) reaches device memory.
//
// Bound on an H100 SXM, at the fusion Net's training call (B, h, N, d) =
// (64, 2, 2048, 256): operations.  The five products the TPU kernel counts
// (s, dO v^T, dv, dq, dk: 5 * 2 * B*h*Nq*Nk*d = 1.37e12 flops) take 1.39
// ms at the dense bf16 tensor-core rate (989 TFLOP/s); q, k, v, dO, dq, dk
// and dv are 7 * 134 MB, 0.28 ms at 3.35 TB/s.
//
// Design: two launches, no atomics, every sum in an order fixed from run
// to run (two calls give the same bits):
//   1. dq_bf16_kernel: a block per (b, h, BQ query rows) holds its Q and dO
//      tiles and passes over the key tiles twice.  Pass A: s and dO v^T,
//      p and dp, each lane's partial Delta of its two rows in f32, then the
//      quad's lanes and the row's warps added in a fixed order; Delta is
//      written for launch 2.  Pass B: s and dO v^T again, dSb into shared
//      memory, dq += dSb K in registers.
//   2. dkdv_bf16_kernel: a block per (b, h, BK keys) holds its K and V
//      tiles and loops over the query tiles of 64 rows in ascending order:
//      s and dO v^T, P~ and dSb (bf16) into shared memory, then warps 0-3
//      add P~^T dO into dv and warps 4-7 dSb^T Q into dk, each all BK rows
//      and a quarter of the columns (64 f32 accumulators a lane).
// So the kernel runs 9 products where the bound counts 5.  Every product
// is mma.sync m16n8k16 on bf16 fragments read by ldmatrix (P~^T, dSb^T, K,
// Q and dO by ldmatrix.trans), and every chain of MMAs into one
// accumulator is at most four long (32 columns of d in a score, 64 keys in
// dq, 64 queries in dk and dv), added to the running sum in f32: the
// tensor core's sum truncates (mma_bf16.cuh).  The scores are
// attention_bf16.cuh's, the forward's own sequence, so p is the forward's
// p bit for bit.  Tiles: BQ = 64 queries (32 at d = 512) and 64 keys in
// launch 1; BK = 8192 / d keys and 64 queries in launch 2; one block an SM
// (up to ~205 KB of shared memory at d = 512: a 64 x 512 bf16 key tile
// alone is 64 KB), copies not overlapped with the products.  A simple form:
// wgmma and TMA are later work.  Times against the bound are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "attention_bf16.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dg_attn::Strides;
using dg_attn::THREADS;
using dg_attn_bf16::load_rows;
using dg_attn_bf16::prob;
using dg_attn_bf16::tile_scores;

constexpr int WARPS = THREADS / 32;

// The score phase of an (R query rows x C keys) tile: MQ m-tiles of 16
// rows, SWN warps across the keys of each, KW keys a warp (NT n-tiles of
// 8); warps from SWARPS on wait.
template <int R, int C>
struct Scores {
  static constexpr int MQ = R / 16;
  static constexpr int SWN = WARPS / MQ < C / 16 ? WARPS / MQ : C / 16;
  static constexpr int SWARPS = MQ * SWN;
  static constexpr int KW = C / SWN;
  static constexpr int NT = KW / 8;
  static_assert(SWARPS <= WARPS && SWN * KW == C && NT % 2 == 0,
                "score tiles");
};

template <int D>
struct DqTile {
  static constexpr int BQ = D >= 512 ? 32 : 64;  // query rows a block
  static constexpr int BK = 64;                  // keys a tile
  static constexpr int RS = D + 8, PS = BK + 8;  // row strides (bf16)
  using S = Scores<BQ, BK>;
  // dq += dSb K: a warp owns 16 rows and D / WN columns (ON n-tiles)
  static constexpr int MQ = BQ / 16, WN = WARPS / MQ, ON = D / WN / 8;
  static constexpr size_t SMEM =
      sizeof(bf16) * (2 * (size_t)BQ * RS + 2 * (size_t)BK * RS +
                      (size_t)BQ * PS) +
      sizeof(float) * (3 * BQ + BQ * S::SWN);
  static_assert(ON % 2 == 0 && MQ * WN == WARPS, "dq tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int D>
struct DkdvTile {
  static constexpr int BK = 8192 / D;            // keys a block
  static constexpr int BQ = 64;                  // query rows a tile
  static constexpr int RS = D + 8, PS = BK + 8;  // row strides (bf16)
  using S = Scores<BQ, BK>;
  // dv (warps 0-3) and dk (4-7): all BK rows (KM m-tiles), D / 4 columns
  static constexpr int KM = BK / 16, ON = D / 4 / 8;
  static constexpr size_t SMEM =
      sizeof(bf16) * (2 * (size_t)BK * RS + 2 * (size_t)BQ * RS +
                      2 * (size_t)BQ * PS) +
      sizeof(float) * 3 * BQ;
  static_assert(ON % 2 == 0 && KM >= 1, "dkdv tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The rows [q0, q0 + BQ) of m, l (and Delta) into shared memory: past Nq
// 0, 1 and 0.
template <int BQ>
__device__ __forceinline__ void load_row_stats(
    const float* ms, const float* ls, const float* delta, long long base,
    int q0, int Nq, float* m_s, float* l_s, float* d_s) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < Nq;
    m_s[r] = in ? ms[base + q0 + r] : 0.f;
    l_s[r] = in ? ls[base + q0 + r] : 1.f;
    if (delta != nullptr) d_s[r] = in ? delta[base + q0 + r] : 0.f;
  }
}

// For each score of the warp's tile (rows m0 + g, m0 + g + 8 and columns
// kofs + 8 j + 2t (+ 1) of the tile at query q0, key k0): f(j, e, p, pt,
// dp) with the probability p, its dropped and scaled pt and dp; all three
// 0 past Nq or Nk.
template <bool DROPOUT, int NT, class F>
__device__ __forceinline__ void each_score(
    const float (&s)[NT][4], const float (&dpt)[NT][4], const float* m_s,
    const float* l_s, const unsigned long long (&key)[2], int m0, int kofs,
    int q0, int k0, int Nq, int Nk, float scale, unsigned thresh, float inv,
    F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1);
      const int col = k0 + kofs + 8 * j + 2 * t + (e & 1);
      float p = 0.f, pt = 0.f, dp = 0.f;
      if (q0 + r < Nq && col < Nk) {
        p = prob(s[j][e], scale, m_s[r], l_s[r]);
        pt = p;
        dp = dpt[j][e];
        if constexpr (DROPOUT) {
          const bool kept = dg_attn::keep(key[e >> 1], col, thresh);
          pt = kept ? __fmul_rn(p, inv) : 0.f;
          dp = kept ? __fmul_rn(dp, inv) : 0.f;
        }
      }
      f(j, e, p, pt, dp);
    }
}

// dS * scale of one score, rounded to bf16 by the caller's pack.
__device__ __forceinline__ float dsb(float p, float dp, float delta,
                                     float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 1)
    dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ ms,
                   const float* __restrict__ ls, float* __restrict__ delta,
                   bf16* __restrict__ dq, int Nq, int Nk, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   float scale, const long long* seed, unsigned thresh,
                   float inv) {
  using T = DqTile<D>;
  using S = typename T::S;
  constexpr int BQ = T::BQ, BK = T::BK, RS = T::RS, PS = T::PS, NT = S::NT;
  constexpr int ON = T::ON;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * RS;
  bf16* Ks = dOs + BQ * RS;
  bf16* Vs = Ks + BK * RS;
  bf16* dS = Vs + BK * RS;
  float* m_s = reinterpret_cast<float*>(dS + BQ * PS);
  float* l_s = m_s + BQ;
  float* d_s = l_s + BQ;
  float* dpart = d_s + BQ;  // (BQ, SWN): each score warp's Delta
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long base = ((long long)bz * gridDim.y + hh) * Nq;
  const bool scoring = warp < S::SWARPS;
  const int m0 = 16 * (warp % S::MQ), wn = warp / S::MQ, kofs = S::KW * wn;
  const bf16* kb = k + bz * sk.b + hh * sk.h;
  const bf16* vb = v + bz * sv.b + hh * sv.h;

  load_rows<D, RS>(Qs, q + bz * sq.b + hh * sq.h, sq.n, q0, BQ, Nq,
                   threadIdx.x);
  load_rows<D, RS>(dOs, dout + bz * sdo.b + hh * sdo.h, sdo.n, q0, BQ, Nq,
                   threadIdx.x);
  dg_attn::commit();
  load_row_stats<BQ>(ms, ls, nullptr, base, q0, Nq, m_s, l_s, d_s);
  unsigned long long key[2] = {0ull, 0ull};
  if constexpr (DROPOUT) {
    key[0] = dg_attn::row_key(*seed, bz, hh, q0 + m0 + g);
    key[1] = dg_attn::row_key(*seed, bz, hh, q0 + m0 + g + 8);
  }

  // pass A: each lane's part of Delta of rows m0 + g (+ 8)
  float dsum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    load_rows<D, RS>(Ks, kb, sk.n, k0, BK, Nk, dg_attn::tid_now());
    load_rows<D, RS>(Vs, vb, sv.n, k0, BK, Nk, dg_attn::tid_now());
    dg_attn::commit();
    dg_attn::wait_groups<0>();
    __syncthreads();
    if (scoring) {
      float s[NT][4], dpt[NT][4];
      tile_scores<D, RS, NT>(Qs, Ks, m0, kofs, s);
      tile_scores<D, RS, NT>(dOs, Vs, m0, kofs, dpt);
      each_score<DROPOUT, NT>(
          s, dpt, m_s, l_s, key, m0, kofs, q0, k0, Nq, Nk, scale, thresh,
          inv, [&](int, int e, float p, float, float dp) {
            dsum[e >> 1] = __fadd_rn(dsum[e >> 1], __fmul_rn(dp, p));
          });
    }
    __syncthreads();  // every warp is done with Ks and Vs
  }
  // the quad's lanes, then the row's score warps in order
  if (scoring) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      dsum[half] += __shfl_xor_sync(0xffffffffu, dsum[half], 1);
      dsum[half] += __shfl_xor_sync(0xffffffffu, dsum[half], 2);
      if (t == 0) dpart[(m0 + g + 8 * half) * S::SWN + wn] = dsum[half];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    float d = dpart[r * S::SWN];
#pragma unroll
    for (int w = 1; w < S::SWN; ++w) d += dpart[r * S::SWN + w];
    d_s[r] = d;
    if (q0 + r < Nq) delta[base + q0 + r] = d;
  }

  // pass B: dq += dSb K; the warp owns rows am0 .. am0 + 15 and columns
  // cn .. cn + D / WN - 1
  const int am0 = 16 * (warp % T::MQ), cn = (warp / T::MQ) * (D / T::WN);
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    // every warp is done with the last tile's Ks, Vs and dS (and, the
    // first time, every thread has written d_s)
    __syncthreads();
    load_rows<D, RS>(Ks, kb, sk.n, k0, BK, Nk, dg_attn::tid_now());
    load_rows<D, RS>(Vs, vb, sv.n, k0, BK, Nk, dg_attn::tid_now());
    dg_attn::commit();
    dg_attn::wait_groups<0>();
    __syncthreads();
    if (scoring) {
      float s[NT][4], dpt[NT][4], ds[NT][4];
      tile_scores<D, RS, NT>(Qs, Ks, m0, kofs, s);
      tile_scores<D, RS, NT>(dOs, Vs, m0, kofs, dpt);
      each_score<DROPOUT, NT>(
          s, dpt, m_s, l_s, key, m0, kofs, q0, k0, Nq, Nk, scale, thresh,
          inv, [&](int j, int e, float p, float, float dp) {
            ds[j][e] = dsb(p, dp, d_s[m0 + g + 8 * (e >> 1)], scale);
          });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bf16* pr = dS + (m0 + g) * PS + kofs + 8 * j + 2 * t;
        *reinterpret_cast<unsigned*>(pr) = dg_bf16::pack(ds[j][0], ds[j][1]);
        *reinterpret_cast<unsigned*>(pr + 8 * PS) =
            dg_bf16::pack(ds[j][2], ds[j][3]);
      }
    }
    __syncthreads();
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      dg_bf16::ldsm_x4(pa[kk], dS + (am0 + rr + 8 * (mi & 1)) * PS +
                                   16 * kk + 8 * (mi >> 1));
    // K as B: matrix mi is keys + 8 (mi & 1), columns + 8 (mi >> 1)
    const bf16* ka = Ks + (rr + 8 * (mi & 1)) * RS + cn + 8 * (mi >> 1);
#pragma unroll
    for (int n = 0; n < ON; n += 2) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned b[4];
        dg_bf16::ldsm_x4_trans(b, ka + 16 * kk * RS + 8 * n);
        dg_bf16::mma(part[0], pa[kk], b[0], b[1]);
        dg_bf16::mma(part[1], pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] += part[0][e];
        acc[n + 1][e] += part[1][e];
      }
    }
  }

  bf16* dqb = dq + bz * sdq.b + hh * sdq.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + am0 + g + 8 * half;
    if (r >= Nq) continue;
    bf16* row = dqb + r * sdq.n + cn + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<unsigned*>(row + 8 * n) =
          dg_bf16::pack(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ ms,
                     const float* __restrict__ ls,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Nq, int Nk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, float scale, const long long* seed,
                     unsigned thresh, float inv) {
  using T = DkdvTile<D>;
  using S = typename T::S;
  constexpr int BQ = T::BQ, BK = T::BK, RS = T::RS, PS = T::PS, NT = S::NT;
  constexpr int KM = T::KM, ON = T::ON;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * RS;
  bf16* Qs = Vs + BK * RS;
  bf16* dOs = Qs + BQ * RS;
  bf16* Pt = dOs + BQ * RS;  // P~ (BQ queries x BK keys), bf16
  bf16* dS = Pt + BQ * PS;   // dSb, likewise
  float* m_s = reinterpret_cast<float*>(dS + BQ * PS);
  float* l_s = m_s + BQ;
  float* d_s = l_s + BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int bz = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * BK;
  const long long base = ((long long)bz * gridDim.y + hh) * Nq;
  const bool scoring = warp < S::SWARPS;
  const int m0 = 16 * (warp % S::MQ), kofs = S::KW * (warp / S::MQ);
  const bf16* qb = q + bz * sq.b + hh * sq.h;
  const bf16* dob = dout + bz * sdo.b + hh * sdo.h;
  // the warp's part of the accumulation: warps 0-3 dv += P~^T dO, warps
  // 4-7 dk += dSb^T Q, columns cn .. cn + D / 4 - 1
  const bf16* As = warp < 4 ? Pt : dS;
  const bf16* Bs = warp < 4 ? dOs : Qs;
  const int cn = (warp & 3) * (D / 4);

  load_rows<D, RS>(Ks, k + bz * sk.b + hh * sk.h, sk.n, k0, BK, Nk,
                   threadIdx.x);
  load_rows<D, RS>(Vs, v + bz * sv.b + hh * sv.h, sv.n, k0, BK, Nk,
                   threadIdx.x);
  dg_attn::commit();

  float acc[KM][ON][4];
#pragma unroll
  for (int a = 0; a < KM; ++a)
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  for (int q0 = 0; q0 < Nq; q0 += BQ) {
    load_rows<D, RS>(Qs, qb, sq.n, q0, BQ, Nq, dg_attn::tid_now());
    load_rows<D, RS>(dOs, dob, sdo.n, q0, BQ, Nq, dg_attn::tid_now());
    dg_attn::commit();
    load_row_stats<BQ>(ms, ls, delta, base, q0, Nq, m_s, l_s, d_s);
    unsigned long long key[2] = {0ull, 0ull};
    if constexpr (DROPOUT) {
      key[0] = dg_attn::row_key(*seed, bz, hh, q0 + m0 + g);
      key[1] = dg_attn::row_key(*seed, bz, hh, q0 + m0 + g + 8);
    }
    dg_attn::wait_groups<0>();
    __syncthreads();
    if (scoring) {
      float s[NT][4], dpt[NT][4], pv[NT][4], ds[NT][4];
      tile_scores<D, RS, NT>(Qs, Ks, m0, kofs, s);
      tile_scores<D, RS, NT>(dOs, Vs, m0, kofs, dpt);
      each_score<DROPOUT, NT>(
          s, dpt, m_s, l_s, key, m0, kofs, q0, k0, Nq, Nk, scale, thresh,
          inv, [&](int j, int e, float p, float pt, float dp) {
            pv[j][e] = pt;
            ds[j][e] = dsb(p, dp, d_s[m0 + g + 8 * (e >> 1)], scale);
          });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (m0 + g) * PS + kofs + 8 * j + 2 * t;
        *reinterpret_cast<unsigned*>(Pt + o) =
            dg_bf16::pack(pv[j][0], pv[j][1]);
        *reinterpret_cast<unsigned*>(Pt + o + 8 * PS) =
            dg_bf16::pack(pv[j][2], pv[j][3]);
        *reinterpret_cast<unsigned*>(dS + o) =
            dg_bf16::pack(ds[j][0], ds[j][1]);
        *reinterpret_cast<unsigned*>(dS + o + 8 * PS) =
            dg_bf16::pack(ds[j][2], ds[j][3]);
      }
    }
    __syncthreads();
    // over the tile's BQ query rows, 16 at a time in ascending order; A
    // (keys x queries) is the transpose of the stored (queries x keys) tile:
    // matrix mi is keys + 8 (mi & 1), queries + 8 (mi >> 1); B (queries x
    // columns) likewise from the stored rows: queries + 8 (mi & 1), columns
    // + 8 (mi >> 1)
#pragma unroll
    for (int n = 0; n < ON; n += 2) {
      float part[KM][2][4];
#pragma unroll
      for (int a = 0; a < KM; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[a][0][e] = part[a][1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        unsigned b[4];
        dg_bf16::ldsm_x4_trans(
            b, Bs + (16 * kk + rr + 8 * (mi & 1)) * RS + cn + 8 * n +
                   8 * (mi >> 1));
#pragma unroll
        for (int a = 0; a < KM; ++a) {
          unsigned af[4];
          dg_bf16::ldsm_x4_trans(
              af, As + (16 * kk + rr + 8 * (mi >> 1)) * PS + 16 * a +
                      8 * (mi & 1));
          dg_bf16::mma(part[a][0], af, b[0], b[1]);
          dg_bf16::mma(part[a][1], af, b[2], b[3]);
        }
      }
#pragma unroll
      for (int a = 0; a < KM; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[a][n][e] += part[a][0][e];
          acc[a][n + 1][e] += part[a][1][e];
        }
    }
    __syncthreads();  // every warp is done with Qs, dOs, Pt and dS
  }

  bf16* out = warp < 4 ? dv + bz * sdv.b + hh * sdv.h
                       : dk + bz * sdk.b + hh * sdk.h;
  const long long stride = warp < 4 ? sdv.n : sdk.n;
#pragma unroll
  for (int a = 0; a < KM; ++a)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = k0 + 16 * a + g + 8 * half;
      if (r >= Nk) continue;
      bf16* row = out + r * stride + cn + 2 * t;
#pragma unroll
      for (int n = 0; n < ON; ++n)
        *reinterpret_cast<unsigned*>(row + 8 * n) =
            dg_bf16::pack(acc[a][n][2 * half], acc[a][n][2 * half + 1]);
    }
}

template <int D, bool DROPOUT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* ms, const float* ls,
                   float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int H,
                   int Nq, int Nk, const long long* st, float scale,
                   const long long* seed, unsigned thresh, float inv,
                   cudaStream_t stream) {
  auto S = [st](int t) {
    return Strides{st[3 * t], st[3 * t + 1], st[3 * t + 2]};
  };
  // strides: q 0, k 1, v 2, dO 3, dq 4, dk 5, dv 6
  using Q = DqTile<D>;
  cudaError_t e = cudaFuncSetAttribute(
      dq_bf16_kernel<D, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::SMEM);
  if (e != cudaSuccess) return e;
  dq_bf16_kernel<D, DROPOUT>
      <<<dim3((Nq + Q::BQ - 1) / Q::BQ, H, B), THREADS, Q::SMEM, stream>>>(
          q, k, v, dout, ms, ls, delta, dq, Nq, Nk, S(0), S(1), S(2), S(3),
          S(4), scale, seed, thresh, inv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  using K = DkdvTile<D>;
  e = cudaFuncSetAttribute(dkdv_bf16_kernel<D, DROPOUT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)K::SMEM);
  if (e != cudaSuccess) return e;
  dkdv_bf16_kernel<D, DROPOUT>
      <<<dim3((Nk + K::BK - 1) / K::BK, H, B), THREADS, K::SMEM, stream>>>(
          q, k, v, dout, ms, ls, delta, dk, dv, Nq, Nk, S(0), S(1), S(2),
          S(3), S(5), S(6), scale, seed, thresh, inv);
  return cudaGetLastError();
}

template <bool DROPOUT>
int launch_d(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
             const float* ms, const float* ls, float* delta, bf16* dq,
             bf16* dk, bf16* dv, int B, int H, int Nq, int Nk, int D,
             const long long* st, float scale, const long long* seed,
             unsigned thresh, float inv, cudaStream_t stream) {
  switch (D) {
    case 128:
      return (int)launch<128, DROPOUT>(q, k, v, dout, ms, ls, delta, dq, dk,
                                       dv, B, H, Nq, Nk, st, scale, seed,
                                       thresh, inv, stream);
    case 256:
      return (int)launch<256, DROPOUT>(q, k, v, dout, ms, ls, delta, dq, dk,
                                       dv, B, H, Nq, Nk, st, scale, seed,
                                       thresh, inv, stream);
    case 512:
      return (int)launch<512, DROPOUT>(q, k, v, dout, ms, ls, delta, dq, dk,
                                       dv, B, H, Nq, Nk, st, scale, seed,
                                       thresh, inv, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D), dO and dq (B, H, Nq, D), dk and
// dv (B, H, Nk, D): bf16 on the device with unit stride along D; strides
// (host, 21 values) are the (b, h, row) strides in elements of q, k, v, dO,
// dq, dk and dv.  q, k, v and dO start 16-byte aligned with strides that
// are multiples of 8; dq, dk and dv start 4-byte aligned with even
// strides.  ms and ls (the forward's row max and sum) and delta (scratch)
// are (B, H, Nq) f32 contiguous.  With `seed` (one int64 on the device) the
// mask of attention.cuh's stream at threshold `thresh` applies, kept
// entries scaled by `inv`; a null seed is rate 0.  D is 128, 256 or 512.
// Two launches on `stream`; returns the first CUDA error.
extern "C" int dg_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* ms, const float* ls, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int Nq, int Nk, int D, const long long* strides,
    float scale, const long long* seed, unsigned thresh, float inv,
    void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout})
    if ((size_t)p % 16) return (int)cudaErrorMisalignedAddress;
  for (const void* p : {dq, dk, dv})
    if ((size_t)p % 4) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return (int)cudaErrorMisalignedAddress;
  for (int i = 12; i < 21; ++i)
    if (strides[i] % 2) return (int)cudaErrorMisalignedAddress;
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v),
             *dd = static_cast<const bf16*>(dout);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk),
       *gv = static_cast<bf16*>(dv);
  cudaStream_t st = (cudaStream_t)stream;
  if (seed != nullptr)
    return launch_d<true>(qq, kk, vv, dd, ms, ls, delta, gq, gk, gv, B, H, Nq,
                          Nk, D, strides, scale, seed, thresh, inv, st);
  return launch_d<false>(qq, kk, vv, dd, ms, ls, delta, gq, gk, gv, B, H, Nq,
                         Nk, D, strides, scale, nullptr, 0u, 1.f, st);
}
