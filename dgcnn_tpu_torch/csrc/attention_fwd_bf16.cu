// attention_fwd_bf16: kernel 14's AMP form, multi-head softmax attention
// on bf16 q, k and v, on Hopper (sm_90a): its evaluation form (rate 0) and
// its training form (dropout on the probabilities, each row's max and sum
// written out for the backward, attention_bwd_bf16.cu).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::_attn_fwd_impl
// (body _attn_fwd_kernel, :103-115) on the bf16 inputs of the AMP fusion
// Net (its transformer and last attention in bf16,
// dgcnn_tpu/models/torch_transformer.py), in eval and in training:
//
//   s = (q k^T) * scale          bf16 x bf16 products, f32 sums
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)      in f32, whole row
//   p~ = keep ? p * inv : 0      training at rate > 0: the mask of
//                                attention.cuh, inv = 1 / (1 - rate), f32
//   o = bf16( bf16(p~) v )       p~ rounded to bf16 AFTER normalization,
//                                f32 sums, the output rounded to bf16
//
// q (B, h, Nq, d), k and v (B, h, Nk, d), o (B, h, Nq, d), bf16, each given
// by its base and its (b, h, row) strides with unit stride along d (the
// heads of a (B, N, h * d) projection read in place, o written as (B, Nq,
// h * d)).  The training form also writes each row's max m and sum l
// (B, h, Nq) f32, from which the backward rebuilds p with these
// instructions; at rate 0 its o is the evaluation form's, bit for bit.
//
// Bound on an H100 SXM: operations.  At the fusion Net's stacked shape
// (B=32, h=2, N=2048, d=256) the two products are 2 * 2*B*h*N^2*d =
// 2.75e11 flops, 0.278 ms at the dense bf16 tensor-core rate (989
// TFLOP/s); q, k, v and o are 4 * 67 MB, ~0.08 ms at 3.35 TB/s.
//
// Design: two passes over the keys, because p is rounded to bf16 after it
// is normalized: flash attention's online softmax would round unnormalized
// values and rescale them later, which moves o by up to an ulp of p.
//   pass 1: for each key tile, the scores (below) and each row's running
//     max m and sum l = sum exp(s - m), rescaled when m grows;
//   pass 2: the scores again (the same instructions in the same order:
//     the same bits), p = exp(s - m) / l in f32 (the _rn intrinsics keep
//     the scale and the subtraction out of an FMA, as in pass 1), dropped
//     and scaled in training, rounded to bf16 into shared memory, then P V
//     into the output in registers.
// A block of 8 warps owns BQ query rows of one (b, h): at d = 128 and 256
// a warp owns 16 rows and all d columns of o (d / 2 f32 accumulators a
// lane, 128 at d = 256); at d = 512 that would be 256 registers a lane, so
// two warps share 16 rows, each scoring half of every key tile and owning
// half of o's columns (CS = 2 below), their (m, l) combined through shared
// memory after pass 1.  The Q tile stays in shared memory; key tiles of BK
// rows stream through two buffers (the next lands while this one is
// scored) and value tiles through one, by cp.async, 16 bytes a copy.
// Products are mma.sync m16n8k16 on bf16 fragments read by ldmatrix (V by
// ldmatrix.trans): each 32 columns of d sum into a fresh accumulator that
// joins the scores in f32 (attention_bf16.cuh, shared with the backward),
// and each key tile's P V into a fresh one that joins o in f32, so no
// chain of MMAs into one accumulator is longer than four (the tensor
// core's sum truncates; mma_bf16.cuh).  P goes through shared memory in
// bf16 (BQ x BK), which also hands a row group's probabilities to both of
// its warps at d = 512.
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

template <int D>
struct BTile {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CS = D > 256 ? 2 : 1;  // warps sharing 16 rows
  static constexpr int BQ = 16 * WARPS / CS;  // query rows a block
  static constexpr int BK = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int KW = BK / CS;          // keys a warp scores
  static constexpr int NT = KW / 8;           // its score n-tiles
  static constexpr int DC = D / CS;           // columns of o a warp owns
  static constexpr int ON = DC / 8;           // its output n-tiles
  static constexpr int RS = D + 8;            // Q, K, V row stride (bf16)
  static constexpr int PS = BK + 8;           // P row stride
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)BQ * RS + 3 * (size_t)BK * RS +
                      (size_t)BQ * PS) +
      sizeof(float) * 2 * BQ * CS + sizeof(unsigned long long) * BQ;
  static_assert(NT % 2 == 0 && ON % 2 == 0 && BK % 16 == 0, "tiles");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// DROPOUT: the training form at rate > 0 (the keep bits of `seed` at
// `thresh`, kept probabilities times `inv`); ms and ls, when not null,
// receive each row's max and sum, (B, h, Nq) contiguous.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 1)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int Nq, int Nk, Strides sq, Strides sk, Strides sv,
                         Strides so, float scale, const long long* seed,
                         unsigned thresh, float inv, float* __restrict__ ms,
                         float* __restrict__ ls) {
  using T = BTile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, CS = T::CS, KW = T::KW, NT = T::NT;
  constexpr int DC = T::DC, ON = T::ON, RS = T::RS, PS = T::PS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Kb = Qs + BQ * RS;  // two buffers of BK rows
  bf16* Vs = Kb + 2 * BK * RS;
  bf16* Ps = Vs + BK * RS;
  float* ml = reinterpret_cast<float*>(Ps + BQ * PS);  // (BQ, CS, {m, l})
  // the dropout keys of the block's rows (in shared memory: at d = 256 and
  // 512 the output's accumulators leave no registers for them)
  unsigned long long* rkey =
      reinterpret_cast<unsigned long long*>(ml + 2 * BQ * CS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int ks = warp % CS, m0 = 16 * (warp / CS);
  const int kofs = ks * KW;
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * BQ;
  const bf16* qb = q + bz * sq.b + hh * sq.h;
  const bf16* kb = k + bz * sk.b + hh * sk.h;
  const bf16* vb = v + bz * sv.b + hh * sv.h;

  load_rows<D, RS>(Qs, qb, sq.n, q0, BQ, Nq, threadIdx.x);
  load_rows<D, RS>(Kb, kb, sk.n, 0, BK, Nk, threadIdx.x);
  dg_attn::commit();

  // pass 1: m, l of rows g (half 0) and g + 8 (half 1) over the warp's keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0, it = 0; k0 < Nk; k0 += BK, ++it) {
    dg_attn::wait_groups<0>();
    __syncthreads();
    if (k0 + BK < Nk)
      load_rows<D, RS>(Kb + ((it + 1) & 1) * BK * RS, kb, sk.n, k0 + BK, BK,
                       Nk, dg_attn::tid_now());
    dg_attn::commit();
    float s[NT][4];
    dg_attn_bf16::tile_scores<D, RS, NT>(Qs, Kb + (it & 1) * BK * RS, m0,
                                         kofs, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = k0 + kofs + 8 * j + 2 * t + (e & 1) < Nk
                            ? __fmul_rn(s[j][e], scale)
                            : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      mx[half] = fmaxf(m[half], mx[half]);  // the new running max
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s[j][e] > -INFINITY)
          sum[e >> 1] += expf(__fsub_rn(s[j][e], mx[e >> 1]));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      if (mx[half] == -INFINITY) continue;  // no key of the row yet
      l[half] = (m[half] == -INFINITY ? 0.f
                                      : l[half] * expf(m[half] - mx[half])) +
                sum[half];
      m[half] = mx[half];
    }
  }
  if constexpr (CS > 1) {  // the row group's warps combine their halves
    if (t == 0)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* e = ml + ((m0 + g + 8 * half) * CS + ks) * 2;
        e[0] = m[half];
        e[1] = l[half];
      }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* e = ml + (m0 + g + 8 * half) * CS * 2;
      float mm = -INFINITY;
#pragma unroll
      for (int c = 0; c < CS; ++c) mm = fmaxf(mm, e[2 * c]);
      float ll = 0.f;
#pragma unroll
      for (int c = 0; c < CS; ++c)
        if (e[2 * c] > -INFINITY) ll += e[2 * c + 1] * expf(e[2 * c] - mm);
      m[half] = mm;
      l[half] = ll;
    }
  }

  if (ms != nullptr && t == 0 && ks == 0) {
    const long long base = ((long long)bz * gridDim.y + hh) * Nq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + m0 + g + 8 * half;
      if (r < Nq) {
        ms[base + r] = m[half];
        ls[base + r] = l[half];
      }
    }
  }
  if constexpr (DROPOUT)
    for (int r = threadIdx.x; r < BQ; r += THREADS)
      rkey[r] = dg_attn::row_key(*seed, bz, hh, q0 + r);

  // pass 2: the first key tile again, into buffer 0 once every warp is
  // done with pass 1's buffers
  __syncthreads();
  load_rows<D, RS>(Kb, kb, sk.n, 0, BK, Nk, dg_attn::tid_now());
  dg_attn::commit();
  // acc[n]: rows g, g + 8 and columns ks * DC + 8 n + 2t (+ 1) of o
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k0 = 0, it = 0; k0 < Nk; k0 += BK, ++it) {
    dg_attn::wait_groups<0>();  // this tile's K has landed
    // every thread's too, and every warp is done with Vs, Ps and the K
    // buffer the next copy fills
    __syncthreads();
    load_rows<D, RS>(Vs, vb, sv.n, k0, BK, Nk, dg_attn::tid_now());
    dg_attn::commit();
    if (k0 + BK < Nk)
      load_rows<D, RS>(Kb + ((it + 1) & 1) * BK * RS, kb, sk.n, k0 + BK, BK,
                       Nk, dg_attn::tid_now());
    dg_attn::commit();
    float s[NT][4];
    dg_attn_bf16::tile_scores<D, RS, NT>(Qs, Kb + (it & 1) * BK * RS, m0,
                                         kofs, s);
    // p = exp(s - m) / l (dropped and scaled in training), rounded to
    // bf16, into the row group's rows of Ps
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + kofs + 8 * j + 2 * t + (e & 1);
        p[e] = col < Nk ? dg_attn_bf16::prob(s[j][e], scale, m[e >> 1],
                                             l[e >> 1])
                        : 0.f;
        if constexpr (DROPOUT)
          p[e] = dg_attn::keep(rkey[m0 + g + 8 * (e >> 1)], col, thresh)
                     ? __fmul_rn(p[e], inv)
                     : 0.f;
      }
      bf16* pr = Ps + (m0 + g) * PS + kofs + 8 * j + 2 * t;
      *reinterpret_cast<unsigned*>(pr) = dg_bf16::pack(p[0], p[1]);
      *reinterpret_cast<unsigned*>(pr + 8 * PS) = dg_bf16::pack(p[2], p[3]);
    }
    dg_attn::wait_groups<1>();  // this thread's copies of V have landed
    __syncthreads();            // every thread's, and every warp's P
    unsigned pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      dg_bf16::ldsm_x4(pa[kk], Ps + (m0 + rr + 8 * (mi & 1)) * PS +
                                   16 * kk + 8 * (mi >> 1));
    // V as B: matrix mi is keys + 8 (mi & 1), columns + 8 (mi >> 1)
    const bf16* va = Vs + (rr + 8 * (mi & 1)) * RS + ks * DC + 8 * (mi >> 1);
#pragma unroll
    for (int n = 0; n < ON; n += 2) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned b[4];
        dg_bf16::ldsm_x4_trans(b, va + 16 * kk * RS + 8 * n);
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

  bf16* ob = o + bz * so.b + hh * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + m0 + g + 8 * half;
    if (r >= Nq) continue;
    bf16* orow = ob + r * so.n + ks * DC + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<unsigned*>(orow + 8 * n) =
          dg_bf16::pack(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

template <int D, bool DROPOUT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int H, int Nq, int Nk, const long long* st,
                   float scale, const long long* seed, unsigned thresh,
                   float inv, float* ms, float* ls, cudaStream_t stream) {
  using T = BTile<D>;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_bf16_kernel<D, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Nq + T::BQ - 1) / T::BQ, H, B);
  attn_fwd_bf16_kernel<D, DROPOUT><<<grid, THREADS, T::SMEM, stream>>>(
      q, k, v, o, Nq, Nk, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale, seed, thresh, inv, ms, ls);
  return cudaGetLastError();
}

template <bool DROPOUT>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Nq, int Nk, int D, const long long* strides,
             float scale, const long long* seed, unsigned thresh, float inv,
             float* ms, float* ls, cudaStream_t st) {
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  switch (D) {
    case 128:
      return (int)launch<128, DROPOUT>(qq, kk, vv, oo, B, H, Nq, Nk, strides,
                                       scale, seed, thresh, inv, ms, ls, st);
    case 256:
      return (int)launch<256, DROPOUT>(qq, kk, vv, oo, B, H, Nq, Nk, strides,
                                       scale, seed, thresh, inv, ms, ls, st);
    case 512:
      return (int)launch<512, DROPOUT>(qq, kk, vv, oo, B, H, Nq, Nk, strides,
                                       scale, seed, thresh, inv, ms, ls, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int check_args(const void* q, const void* k, const void* v, const void* o,
               int B, int H, int Nq, int Nk, const long long* strides) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if ((size_t)p % 16) return (int)cudaErrorMisalignedAddress;
  if ((size_t)o % 4) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8) return (int)cudaErrorMisalignedAddress;
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 2) return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D), o (B, H, Nq, D), bf16 on the
// device, unit stride along D; strides (host, 12 values) are the (b, h,
// row) strides in elements of q, k, v and o.  q, k and v start 16-byte
// aligned and their strides are multiples of 8; o's are even.  D is 128,
// 256 or 512.  With `seed` (one int64 on the device) the mask of
// attention.cuh's stream at threshold `thresh` applies, kept probabilities
// scaled by `inv`; a null seed is rate 0.  ms and ls ((B, H, Nq) f32
// contiguous) take each row's max m and sum l, the training form; both
// null: the evaluation form, the same o.  Returns the first CUDA error.
extern "C" int dg_attention_fwd_bf16(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Nq, int Nk, int D,
                                     const long long* strides, float scale,
                                     const long long* seed, unsigned thresh,
                                     float inv, float* ms, float* ls,
                                     void* stream) {
  const int rc = check_args(q, k, v, o, B, H, Nq, Nk, strides);
  if (rc) return rc;
  if ((ms == nullptr) != (ls == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (seed != nullptr)
    return launch_d<true>(q, k, v, o, B, H, Nq, Nk, D, strides, scale, seed,
                          thresh, inv, ms, ls, st);
  return launch_d<false>(q, k, v, o, B, H, Nq, Nk, D, strides, scale,
                         nullptr, 0u, 1.f, ms, ls, st);
}
