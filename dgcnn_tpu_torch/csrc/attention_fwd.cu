// attention_fwd: multi-head softmax attention, forward, on Hopper (sm_90a),
// with dropout on the probabilities in training.
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::_attn_fwd_impl
// (body _attn_fwd_kernel), the attention of every TorchMultiheadAttention
// of the fusion Net:
//
//   o[b, h] = dropout(softmax(q[b, h] k[b, h]^T * scale)) v[b, h]
//
// dropout keeps a probability when its bit of the stream of attention.cuh
// says so and scales it by 1 / (1 - rate); the row's softmax sum is taken
// over the probabilities before the mask, as the TPU kernel's _probs and
// then its mask do.  In training the kernel also writes each row's
// log-sum-exp lse = max + log(sum) of the scaled scores, from which the
// backward (attention_bwd.cu) rebuilds the probabilities in one pass.
// Dropout and the log-sum-exp are template flags: the training instance at
// rate 0 (<D, false, true>) runs the eval instance's arithmetic in the same
// order and adds the log-sum-exp's store, so the two give the same o.
//
// q (B, h, Nq, d), k and v (B, h, Nk, d), o (B, h, Nq, d), each given by
// its base and its (b, h, row) strides with unit stride along d, so that
// the heads of a (B, N, h * d) projection are read in place and o can be
// written as (B, Nq, h * d).
//
// Bound on an H100 SXM: operations.  At the fusion Net's stacked shape
// (B=32, h=2, N=2048, d=256) the two products are 2 * 2*B*h*N^2*d = 2.7e11
// flops: ~4.1 ms at the f32 CUDA-core peak (67 TFLOP/s); in three TF32
// terms each (8.2e11 tensor flops) ~1.67 ms at the dense TF32 peak (495
// TFLOP/s), plus B*h*N^2 scales, maxima, exponentials and sums on the CUDA
// cores; q, k, v and o are 4 * 134 MB, ~0.16 ms at 3.35 TB/s.
//
// Design at d = 128 and 256: flash attention's online softmax, so the (Nq,
// Nk) scores never reach device memory, with both products on the tensor
// cores in three TF32 terms (mma_tf32.cuh: every f32 operand split into hi
// and lo, lo*hi + hi*lo then hi*hi through mma.sync m16n8k8), near f32
// roundoff.  A block of 8 warps owns BQ = 128 query rows of one (b, h), a
// warp 16 of them; the Q tile stays in shared memory, key tiles of BK = 32
// rows stream through two buffers (the next tile lands while this one is
// used) and value tiles through one (it lands while the scores run), all
// by cp.async, 16 bytes a copy.  For each key tile a warp
//   1. takes its 16 x 32 scores s = Q K^T as four m16n8 accumulators,
//      reading Q and K along their rows as float4s (two k-steps a load),
//      each 32 columns of d into a fresh accumulator added to s in f32;
//   2. runs the online softmax on the accumulator fragments (the row's max
//      and sum over the four lanes that share it, by shuffles), drops and
//      scales P in training;
//   3. adds P V into its 16 x d output in registers (d / 2 floats a lane).
//      P never goes through shared memory: an accumulator fragment holds
//      (row g, keys 2t, 2t + 1), an A fragment (row g, k slots t, t + 4),
//      so k slot t of the product is taken as key 2t and slot t + 4 as key
//      2t + 1, and the B fragment reads V rows 2t and 2t + 1 to match (a
//      product's sum does not depend on the order of k).  Each 8 columns
//      of o take the tile's 32 keys into a fresh accumulator, which then
//      joins the running sum in f32 with the softmax's rescale.
// The tensor core's sum cuts toward zero, so no chain of MMAs into one
// accumulator is longer than 12 (kernel 15's finding: one long chain
// drifted to 4e-5 of a row's norm).  Q and K are swizzled in shared
// memory (mma_tf32.cuh) so the float4 row reads are conflict-free; V keeps
// rows padded by 4 floats, on which the B reads (rows 2t and 2t + 1,
// column g) touch 32 banks.  Every operand is split as it is read.  Shared
// memory is ~225 KB at d = 256, one block an SM, up to 255 registers a
// thread: the output accumulator alone is 128, and the copies in the key
// loop recompute their addresses (tid_now) so that nothing else is held
// across the products.
//
// At d = 512 that accumulator would be 256 registers a lane, so the d = 512
// instances run the CUDA-core form (attention_fwd_simt.cuh).  Every row of
// q, k and v starts 16-byte aligned (the wrapper, ops/attention.py, copies
// an input that does not).  Times against both bounds are in PERF.md
// (chip_smoke.py, phases 27 and 31; tools/attention_ab.py).
#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "attention_fwd_simt.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace dg_attn;
using dg_mma::FragA;
using dg_mma::FragB;

template <int D>
struct Tile {
  static constexpr int BQ = 128;    // query rows a block, 16 a warp
  static constexpr int BK = 32;     // keys a tile
  static constexpr int NT = BK / 8;  // score n-tiles (8 keys) a warp
  static constexpr int ON = D / 8;   // output n-tiles (8 columns) a warp
  static constexpr int VS = D + 4;   // V row stride (floats)
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * D + 2 * (size_t)BK * D +
                       (size_t)BK * VS);
  static_assert(BQ == 16 * (THREADS / 32), "a warp owns 16 query rows");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The scores of the warp's 16 rows (m0 + g, m0 + g + 8 of the Q tile)
// against the BK keys of the tile Ks: s[0][j] is the m16n8 accumulator of
// keys 8 j .. 8 j + 7.  Each 32 columns of d sum into a fresh accumulator,
// added to s in f32.
template <int D, int NT>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks,
                                            int m0, float (&s)[1][NT][4]) {
  using namespace dg_mma;
  const int g = lane_g();
  float ps[1][NT][4];
  zero_tiles(s);
  zero_tiles(ps);
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 32) {
#pragma unroll
    for (int h = 0; h < 32; h += 16) {
      FragA qa[2];
      split_a_quads(load_quad<D>(Qs, m0 + g, c0, h),
                    load_quad<D>(Qs, m0 + g + 8, c0, h), qa[0], qa[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB kb[2];
        split_b_quad(load_quad<D>(Ks, 8 * j + g, c0, h), kb[0], kb[1]);
        mma3(ps[0][j], qa[0], kb[0]);
        mma3(ps[0][j], qa[1], kb[1]);
      }
    }
    add_tiles(s, ps);
  }
}

// Training adds the dropout of the probabilities (DROPOUT: the stream of
// `seed`, kept when the draw is >= thresh, scaled by inv) and the
// log-sum-exp of each row, written to lse (LSE; (B, H, Nq) contiguous).
template <int D, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int Nq, int Nk, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale, const long long* seed,
                    unsigned thresh, float inv, float* __restrict__ lse) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, NT = T::NT, ON = T::ON, VS = T::VS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Kb = Qs + BQ * D;  // two buffers of BK rows
  float* Vs = Kb + 2 * BK * D;
  const int g = dg_mma::lane_g(), t = dg_mma::lane_t();
  const int m0 = 16 * (threadIdx.x >> 5);
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = q + bz * sq.b + hh * sq.h;
  const float* kb = k + bz * sk.b + hh * sk.h;
  const float* vb = v + bz * sv.b + hh * sv.h;

  dg_mma::load_rows<D>(Qs, qb, sq.n, q0, BQ, Nq);
  dg_mma::load_rows<D>(Kb, kb, sk.n, 0, BK, Nk);
  commit();

  // acc[n]: rows g, g + 8 and columns 8 n + 2t, 8 n + 2t + 1 of the warp's
  // output; m, l: the running max and sum of rows g (0) and g + 8 (1)
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  unsigned long long key[2] = {0ull, 0ull};
  if constexpr (DROPOUT) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      key[half] = row_key(*seed, bz, hh, q0 + m0 + g + 8 * half);
  }
  // the lane's V operand: rows 2t (+ 1) of each 8-key group, column g of
  // each 8-column tile
  const float* vl = Vs + 2 * t * VS + g;

  for (int k0 = 0, it = 0; k0 < Nk; k0 += BK, ++it) {
    wait_groups<0>();  // this thread's copies of K (this tile) have landed
    // every thread's too, and every warp is done with Vs and with the K
    // buffer the next copy fills
    __syncthreads();
    load_rows<D>(Vs, vb, sv.n, k0, BK, Nk, tid_now());
    commit();
    if (k0 + BK < Nk)
      dg_mma::load_rows<D>(Kb + ((it + 1) & 1) * BK * D, kb, sk.n, k0 + BK,
                           BK, Nk, tid_now());
    commit();

    float s[1][NT][4];
    tile_scores<D, NT>(Qs, Kb + (it & 1) * BK * D, m0, s);

    // online softmax on the fragments: element e of s[0][j] is row g + 8
    // (e / 2), key k0 + 8 j + 2t + e % 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = k0 + 8 * j + 2 * t + (e & 1) < Nk
                            ? s[0][j][e] * scale
                            : -INFINITY;
        s[0][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      mx[half] = fmaxf(m[half], mx[half]);
      alpha[half] = expf(m[half] - mx[half]);  // 0 on the first tile
      m[half] = mx[half];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[0][j][e] - mx[e >> 1]);
        sum[e >> 1] += p;
        if constexpr (DROPOUT)
          s[0][j][e] =
              keep(key[e >> 1], k0 + 8 * j + 2 * t + (e & 1), thresh)
                  ? p * inv
                  : 0.f;
        else
          s[0][j][e] = p;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      l[half] = l[half] * alpha[half] + sum[half];
    }
    // P as the A operand of k-step j: slot t = key 8 j + 2t, slot t + 4 =
    // key 8 j + 2t + 1
    FragA pa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      dg_mma::split(s[0][j][0], pa[j].hi[0], pa[j].lo[0]);
      dg_mma::split(s[0][j][2], pa[j].hi[1], pa[j].lo[1]);
      dg_mma::split(s[0][j][1], pa[j].hi[2], pa[j].lo[2]);
      dg_mma::split(s[0][j][3], pa[j].hi[3], pa[j].lo[3]);
    }

    wait_groups<1>();  // this thread's copies of V have landed
    __syncthreads();   // and every thread's
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB vf;
        dg_mma::split(vl[8 * j * VS + 8 * n], vf.hi[0], vf.lo[0]);
        dg_mma::split(vl[(8 * j + 1) * VS + 8 * n], vf.hi[1], vf.lo[1]);
        dg_mma::mma3(part, pa[j], vf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * alpha[e >> 1] + part[e];
    }
  }

  float* ob = o + bz * so.b + hh * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + m0 + g + 8 * half;
    if (r >= Nq) continue;
    if constexpr (LSE) {
      if (t == 0)
        lse[((long long)bz * gridDim.y + hh) * Nq + r] =
            m[half] + logf(l[half]);
    }
    float* orow = ob + r * so.n + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      orow[8 * n] = acc[n][2 * half] / l[half];
      orow[8 * n + 1] = acc[n][2 * half + 1] / l[half];
    }
  }
}

template <int D, bool DROPOUT, bool LSE>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int Nq, int Nk, const long long* st,
                   float scale, const long long* seed, unsigned thresh,
                   float inv, float* lse, cudaStream_t stream) {
  if constexpr (D >= 512) {
    return dg_simt::launch_simt<D, DROPOUT, LSE>(
        q, k, v, o, B, H, Nq, Nk, st, scale, seed, thresh, inv, lse, stream);
  } else {
    using T = Tile<D>;
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<D, DROPOUT, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid((Nq + T::BQ - 1) / T::BQ, H, B);
    attn_fwd_kernel<D, DROPOUT, LSE><<<grid, THREADS, T::SMEM, stream>>>(
        q, k, v, o, Nq, Nk, Strides{st[0], st[1], st[2]},
        Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
        Strides{st[9], st[10], st[11]}, scale, seed, thresh, inv, lse);
    return cudaGetLastError();
  }
}

template <bool DROPOUT, bool LSE>
int launch_d(const float* q, const float* k, const float* v, float* o,
             int B, int H, int Nq, int Nk, int D, const long long* strides,
             float scale, const long long* seed, unsigned thresh, float inv,
             float* lse, cudaStream_t st) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (const float* p : {q, k, v})
    if ((size_t)p % 16) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 4) return (int)cudaErrorMisalignedAddress;
  switch (D) {
    case 128:
      return (int)launch<128, DROPOUT, LSE>(q, k, v, o, B, H, Nq, Nk, strides,
                                            scale, seed, thresh, inv, lse, st);
    case 256:
      return (int)launch<256, DROPOUT, LSE>(q, k, v, o, B, H, Nq, Nk, strides,
                                            scale, seed, thresh, inv, lse, st);
    case 512:
      return (int)launch<512, DROPOUT, LSE>(q, k, v, o, B, H, Nq, Nk, strides,
                                            scale, seed, thresh, inv, lse, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Nq, D), k and v (B, H, Nk, D), o (B, H, Nq, D), f32 on the
// device, unit stride along D; strides (host, 12 values) are the (b, h,
// row) strides in elements of q, k, v and o.  q, k and v start 16-byte
// aligned and their strides are multiples of 4.  D is 128, 256 or 512.
// The evaluation form: no dropout, no log-sum-exp.  Returns the first CUDA
// error.
extern "C" int dg_attention_fwd(const float* q, const float* k,
                                const float* v, float* o, int B, int H,
                                int Nq, int Nk, int D,
                                const long long* strides, float scale,
                                void* stream) {
  return launch_d<false, false>(q, k, v, o, B, H, Nq, Nk, D, strides, scale,
                                nullptr, 0u, 1.f, nullptr,
                                (cudaStream_t)stream);
}

// The training form: as dg_attention_fwd, and lse (B, H, Nq) f32
// contiguous on the device receives each row's log-sum-exp.  With `seed`
// (one int64 on the device) the probabilities are dropped by the stream of
// attention.cuh at threshold `thresh` and the kept ones scaled by `inv`;
// a null seed is rate 0.
extern "C" int dg_attention_fwd_train(const float* q, const float* k,
                                      const float* v, float* o, int B, int H,
                                      int Nq, int Nk, int D,
                                      const long long* strides, float scale,
                                      const long long* seed, unsigned thresh,
                                      float inv, float* lse, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (seed != nullptr)
    return launch_d<true, true>(q, k, v, o, B, H, Nq, Nk, D, strides, scale,
                                seed, thresh, inv, lse, st);
  return launch_d<false, true>(q, k, v, o, B, H, Nq, Nk, D, strides, scale,
                               nullptr, 0u, 1.f, lse, st);
}
