// attention_fwd_wgmma: kernel 14's AMP forms (evaluation and training) on
// Hopper's warpgroup products (wgmma) fed by TMA, at d = 128 and 256.
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::
// _attn_fwd_impl (body _attn_fwd_kernel, :103-115) on bf16 q, k and v, as
// attention_fwd_bf16.cu (the earlier form, mma.sync; it keeps d = 512)
// does, and computes the same function (that file's header):
//
//   s = (q k^T) * scale          bf16 x bf16 products, f32 sums
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)      in f32, whole row
//   p~ = keep ? p * inv : 0      training at rate > 0
//   o = bf16( bf16(p~) v )       f32 sums, the output rounded to bf16
//
// in two passes over the keys (p is rounded after it is normalized), the
// training form writing each row's max m and sum l.
//
// Bound on an H100 SXM: operations.  At the fusion Net's stacked shape
// (B=32, h=2, N=2048, d=256) the two products are 2.75e11 flops, 0.278 ms
// at 989 TFLOP/s; the two passes score the keys twice, so the work is
// three products, ~0.42 ms.
//
// Design: a block of two warpgroups (256 threads, 255 registers a thread:
// o alone takes 128 at d = 256) owns 128 query rows of one (b, h), 64
// rows a warpgroup.  Lane 0 of warp 0 also feeds the block, between its
// own steps: it loads the Q tile once, then streams K tiles (pass 1) and
// K and V tiles (pass 2) of 64 keys by TMA (128-byte swizzle, d in blocks
// of 64 columns) through a ring of ST stages, each completed on its
// `full` mbarrier and released on its `empty` one by every warp.  (A
// producer warp of its own would make ptxas hold every thread to the
// registers of three warpgroups, 168.)  Each warpgroup:
//   scores (both passes): S = Q K^T by wgmma m64nNk16 from shared memory
//     (both operands K-major), each 32 columns of d two k16 products into
//     a fresh accumulator, that partial added to S in f32, the
//     column blocks ascending: attention_bf16.cuh's tile_scores sequence,
//     whose bits kernel 15's bf16 form (attention_bwd_bf16.cu) rebuilds p
//     from.  An MMA's output is a function of its operands and
//     accumulator alone, whatever instruction or tile computes it:
//     chip_smoke.py holds the scores' m and l to the earlier form's bits.
//     Four partials are in flight at once (two in pass 2 at d = 128,
//     where o's registers leave room for no more), each in its own
//     registers;
//   pass 1: each row's running max m and sum l over the earlier form's
//     key tiles (SUB keys: 32 at d = 256, 64 at d = 128), its operations
//     in its order, so that m and l are its bits;
//   pass 2, SUB keys at a time: p = exp(s * scale - m) / l (dropped and
//     scaled in training), rounded to bf16 in registers, where it is the A
//     operand of P V: wgmma m64nDk16 with A from registers and V's tile as
//     an MN-major B from shared memory, into o itself, every key's product
//     in turn (no round trip of P through shared memory, no partial
//     registers beside o's, which alone take 128 a thread at d = 256).
//     The earlier form added each key tile's P V to o in f32; this chain
//     runs to the end in the tensor core's sum, which truncates: o moves
//     by far less than its bf16 rounding (phase 46's check: one bf16 ulp
//     of the row's rms), at rate 0 the training form's o is still the
//     evaluation form's, and kernel 15 reads m and l, not o.
// Query rows past Nq and keys past Nk arrive as zeros; the keys are masked
// out of the softmax.  The dropout keep bit is attention.cuh's function
// of (seed, b, h, i, j): no tiling enters it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention.cuh"
#include "attention_bf16.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int D>
struct WTile {
  static constexpr int BQ = 128;   // query rows a block (two warpgroups)
  static constexpr int BKT = 64;   // keys a tile of the ring
  static constexpr int SUB = D > 128 ? 32 : 64;  // the earlier form's tile
  // score partials in flight at once: pass 1's (64 keys), pass 2's (SUB
  // keys), as o's registers allow
  static constexpr int DEPTH1 = 4, DEPTH2 = D > 128 ? 4 : 2;
  static constexpr int DB = D / 64;              // 64-column blocks of d
  static constexpr int TILE = BKT * D * 2;       // a K or V tile, bytes
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int ST = D > 128 ? 5 : 12;    // stages of the ring
  static constexpr int THREADS = 256;             // two warpgroups
  static constexpr size_t SMEM = 1024 + QBYTES + (size_t)ST * TILE +
                                 sizeof(uint64_t) * (2 * ST + 1);
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert((D / 32) % DEPTH1 == 0 && (D / 32) % DEPTH2 == 0,
                "partial sums in whole batches");
};

struct Args {
  int Nq, Nk;
  float scale;
  const long long* seed;
  unsigned thresh;
  float inv;
  float* ms;
  float* ls;
  bf16* o;
  long long ob, oh, on;  // o's strides, elements
  int qh, kh, vh;        // 1: the map's dim 1 is h, else the rows
};

// Loads the box at column c0, row r, head h, batch b of a map whose dim 1
// is h (hfirst) or the rows.
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* m,
                                          uint64_t* bar, int hfirst, int c0,
                                          int r, int h, int b) {
  if (hfirst)
    dg_tma::load_4d(dst, m, bar, c0, h, r, b);
  else
    dg_tma::load_4d(dst, m, bar, c0, r, h, b);
}

// Starts one 32-column block c0 of d of the scores of the warpgroup's 64
// query rows (Qw: their rows of the Q tile, d in blocks of 128 rows)
// against NK keys from row koff of a K tile Kt (d in blocks of 64 rows):
// two k16 products into a fresh p (the first with scale-d 0), as
// attention_bf16.cuh's sequence (mma.sync onto a zeroed accumulator: the
// same value, and a zero's sign is lost when the partial joins the
// scores' f32 sum, which starts at +0).
template <int NK>
__device__ __forceinline__ void start_scores(float (&p)[NK / 2],
                                             const uint8_t* Qw,
                                             const uint8_t* Kt, int koff,
                                             int c0) {
  constexpr int QBLK = 128 * 128, KBLK = 64 * 128;
  dg_wgmma::fence();
#pragma unroll
  for (int kk2 = 0; kk2 < 2; ++kk2) {
    const int kk = 2 * c0 + kk2;  // the k16 step along d
    const int blk = kk >> 2, off = 2 * (kk & 3);  // 32 bytes a step
    const uint64_t da = dg_wgmma::desc(Qw + blk * QBLK) + off;
    const uint64_t db = dg_wgmma::desc(Kt + blk * KBLK + koff * 128) + off;
    if constexpr (NK == 32)
      dg_wgmma::mma_ss_n32<0>(p, da, db, kk2);
    else
      dg_wgmma::mma_ss_n64<0>(p, da, db, kk2);
  }
  dg_wgmma::commit();
}

// The raw scores of the warpgroup's 64 query rows against NK keys from
// row koff of Kt: sc[4 j + 2 h + c] is row 16 w + g + 8 h, key koff + 8 j
// + 2 t + c.  The D / 32 partials sum in ascending order; DEPTH of them
// are in flight at once, each in its own registers.
template <int D, int NK, int DEPTH>
__device__ __forceinline__ void tile_scores(float (&sc)[NK / 2],
                                            const uint8_t* Qw,
                                            const uint8_t* Kt, int koff) {
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) sc[i] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < D / 32; c0 += DEPTH) {
    float p[DEPTH][NK / 2];
#pragma unroll
    for (int b = 0; b < DEPTH; ++b)
      start_scores<NK>(p[b], Qw, Kt, koff, c0 + b);
    dg_wgmma::wait<0>();
#pragma unroll
    for (int b = 0; b < DEPTH; ++b) {
      dg_wgmma::hold(p[b]);
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) sc[i] += p[b][i];
    }
  }
}

// Starts o += P V over the SUB keys from row koff of the V tile Vt (d in
// blocks of 64 rows: an MN-major B, 64 columns a block, 8192 bytes on; a
// k16 step 16 rows, 2048 bytes, on), o the accumulator of every key's
// product in turn.
template <int D>
__device__ __forceinline__ void start_pv(
    float (&o)[D / 2], const uint32_t (&pa)[WTile<D>::SUB / 16][4],
    const uint8_t* Vt, int koff) {
  dg_wgmma::fence();
  const uint64_t dv = dg_wgmma::desc(Vt + koff * 128, 64 * 128);
#pragma unroll
  for (int k2 = 0; k2 < WTile<D>::SUB / 16; ++k2) {
    if constexpr (D == 256)
      dg_wgmma::mma_rs_n256<1>(o, pa[k2], dv + k2 * (2048 >> 4), 1);
    else
      dg_wgmma::mma_rs_n128<1>(o, pa[k2], dv + k2 * (2048 >> 4), 1);
  }
  dg_wgmma::commit();
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(WTile<D>::THREADS, 1)
    attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, Args a) {
  using T = WTile<D>;
  constexpr int ST = T::ST, SUB = T::SUB;
  constexpr int DB = T::DB, TILE = T::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* ring = Qs + T::QBYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * TILE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  const int bz = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * T::BQ;
  const int Nk = a.Nk, tiles = (Nk + T::BKT - 1) / T::BKT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      dg_tma::bar_init(&full[s], 1);
      dg_tma::bar_init(&empty[s], T::THREADS / 32);
    }
    dg_tma::bar_init(qbar, 1);
    dg_tma::fence_barrier_init();
  }
  __syncthreads();

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * warp + g;  // rows r0 and r0 + 8
  const uint8_t* Qw = Qs + wg * 64 * 128;
  const float scale = a.scale;

  // The producer is lane 0 of warp 0, between its own steps: the Q tile
  // once, then the ring's items in order, K tiles (pass 1), then K and V
  // tiles (pass 2), each into its stage once every warp has released
  // the item before it there.  The warp waits for its lane 0 before it
  // goes on (wgmma takes the whole warpgroup).
  const int total = 3 * tiles;
  int loaded = 0;
  auto refill = [&](int upto) {
    if (tid < 32) {
      if (tid == 0)
        for (; loaded < upto && loaded < total; ++loaded) {
          const int s = loaded % ST;
          dg_tma::wait(&empty[s], ((loaded / ST) & 1) ^ 1);
          dg_tma::arrive_expect_tx(&full[s], TILE);
          const int j = loaded - tiles;  // pass 2's items: K, V a tile
          const bool v = j >= 0 && (j & 1);
          const int kt = j < 0 ? loaded : j >> 1;
          for (int blk = 0; blk < DB; ++blk)
            load_rows(ring + s * TILE + blk * 64 * 128, v ? &mv : &mk,
                      &full[s], v ? a.vh : a.kh, 64 * blk, 64 * kt, hh, bz);
        }
      __syncwarp();
    }
  };
  if (tid == 0) {
    dg_tma::arrive_expect_tx(qbar, T::QBYTES);
    for (int blk = 0; blk < DB; ++blk)
      load_rows(Qs + blk * T::BQ * 128, &mq, qbar, a.qh, 64 * blk, q0, hh,
                bz);
  }
  refill(ST);
  dg_tma::wait(qbar, 0);

  // pass 1: m, l of rows r0 (half 0) and r0 + 8 (half 1), over the
  // earlier form's key tiles of SUB keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int it = 0;
#pragma unroll 1
  for (int kt = 0; kt < tiles; ++kt, ++it) {
    const int s = it % ST;
    refill(it + ST);
    dg_tma::wait(&full[s], (it / ST) & 1);
    float sc[32];
    tile_scores<D, 64, T::DEPTH1>(sc, Qw, ring + s * TILE, 0);
    dg_tma::arrive_warp(&empty[s]);
#pragma unroll
    for (int u = 0; u < 64 / SUB; ++u) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = u * SUB / 8; j < (u + 1) * SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = 64 * kt + 8 * j + 2 * t + (e & 1) < Nk
                              ? __fmul_rn(sc[4 * j + e], scale)
                              : -INFINITY;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half],
                         __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half],
                         __shfl_xor_sync(0xffffffffu, mx[half], 2));
        mx[half] = fmaxf(m[half], mx[half]);  // the new running max
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = u * SUB / 8; j < (u + 1) * SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (sc[4 * j + e] > -INFINITY)
            sum[e >> 1] += expf(__fsub_rn(sc[4 * j + e], mx[e >> 1]));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
        if (mx[half] == -INFINITY) continue;  // no key of the row yet
        l[half] = (m[half] == -INFINITY
                       ? 0.f
                       : l[half] * expf(m[half] - mx[half])) +
                  sum[half];
        m[half] = mx[half];
      }
    }
  }
  if (a.ms != nullptr && t == 0) {
    const long long base = ((long long)bz * gridDim.y + hh) * a.Nq;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (r0 + 8 * half < a.Nq) {
        a.ms[base + r0 + 8 * half] = m[half];
        a.ls[base + r0 + 8 * half] = l[half];
      }
  }
  unsigned long long rkey[2] = {0ull, 0ull};
  if constexpr (DROPOUT)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      rkey[half] = dg_attn::row_key(*a.seed, bz, hh, r0 + 8 * half);

  // pass 2, SUB keys at a time: o[4 J + 2 h + c] is row r0 + 8 h, column
  // 8 J + 2 t + c
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  dg_wgmma::hold(o);
#pragma unroll 1
  for (int kt = 0; kt < tiles; ++kt, it += 2) {
    const int sk = it % ST, sv = (it + 1) % ST;
    refill(it + ST);
    dg_tma::wait(&full[sk], (it / ST) & 1);
    dg_tma::wait(&full[sv], ((it + 1) / ST) & 1);
    const uint8_t* Kt = ring + sk * TILE;
    const uint8_t* Vt = ring + sv * TILE;
#pragma unroll 1
    for (int u = 0; u < 64 / SUB; ++u) {
      uint32_t pa[SUB / 16][4];  // bf16 P: the A operand of each k16 step
      {
        float sc[SUB / 2];
        tile_scores<D, SUB, T::DEPTH2>(sc, Qw, Kt, u * SUB);
#pragma unroll
        for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 64 * kt + u * SUB + 8 * j + 2 * t + (e & 1);
            float p = col < Nk ? dg_attn_bf16::prob(sc[4 * j + e], scale,
                                                    m[e >> 1], l[e >> 1])
                               : 0.f;
            if constexpr (DROPOUT)
              p = dg_attn::keep(rkey[e >> 1], col, a.thresh)
                      ? __fmul_rn(p, a.inv)
                      : 0.f;
            sc[4 * j + e] = p;
          }
#pragma unroll
        for (int ks = 0; ks < SUB / 16; ++ks) {
          pa[ks][0] = dg_wgmma::pack(sc[8 * ks], sc[8 * ks + 1]);
          pa[ks][1] = dg_wgmma::pack(sc[8 * ks + 2], sc[8 * ks + 3]);
          pa[ks][2] = dg_wgmma::pack(sc[8 * ks + 4], sc[8 * ks + 5]);
          pa[ks][3] = dg_wgmma::pack(sc[8 * ks + 6], sc[8 * ks + 7]);
        }
      }
      // P V into o; it runs while the next sub-tile is scored, whose
      // wait also waits for it (the next P may then overwrite pa)
      start_pv<D>(o, pa, Vt, u * SUB);
    }
    dg_wgmma::wait<0>();  // V's stage is read to the end
    dg_tma::arrive_warp(&empty[sk]);
    dg_tma::arrive_warp(&empty[sv]);
  }

  dg_wgmma::hold(o);
  bf16* ob = a.o + bz * a.ob + hh * a.oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= a.Nq) continue;
    bf16* orow = ob + r * a.on + 2 * t;
#pragma unroll
    for (int J = 0; J < D / 8; ++J)
      *reinterpret_cast<uint32_t*>(orow + 8 * J) =
          dg_wgmma::pack(o[4 * J + 2 * half], o[4 * J + 2 * half + 1]);
  }
}

// The map of a (B, H, N, D) bf16 tensor with element strides (sb, sh, sn)
// and unit stride along D, a box of 64 columns and `rows` rows; its dims
// ordered by stride (hfirst: h before the rows, the heads of a (B, N, h *
// d) projection).  Returns false if cuTensorMapEncodeTiled refuses it.
bool encode_heads(CUtensorMap* map, const void* base, int B, int H, int N,
                  int D, long long sb, long long sh, long long sn, int rows,
                  int* hfirst) {
  if (H == 1) sh = sn * N;  // a size-1 dim's stride is free
  if (B == 1) sb = sh * H > sn * N ? sh * H : sn * N;
  *hfirst = sh < sn;
  uint64_t dims[4] = {(uint64_t)D, 0, 0, (uint64_t)B};
  uint64_t strides[3] = {0, 0, (uint64_t)sb * 2};
  uint32_t box[4] = {64, 0, 0, 1};
  if (*hfirst) {
    dims[1] = H, strides[0] = sh * 2, box[1] = 1;
    dims[2] = N, strides[1] = sn * 2, box[2] = rows;
  } else {
    dims[1] = N, strides[0] = sn * 2, box[1] = rows;
    dims[2] = H, strides[1] = sh * 2, box[2] = 1;
  }
  return dg_tma::encode_bf16(map, base, 4, dims, strides, box);
}

template <int D, bool DROPOUT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Nq, int Nk, const long long* st, Args a,
           cudaStream_t stream) {
  using T = WTile<D>;
  CUtensorMap mq, mk, mv;
  if (!encode_heads(&mq, q, B, H, Nq, D, st[0], st[1], st[2], T::BQ, &a.qh) ||
      !encode_heads(&mk, k, B, H, Nk, D, st[3], st[4], st[5], T::BKT,
                    &a.kh) ||
      !encode_heads(&mv, v, B, H, Nk, D, st[6], st[7], st[8], T::BKT,
                    &a.vh))
    return (int)cudaErrorNotSupported;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_wgmma_kernel<D, DROPOUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nq + T::BQ - 1) / T::BQ, H, B);
  attn_fwd_wgmma_kernel<D, DROPOUT><<<grid, T::THREADS, T::SMEM, stream>>>(
      mq, mk, mv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 14's AMP forms at d = 128 and 256 on wgmma, as
// dg_attention_fwd_bf16 (attention_fwd_bf16.cu; the same arguments and
// checks, the same o, m and l): q (B, H, Nq, D), k and v (B, H, Nk, D), o
// (B, H, Nq, D) bf16 with unit stride along D, strides (host, 12 values)
// the (b, h, row) strides in elements of q, k, v and o; q, k and v 16-byte
// aligned with strides multiples of 8, o's even.  `seed` (one int64 on the
// device) or null (rate 0); ms and ls both null (the evaluation form) or
// (B, H, Nq) f32 contiguous.  Returns the first CUDA error
// (cudaErrorNotSupported: cuTensorMapEncodeTiled refused a tensor map).
extern "C" int dg_attention_fwd_bf16_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int Nq, int Nk, int D,
                                           const long long* strides,
                                           float scale,
                                           const long long* seed,
                                           unsigned thresh, float inv,
                                           float* ms, float* ls,
                                           void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535 ||
      (D != 128 && D != 256) || (ms == nullptr) != (ls == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if ((size_t)p % 16) return (int)cudaErrorMisalignedAddress;
  if ((size_t)o % 4) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8) return (int)cudaErrorMisalignedAddress;
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 2) return (int)cudaErrorMisalignedAddress;
  Args a{Nq, Nk, scale, seed, thresh, inv, ms, ls,
         static_cast<bf16*>(o), strides[9], strides[10], strides[11],
         0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return seed ? launch<128, true>(q, k, v, o, B, H, Nq, Nk, strides, a, st)
                : launch<128, false>(q, k, v, o, B, H, Nq, Nk, strides, a,
                                     st);
  return seed ? launch<256, true>(q, k, v, o, B, H, Nq, Nk, strides, a, st)
              : launch<256, false>(q, k, v, o, B, H, Nq, Nk, strides, a, st);
}
