// What kernel 14's AMP form (attention_fwd_bf16.cu) and kernel 15's bf16
// form (attention_bwd_bf16.cu) share: the staging of bf16 rows and the
// score product.
//
// The backward rebuilds each probability from the forward's row max m and
// sum l with the forward's instructions, p = exp(s * scale - m) / l, so its
// bf16 rounding of the dropped p (the dv product's operand) sees the
// forward's bits.  That needs the forward's score bits: both kernels take
// every score from `tile_scores` below, one fixed sequence per score (32
// columns of d at a time into a fresh accumulator, two m16n8k16 MMAs, that
// partial added to the score in f32, the column blocks in ascending order),
// whatever tile or warp computes it: an MMA's output is a function of its
// operands' row and column and its accumulator alone.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"
#include "mma_bf16.cuh"

namespace dg_attn_bf16 {

using bf16 = __nv_bfloat16;

// Starts the copy of rows [r0, r0 + rows) of a (nrows, D) bf16 matrix with
// row stride `stride` into `dst` (row stride RS); rows past nrows are
// zeros.  `tid` is the thread's index.
template <int D, int RS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int r0, int rows,
                                          int nrows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < rows * CH; e += dg_attn::THREADS) {
    const int r = e / CH, c = (e - r * CH) * 8;
    const bool in = r0 + r < nrows;
    dg_bf16::copy16(dst + r * RS + c, in ? src + (r0 + r) * stride + c : src,
                    in);
  }
}

// The unscaled products of the warp's 16 rows m0 .. m0 + 15 of As against
// the 8 NT rows kofs .. of Bs over D columns (both bf16, row stride RS):
// s[j] the m16n8 accumulator of B rows kofs + 8 j .. + 7.  Each 32 columns
// of D sum into a fresh accumulator, added to s in f32.  NT is even.
template <int D, int RS, int NT>
__device__ __forceinline__ void tile_scores(const bf16* As, const bf16* Bs,
                                            int m0, int kofs,
                                            float (&s)[NT][4]) {
  static_assert(NT % 2 == 0 && D % 32 == 0, "score tiles");
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
  // A: matrix mi is rows + 8 (mi & 1), columns + 8 (mi >> 1); B: rows +
  // 8 (mi >> 1), columns + 8 (mi & 1)
  const bf16* qa = As + (m0 + rr + 8 * (mi & 1)) * RS + 8 * (mi >> 1);
  const bf16* ka = Bs + (kofs + rr + 8 * (mi >> 1)) * RS + 8 * (mi & 1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 32) {
    float ps[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[j][e] = 0.f;
#pragma unroll
    for (int c = c0; c < c0 + 32; c += 16) {
      unsigned a[4];
      dg_bf16::ldsm_x4(a, qa + c);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b[4];
        dg_bf16::ldsm_x4(b, ka + 8 * j * RS + c);
        dg_bf16::mma(ps[j], a, b[0], b[1]);
        dg_bf16::mma(ps[j + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += ps[j][e];
  }
}

// The probability of one score from its row's max m and sum l, as the
// forward's second pass makes it (the _rn intrinsics keep the scale and
// the subtraction out of an FMA).
__device__ __forceinline__ float prob(float s, float scale, float m,
                                      float l) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(s, scale), m)), l);
}

}  // namespace dg_attn_bf16
