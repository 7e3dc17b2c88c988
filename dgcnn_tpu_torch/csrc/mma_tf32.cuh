// f32 matrix products on Hopper's tensor cores in three TF32 terms
// (3xTF32), for attention_bwd.cu (kernel 15).
//
// Each f32 operand a splits into hi = tf32(a) and lo = tf32(a - hi), both
// rounded to nearest with ties away from zero (as cvt.rna.tf32.f32 rounds;
// split() below), and a product sums lo*hi, hi*lo and then
// hi*hi into one f32 accumulator through mma.sync m16n8k8.  A TF32 value
// keeps 11 significant bits, so hi * hi, hi * lo and lo * hi are exact
// in f32 and only lo * lo (2^-22 of |a b|) and the rounding of lo are
// dropped.  The tensor core's own sum is not rounded to nearest: it cuts
// toward zero, so a long chain of MMAs into one accumulator drifts by up
// to an ulp an MMA.  Callers keep chains short (a fresh accumulator a
// tile, added to the running sum in f32).
//
// Operands are rows of f32 in shared memory, 16 bytes a cp.async, in a
// swizzled layout: the 4-float chunk cc of row r of a tile whose rows hold
// W floats (W a multiple of 32) lies at chunk cc ^ swz(r) of its 32-float
// group, swz(r) the bit reversal of r mod 8 (0 4 2 6 1 5 3 7).  Every
// read below touches 32 different banks (128-bit reads: 8 bank quads a
// quarter warp), and so does a float2 store of an accumulator's (row g,
// columns 2t, 2t + 1).  No padding serves the reads along rows and across
// them at once: a row stride of D + 4 floats serves the first, D + 8 the
// second.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row)
// a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4);
// B (8 x 8, col) b0 = (t, g), b1 = (t + 4, g); C (16 x 8) c0, c1 = (g, 2t),
// (g, 2t + 1), c2, c3 = (g + 8, 2t), (g + 8, 2t + 1).  Where both
// operands are read along their rows (the contraction runs along the
// rows), a product of 16 columns takes them as two k-steps whose slots t
// and t + 4 are columns 4t and 4t + 1, then 4t + 2 and 4t + 3: one float4
// a row and lane.  The sum over k does not depend on the order of k.
#pragma once

#include <cuda_runtime.h>

#include "attention.cuh"

namespace dg_mma {

// the swizzle of row r: the bit reversal of r mod 8
__device__ __forceinline__ int swz(int r) {
  return ((r & 1) << 2) | (r & 2) | ((r >> 2) & 1);
}

// Offset of column c in a row whose swizzle is f.
__device__ __forceinline__ int col(int c, int f) {
  return (c & ~31) | ((((c >> 2) & 7) ^ f) << 2) | (c & 3);
}

// Offset of element (r, c) of a swizzled tile whose rows hold W floats.
template <int W>
__device__ __forceinline__ int at(int r, int c) {
  static_assert(W % 32 == 0, "a swizzled row holds whole 32-float groups");
  return r * W + col(c, swz(r));
}

// Starts the copy of rows [r0, r0 + rows) of a (nrows, D) matrix with row
// stride `stride` into the swizzled tile `dst` (W = D); rows past nrows
// are zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int rows,
                                          int nrows) {
  for (int e = threadIdx.x; e < rows * (D / 4); e += dg_attn::THREADS) {
    const int r = e / (D / 4), c = (e - r * (D / 4)) * 4;
    const bool in = r0 + r < nrows;
    dg_attn::copy16(dst + at<D>(r, c), in ? src + (r0 + r) * stride + c : src,
                    in);
  }
}

struct FragA {
  unsigned hi[4], lo[4];
};
struct FragB {
  unsigned hi[2], lo[2];
};

// hi and lo of x as MMA operands.  The tensor core reads the top 19 bits
// of a .tf32 register (sign, exponent, 10 mantissa bits) and ignores the
// low 13, so adding half an ulp of TF32 (2^12) to the bits of a finite f32
// hands it the value rounded to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds it: two integer operations where cvt runs at a
// fraction of their rate.  x - hi is exact in f32.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  const float rest = x - __uint_as_float(hi & 0xffffe000u);
  lo = __float_as_uint(rest) + 0x1000u;
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A[m][k] = M[m0 + m][k0 + k] (m0, k0 multiples of 8): M read along its
// rows.
template <int W>
__device__ __forceinline__ FragA load_a_rows(const float* M, int m0, int k0) {
  const int g = lane_g(), t = lane_t(), f = swz(g);
  const float* r0 = M + (m0 + g) * W;
  const float* r1 = r0 + 8 * W;
  FragA a;
  split(r0[col(k0 + t, f)], a.hi[0], a.lo[0]);
  split(r1[col(k0 + t, f)], a.hi[1], a.lo[1]);
  split(r0[col(k0 + t + 4, f)], a.hi[2], a.lo[2]);
  split(r1[col(k0 + t + 4, f)], a.hi[3], a.lo[3]);
  return a;
}

// A[m][k] = M[k0 + k][m0 + m] (m0 a multiple of 16, k0 of 8): M read
// across its rows (A = M^T).
template <int W>
__device__ __forceinline__ FragA load_a_cols(const float* M, int m0, int k0) {
  const int g = lane_g(), t = lane_t();
  const float* r0 = M + (k0 + t) * W;
  const float* r1 = r0 + 4 * W;
  const int f0 = swz(t), f1 = swz(t + 4);
  FragA a;
  split(r0[col(m0 + g, f0)], a.hi[0], a.lo[0]);
  split(r0[col(m0 + g + 8, f0)], a.hi[1], a.lo[1]);
  split(r1[col(m0 + g, f1)], a.hi[2], a.lo[2]);
  split(r1[col(m0 + g + 8, f1)], a.hi[3], a.lo[3]);
  return a;
}

// B[k][n] = M[k0 + k][n0 + n] (n0, k0 multiples of 8): M read across its
// rows.
template <int W>
__device__ __forceinline__ FragB load_b_cols(const float* M, int n0, int k0) {
  const int g = lane_g(), t = lane_t();
  const float* r0 = M + (k0 + t) * W;
  FragB b;
  split(r0[col(n0 + g, swz(t))], b.hi[0], b.lo[0]);
  split(r0[4 * W + col(n0 + g, swz(t + 4))], b.hi[1], b.lo[1]);
  return b;
}

// The lane's float4 of row `row` (a multiple of 8 plus g) at columns c0 +
// h + 4t .. + 3, c0 a multiple of 32 and h 0 or 16: the lane's slots of
// two k-steps.
template <int W>
__device__ __forceinline__ float4 load_quad(const float* M, int row, int c0,
                                            int h) {
  return dg_attn::ld4(M + row * W + c0 +
                      ((((h >> 2) + lane_t()) ^ swz(lane_g())) << 2));
}

// The A fragments of the two k-steps held in the float4s of rows g and
// g + 8 of an m-tile (step 0: columns 4t, 4t + 1; step 1: 4t + 2, 4t + 3).
__device__ __forceinline__ void split_a_quads(const float4& r0,
                                              const float4& r1, FragA& s0,
                                              FragA& s1) {
  split(r0.x, s0.hi[0], s0.lo[0]);
  split(r1.x, s0.hi[1], s0.lo[1]);
  split(r0.y, s0.hi[2], s0.lo[2]);
  split(r1.y, s0.hi[3], s0.lo[3]);
  split(r0.z, s1.hi[0], s1.lo[0]);
  split(r1.z, s1.hi[1], s1.lo[1]);
  split(r0.w, s1.hi[2], s1.lo[2]);
  split(r1.w, s1.hi[3], s1.lo[3]);
}

// The B fragments of the same two k-steps held in the float4 of row g of
// an n-tile of M, for B = M^T.
__device__ __forceinline__ void split_b_quad(const float4& r, FragB& s0,
                                             FragB& s1) {
  split(r.x, s0.hi[0], s0.lo[0]);
  split(r.y, s0.hi[1], s0.lo[1]);
  split(r.z, s1.hi[0], s1.lo[0]);
  split(r.w, s1.hi[1], s1.lo[1]);
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three terms: lo*hi and hi*lo first, then hi*hi.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// acc += part element by element (rounded to nearest), then part = 0.
template <int M, int N>
__device__ __forceinline__ void add_tiles(float (&acc)[M][N][4],
                                          float (&part)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] += part[i][j][e];
        part[i][j][e] = 0.f;
      }
}

template <int M, int N>
__device__ __forceinline__ void zero_tiles(float (&acc)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

}  // namespace dg_mma
