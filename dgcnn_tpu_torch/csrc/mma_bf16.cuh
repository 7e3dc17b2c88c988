// bf16 matrix products on Hopper's tensor cores through mma.sync
// m16n8k16, for attention_fwd_bf16.cu (kernel 14's AMP form).
//
// A bf16 x bf16 product is exact in f32 (8 significant bits each), so an
// MMA's products are exact; its sum into the f32 accumulator is not
// rounded to nearest (the tensor core cuts its internal sum), so callers
// keep the chain of MMAs into one accumulator short and add the chains in
// f32 (mma_tf32.cuh's rule).
//
// Operands are rows of bf16 in shared memory, each row padded by 8 bf16
// (16 bytes): with a row stride of W + 8 (W a multiple of 64), the eight
// 16-byte rows one ldmatrix phase reads fall in eight distinct bank
// quads, so every ldmatrix below is conflict-free.
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4), each register two
// bf16 with the lower index in its low half: A (16 x 16, row) a[0] = (g,
// 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..), a[3] = (g + 8,
// 2t + 8..); B (16 x 8, col) b[0] = (k 2t..2t+1, n g), b[1] = (k 2t + 8..,
// n g); C (16 x 8, f32) c[0], c[1] = (g, 2t), (g, 2t + 1), c[2], c[3] =
// (g + 8, 2t), (g + 8, 2t + 1).  One ldmatrix .x4 reads four 8 x 8
// matrices, lane 8 i + r giving the address of row r of matrix i; without
// .trans lane l receives (row l / 4, columns 2 (l % 4)..) of each, with
// .trans (rows 2 (l % 4).., column l / 4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dg_bf16 {

// One 16-byte copy (8 bf16); both addresses 16-byte aligned; zeros when
// !in.
__device__ __forceinline__ void copy16(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a b over 16 k (bf16 operands, f32 accumulator).
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace dg_bf16
