// What the attention kernels share: attention_fwd.cu (kernel 14),
// attention_bwd.cu (kernel 15) and attention_mask.cu (kernel 16).
//
// Tiles: a block of 256 threads (16 x 16: ty = tid / 16, tx = tid % 16)
// stages rows of q, k, v (and dO) in shared memory with a row stride of
// D + 4 floats, 16 bytes a cp.async, so that every row of those inputs
// must start 16-byte aligned (the wrappers in ops/attention.py copy an
// input that does not).
//
// The dropout stream.  The keep bit of the probability (b, h, i, j) is a
// pure function of (seed, b, h, i, j): splitmix64's finalizer (mix64)
// chained over the four indices,
//
//   key(i)     = mix64(mix64(mix64(seed + (b+1) G) + (h+1) G) + (i+1) G)
//   draw(i, j) = mix64(key(i) + (j+1) G) >> 32          (32 bits)
//   keep       = draw >= round(rate * 2^32)             P(keep) = 1 - rate
//
// with G = 0x9E3779B97F4A7C15 and every sum and product mod 2^64.  For a
// fixed row, draw(i, .) is splitmix64's stream seeded with key(i).  No
// tiling enters the bits, so the forward, the backward and the mask kernel
// each pick their own tiles, and a sub-block of a mask is the slice of the
// whole.  ops/attention.py::dropout_mask_plain computes the same bits with
// torch int64 operations.  The TPU kernels draw from the TPU core's own
// generator (dgcnn_tpu/ops/pallas_attention.py::_keep_mask): the two
// streams have one distribution, not the same bits.
#pragma once

#include <cuda_runtime.h>

namespace dg_attn {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16

struct Strides {
  long long b, h, n;
};

// One 16-byte copy: both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows [r0, r0 + rows) of a (nrows, D) matrix with row
// stride `stride` into `dst` (row stride D + 4), 16 bytes a copy; rows past
// nrows are zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int rows,
                                          int nrows) {
  for (int e = threadIdx.x; e < rows * (D / 4); e += THREADS) {
    const int r = e / (D / 4), c = (e - r * (D / 4)) * 4;
    const bool in = r0 + r < nrows;
    copy16(dst + r * (D + 4) + c, in ? src + (r0 + r) * stride + c : src, in);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------- dropout

constexpr unsigned long long GAMMA = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// key(i) of the row (b, h, i) under `seed`.
__device__ __forceinline__ unsigned long long row_key(long long seed, int b,
                                                      int h, int i) {
  unsigned long long z =
      mix64((unsigned long long)seed + (unsigned long long)(b + 1) * GAMMA);
  z = mix64(z + (unsigned long long)(h + 1) * GAMMA);
  return mix64(z + (unsigned long long)(i + 1) * GAMMA);
}

// Whether the probability of column j in the row of `key` is kept.
__device__ __forceinline__ bool keep(unsigned long long key, int j,
                                     unsigned thresh) {
  return (unsigned)(mix64(key + (unsigned long long)(j + 1) * GAMMA) >> 32) >=
         thresh;
}

}  // namespace dg_attn
