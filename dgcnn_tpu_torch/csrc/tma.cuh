// The Tensor Memory Accelerator (TMA) and shared-memory barriers
// (mbarrier) on Hopper (sm_90a), as hand PTX: for conv_pool_wgmma.cu
// (kernel 2's AMP form) and attention_fwd_wgmma.cu (kernel 14's AMP
// forms).
//
// A tensor map (CUtensorMap, 128 bytes) describes a bf16 tensor in device
// memory and the box one copy moves; the host encodes it with
// libcuda's cuTensorMapEncodeTiled, fetched through the runtime's
// cudaGetDriverEntryPoint (so the library links without -lcuda), and
// passes it to the kernel by value as a __grid_constant__ parameter.  One
// thread starts a copy; the hardware writes the box into shared memory
// (with the 128-byte swizzle that wgmma's descriptors read), fills
// elements outside the tensor with zeros, and counts the box's bytes on an
// mbarrier, where the consumers wait for the phase to complete.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dg_tma {

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled (null where libcuda lacks it).
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of a bf16 tensor of `rank` dims (dims[0] innermost, contiguous;
// strides[i] the bytes between steps of dim i + 1, multiples of 16), a
// box of box[i] elements a dim, 128-byte swizzle (box[0] * 2 <= 128).
// Returns false if cuTensorMapEncodeTiled refuses it.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const uint64_t* dims, const uint64_t* strides,
                        const uint32_t* box) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), d, s, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread: the barrier expects `count` arrivals a phase.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any thread uses the barriers (then a block
// barrier).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The producer's arrival, announcing `bytes` that copies will count.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival for the calling warp, once all its lanes are here (the
// barrier counts warps).
__device__ __forceinline__ void arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) arrive(bar);
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// Copies the box at element coordinates c (innermost first) of `map` into
// shared memory at dst (1024-byte aligned), counted on `bar`.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1,
                                        int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace dg_tma
