// attention_mask: the dropout keep mask of the attention kernels,
// materialized, in f32 on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_attention.py::dropout_mask,
// the test oracle of the attention's dropout: mask[b, h, i, j] is 1 where
// the forward (attention_fwd.cu) and the backward (attention_bwd.cu) keep
// the probability (b, h, i, j) under `seed`, else 0, from the stream of
// attention.cuh.
//
// Bound on an H100 SXM: bytes, the B*h*Nq*Nk f32 mask written once
// (67 MB at (2, 2, 2048, 2048), ~0.02 ms at 3.35 TB/s), against one 64-bit
// mix a value.  Design: a block a row (b, h, i), its key computed once a
// thread, the row's Nk values written by consecutive threads.
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

using namespace dg_attn;

__global__ void __launch_bounds__(THREADS)
    mask_kernel(float* __restrict__ mask, int Nk, const long long* seed,
                unsigned thresh) {
  const int i = blockIdx.x, hh = blockIdx.y, bz = blockIdx.z;
  const unsigned long long key = row_key(*seed, bz, hh, i);
  float* row = mask + (((long long)bz * gridDim.y + hh) * gridDim.x + i) * Nk;
  for (int j = threadIdx.x; j < Nk; j += THREADS)
    row[j] = keep(key, j, thresh) ? 1.f : 0.f;
}

}  // namespace

// mask (B, H, Nq, Nk) f32 contiguous on the device, seed one int64 on the
// device.  Returns the first CUDA error.
extern "C" int dg_attention_mask(float* mask, int B, int H, int Nq, int Nk,
                                 const long long* seed, unsigned thresh,
                                 void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  mask_kernel<<<dim3(Nq, H, B), THREADS, 0, (cudaStream_t)stream>>>(
      mask, Nk, seed, thresh);
  return cudaGetLastError();
}
