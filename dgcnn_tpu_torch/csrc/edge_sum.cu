// edge_sum: the f32 sum of `a`'s rows over saved neighbour indices, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::edge_sum_reduce
// (body _edge_sum_kernel), the second half of the HOG moment form
// (dgcnn_tpu/ops/hog.py::_compute_hog_fused, the per-neighbourhood sum of
// the per-point votes):
//
//   out[b, n, c] = sum over t = 0..k-1, in that order, of a[b, idx[b, n, t], c]
//
// Duplicate indices count once each.  The TPU sums through one multi-hot
// matrix product (with a 3-way bf16 split in its exact mode); here each sum
// is a plain f32 sum in neighbour order, the plain version's order, so the
// two give the same bits.
//
// Bound on an H100 SXM: bytes.  At the HOG shape (B=16, N=2048, k=32, Co=18
// votes) idx is 4.2 MB and a and out 2.4 MB each, ~0.003 ms at 3.35 TB/s,
// against 18.9 M adds (~0.0003 ms at 67 TFLOP/s).
//
// Design: one thread an output (b, n, c), consecutive threads on
// consecutive channels of a row, so that a warp reads each neighbour's row
// of `a` as one contiguous run and the row's k indices through the cache.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
    edge_sum_kernel(const int* __restrict__ idx, const float* __restrict__ a,
                    int N, int Co, int k, size_t total,
                    float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const size_t row = e / Co;  // b * N + n
  const int c = (int)(e - row * Co);
  const float* ab = a + (row / N) * N * Co + c;
  const int* ir = idx + row * k;
  float acc = ab[(size_t)ir[0] * Co];
  for (int t = 1; t < k; ++t) acc += ab[(size_t)ir[t] * Co];
  out[e] = acc;
}

}  // namespace

// idx (B, N, k) int32 in [0, N), a (B, N, Co), out (B, N, Co); f32
// otherwise, contiguous, on the device.  Returns the first CUDA error.
extern "C" int dg_edge_sum(const int* idx, const float* a, float* out, int B,
                           int N, int Co, int k, void* stream) {
  if (B < 1 || N < 1 || Co < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * N * Co;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  edge_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(idx, a, N, Co, k,
                                                            total, out);
  return (int)cudaGetLastError();
}
