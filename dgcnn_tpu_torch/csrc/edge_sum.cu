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
// is a plain f32 sum in neighbour order from the t = 0 term, the plain
// version's order, so the two give the same bits.
//
// Bound on an H100 SXM: bytes.  At the HOG shape (B=16, N=2048, k=32, Co=18
// votes) idx is 4.2 MB and a and out 2.4 MB each, ~0.003 ms at 3.35 TB/s,
// against 18.9 M adds (~0.0003 ms at 67 TFLOP/s).
//
// Design, two forms decided from the shape before the launch:
//   Co / V <= 32 lanes and k <= ES_KMAX  edge_sum_rows_kernel: a warp owns
//     G = min(4, 32 / P) consecutive rows, P = Co / V lanes a row, V = 2
//     channels a lane (a float2) where Co is even and `a` and `out` are
//     8-byte aligned, else V = 1 (Co = 18: three rows on 9 float2 lanes
//     each, 27 lanes).
//     The warp's G * k indices are one contiguous run of idx: it reads them
//     once, coalesced, into its own slice of shared memory, a row at a
//     stride of KS words, and each lane reads its row's indices from there
//     in t order, four at a time, a broadcast among the row's P lanes (KS is
//     4 mod 8, so the G rows' 16-byte reads fall in distinct banks).  A
//     shuffle of the indices from the lanes that loaded them serves one row
//     an instruction: G rows would cost G shuffles and a select each t.  At
//     the Net's k = 32 (K = 32) the k gathers of a lane are independent and
//     issued ahead, and only the adds chain; any other k takes the K = 0
//     instance, which loops over t.
//   otherwise, or dg_edge_sum_per_output at any shape (the earlier form,
//     the other side of the A/B and of chip_smoke.py's checks)
//     edge_sum_kernel: one thread an output (b, n, c), consecutive threads
//     on consecutive channels of a row, each reading the row's k indices
//     through the cache.
// Both forms sum each output in t order from the t = 0 term: the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

constexpr int ES_THREADS = 256;
constexpr int ES_WARPS = ES_THREADS / 32;
constexpr int ES_GMAX = 4;    // rows a warp at most
constexpr int ES_KMAX = 128;  // the longest list of the rows form

template <int V>
struct Lane;
template <>
struct Lane<1> {
  using T = float;
  static __device__ __forceinline__ float add(float u, float v) {
    return u + v;
  }
};
template <>
struct Lane<2> {
  using T = float2;
  static __device__ __forceinline__ float2 add(float2 u, float2 v) {
    return make_float2(u.x + v.x, u.y + v.y);
  }
};

// A warp's G rows of `rows` = B * N: G * k indices staged, then lane g * P
// + p sums channels V p .. V p + V - 1 of row g.  K > 0: k = K, a multiple
// of 4.
template <int K, int V>
__global__ void __launch_bounds__(ES_THREADS)
    edge_sum_rows_kernel(const int* __restrict__ idx,
                         const float* __restrict__ a, int N, int Co, int k,
                         int G, int KS, size_t rows,
                         float* __restrict__ out) {
  using T = typename Lane<V>::T;
  extern __shared__ __align__(16) int es_lists[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = K > 0 ? K : k;
  const size_t row0 = ((size_t)blockIdx.x * ES_WARPS + warp) * G;
  if (row0 >= rows) return;
  const int nr = rows - row0 < (size_t)G ? (int)(rows - row0) : G;
  int* wl = es_lists + warp * ES_GMAX * KS;
  const int* src = idx + row0 * kk;  // the nr rows' indices, contiguous
  for (int e = lane; e < nr * kk; e += 32) {
    const int r = e / kk;
    wl[r * KS + e - r * kk] = src[e];
  }
  __syncwarp();
  const int P = Co / V;
  const int g = lane / P;
  if (g >= nr) return;
  const int c = (lane - g * P) * V;
  const size_t row = row0 + g;
  const float* ab = a + (row / N) * N * Co + c;
  const int* lr = wl + g * KS;
  auto gather = [&](int j) {
    return *reinterpret_cast<const T*>(ab + (size_t)j * Co);
  };
  T acc;
  if constexpr (K > 0) {
    T v[K];
#pragma unroll
    for (int u = 0; u < K / 4; ++u) {
      const int4 j4 = *reinterpret_cast<const int4*>(lr + 4 * u);
      v[4 * u] = gather(j4.x);
      v[4 * u + 1] = gather(j4.y);
      v[4 * u + 2] = gather(j4.z);
      v[4 * u + 3] = gather(j4.w);
    }
    acc = v[0];
#pragma unroll
    for (int t = 1; t < K; ++t) acc = Lane<V>::add(acc, v[t]);
  } else {
    acc = gather(lr[0]);
    for (int t = 1; t < kk; ++t) acc = Lane<V>::add(acc, gather(lr[t]));
  }
  *reinterpret_cast<T*>(out + row * Co + c) = acc;
}

template <int K, int V>
cudaError_t launch_rows(const int* idx, const float* a, float* out,
                        size_t rows, int N, int Co, int k, cudaStream_t st) {
  const int G = std::min(ES_GMAX, 32 / (Co / V));
  const int KS = (k + 7) / 8 * 8 + 4;
  const size_t warps = (rows + G - 1) / G;
  const unsigned blocks = (unsigned)((warps + ES_WARPS - 1) / ES_WARPS);
  const size_t smem = sizeof(int) * ES_WARPS * ES_GMAX * KS;
  edge_sum_rows_kernel<K, V><<<blocks, ES_THREADS, smem, st>>>(
      idx, a, N, Co, k, G, KS, rows, out);
  return cudaGetLastError();
}

int edge_sum(const int* idx, const float* a, float* out, int B, int N,
             int Co, int k, bool per_output, cudaStream_t st) {
  if (B < 1 || N < 1 || Co < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * N;
  const int V =
      Co % 2 == 0 && (uintptr_t)a % 8 == 0 && (uintptr_t)out % 8 == 0 ? 2
                                                                     : 1;
  if (per_output || Co / V > 32 || k > ES_KMAX) {
    const size_t total = rows * Co;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    edge_sum_kernel<<<blocks, 256, 0, st>>>(idx, a, N, Co, k, total, out);
    return (int)cudaGetLastError();
  }
  if (V == 2)
    return (int)(k == 32 ? launch_rows<32, 2>(idx, a, out, rows, N, Co, k, st)
                         : launch_rows<0, 2>(idx, a, out, rows, N, Co, k, st));
  return (int)(k == 32 ? launch_rows<32, 1>(idx, a, out, rows, N, Co, k, st)
                       : launch_rows<0, 1>(idx, a, out, rows, N, Co, k, st));
}

}  // namespace

// idx (B, N, k) int32 in [0, N), a (B, N, Co), out (B, N, Co); f32
// otherwise, contiguous, on the device.  Returns the first CUDA error.
extern "C" int dg_edge_sum(const int* idx, const float* a, float* out, int B,
                           int N, int Co, int k, void* stream) {
  return edge_sum(idx, a, out, B, N, Co, k, false, (cudaStream_t)stream);
}

// As dg_edge_sum in the earlier form, one thread an output, at any shape.
extern "C" int dg_edge_sum_per_output(const int* idx, const float* a,
                                      float* out, int B, int N, int Co,
                                      int k, void* stream) {
  return edge_sum(idx, a, out, B, N, Co, k, true, (cudaStream_t)stream);
}
