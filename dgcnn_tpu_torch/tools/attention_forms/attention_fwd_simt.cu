// The earlier form of csrc/attention_fwd.cu at every head dim: both
// products FFMA loops on the CUDA cores (csrc/attention_fwd_simt.cuh, the
// form that the library still runs at d = 512).  Not built into the
// library: tools/attention_ab.py --kernel fwd times it against the
// tensor-core form (PERF.md, Findings).  Same C entries and arguments as
// csrc/attention_fwd.cu.
#include <cuda_runtime.h>

#include "../../csrc/attention_fwd_simt.cuh"

namespace {

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
      return (int)dg_simt::launch_simt<128, DROPOUT, LSE>(
          q, k, v, o, B, H, Nq, Nk, strides, scale, seed, thresh, inv, lse,
          st);
    case 256:
      return (int)dg_simt::launch_simt<256, DROPOUT, LSE>(
          q, k, v, o, B, H, Nq, Nk, strides, scale, seed, thresh, inv, lse,
          st);
    case 512:
      return (int)dg_simt::launch_simt<512, DROPOUT, LSE>(
          q, k, v, o, B, H, Nq, Nk, strides, scale, seed, thresh, inv, lse,
          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dg_attention_fwd(const float* q, const float* k,
                                const float* v, float* o, int B, int H,
                                int Nq, int Nk, int D,
                                const long long* strides, float scale,
                                void* stream) {
  return launch_d<false, false>(q, k, v, o, B, H, Nq, Nk, D, strides, scale,
                                nullptr, 0u, 1.f, nullptr,
                                (cudaStream_t)stream);
}

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
