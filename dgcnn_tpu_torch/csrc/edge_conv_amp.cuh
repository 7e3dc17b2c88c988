// The tiled forms of kernel 1's and kernel 12's AMP v3 and v2 forms and
// exact v2 form (edge_conv_amp.cu says what they compute): the kernel
// template and its launch by list size and output channels a lane.  The
// cloud's instances are compiled in edge_conv_amp.cu, the windows' (kernel
// 12) in edge_conv_amp_banded.cu, so that nvcc builds the two at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "knn_select.cuh"

namespace dg {

// The arguments of a launch of the forms (dg_edge_conv_eval_variant).
struct AmpVarArgs {
  const float *gc, *gq, *sq, *ac, *scale, *bias;
  float* rmin;
  void* out;
  const int* starts;
  int B, N, Cs, Co, k, tile, W;
  float lim, slope;
};

// Kernel 12's tiled forms over the windows (edge_conv_amp_banded.cu): v3
// the AMP v3, else v2 with the payload rounded to bf16 (round: project-
// first) or f32 (select-x; exact: the exact v2 form, f32 out).
cudaError_t launch_amp_banded(const AmpVarArgs& a, bool v3, bool round,
                              bool exact, cudaStream_t st);

}  // namespace dg

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}


// The keyed (v2) and class (v3) selections and the fold of a block's 64
// rows: V3 the class walk, else v2 (the rows' grids in rmin); ROUND: the
// payload (project-first) rounded to bf16, else f32 (select-x, and the
// exact v2 form).  ac holds [a | c] as in the exact route; the candidates
// are the cloud or (BANDED, kernel 12) the query tile's window of W rows
// from starts[r0 / tile]; OUT is bf16 (AMP) or float (exact v2).
template <int KL, int CPL, bool V3, bool ROUND, bool BANDED, typename OUT>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    edge_conv_amp_kernel(const float* __restrict__ gc,
                         const float* __restrict__ gq, int Cs,
                         const float* __restrict__ sq, float* rmin,
                         float lim, const float* __restrict__ ac, int Co,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, float slope, int N,
                         int k, const int* __restrict__ starts, int tile,
                         int W, OUT* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* G = gc + (size_t)b * N * Cs;
  const float* GQ = gq + (size_t)b * N * Cs;
  const float* SQ = sq + (size_t)b * N;
  const int start = BANDED ? starts[r0 / tile] : 0;
  const int end = start + (BANDED ? W : N);
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL, BANDED, V3 ? dg::TS_CLASSES : dg::TS_KEYS>(
      G, Cs, SQ, start, end - start, r0, k, tsm, ls, li, GQ,
      rmin + (size_t)b * N, lim);

  const int row = 2 * Co;
  const float* A = ac + (size_t)b * N * row;
  auto payload = [&](const float* arow, int c) {
    return ROUND ? round_bf16(arow[c]) : arow[c];
  };
#pragma unroll
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    const int i = r0 + dg::TS_WR * warp + rr;
    float mx[CPL], mn[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      mx[u] = -INFINITY;
      mn[u] = INFINITY;
    }
#pragma unroll 1
    for (int t = 0; t < k; ++t) {
      float val = __shfl_sync(0xffffffffu, ls[rr][0], t & 31);
      int pk = __shfl_sync(0xffffffffu, li[rr][0], t & 31);
#pragma unroll
      for (int q = 1; q < KL; ++q) {
        const float vq = __shfl_sync(0xffffffffu, ls[rr][q], t & 31);
        const int pq = __shfl_sync(0xffffffffu, li[rr][q], t & 31);
        if (t >> 5 == q) {
          val = vq;
          pk = pq;
        }
      }
      float sel[CPL];
      if (!V3 || dg::class_count(pk) == 1) {  // v2's member, a singleton
        const float* arow =
            A + (size_t)(V3 ? start + dg::class_low(pk) : pk) * row;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = lane + 32 * u;
          sel[u] = c < Co ? payload(arow, c) : 0.f;
        }
      } else {
        if (val == -INFINITY) continue;  // past the row's last class
        // a tied class: its members are the candidates scoring val
        float sum[CPL];
#pragma unroll
        for (int u = 0; u < CPL; ++u) sum[u] = 0.f;
        int cnt = 0;
        const float* qrow = GQ + (size_t)i * Cs;
        const float qq = SQ[i];
        for (int j0 = start; j0 < end; j0 += 32) {
          const float* grow = G + (size_t)(j0 + lane) * Cs;
          float acc = 0.f;
          for (int c = 0; c < Cs; ++c) acc = fmaf(qrow[c], grow[c], acc);
          const float sc = __fsub_rn(__fsub_rn(__fmul_rn(2.f, acc), qq),
                                     SQ[j0 + lane]);
          unsigned m = __ballot_sync(0xffffffffu, sc == val);
          while (m) {
            const int j = j0 + __ffs(m) - 1;
            m &= m - 1;
            ++cnt;
            const float* arow = A + (size_t)j * row;
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
              const int c = lane + 32 * u;
              if (c < Co) sum[u] = __fadd_rn(sum[u], payload(arow, c));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < CPL; ++u) sel[u] = __fdiv_rn(sum[u], (float)cnt);
      }
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        mx[u] = fmaxf(mx[u], sel[u]);
        mn[u] = fminf(mn[u], sel[u]);
      }
    }
    const float* crow = A + (size_t)i * row + Co;
    OUT* orow = out + ((size_t)b * N + i) * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float sc = scale[c];
        const float sel = __fadd_rn(sc > 0.f ? mx[u] : mn[u], crow[c]);
        const float y = __fadd_rn(__fmul_rn(sel, sc), bias[c]);
        dg::store_out(orow + c, y >= 0.f ? y : __fmul_rn(slope, y));
      }
    }
  }
}

template <int KL, int CPL, bool V3, bool ROUND, bool BANDED, typename OUT>
cudaError_t launch_var(const dg::AmpVarArgs& a, cudaStream_t st) {
  auto kern = edge_conv_amp_kernel<KL, CPL, V3, ROUND, BANDED, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dg::TS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.N / dg::TS_R, a.B), dg::TS_THREADS, dg::TS_SMEM_BYTES,
         st>>>(a.gc, a.gq, a.Cs, a.sq, a.rmin, a.lim, a.ac, a.Co, a.scale,
               a.bias, a.slope, a.N, a.k, a.starts, a.tile, a.W,
               reinterpret_cast<OUT*>(a.out));
  return cudaGetLastError();
}

// The list size from k, the output channels a lane from Co (the cloud and
// the windows alike: kernel 12 at the fusion Net's stages 3 and 4, 64 ->
// 128 and 128 -> 256, as well as conv5's 64).
template <bool V3, bool ROUND, bool BANDED, typename OUT>
cudaError_t launch_var_shape(const dg::AmpVarArgs& a, cudaStream_t st) {
  auto by_co = [&](auto kl) {
    constexpr int KL = decltype(kl)::value;
    if (a.Co <= 64) return launch_var<KL, 2, V3, ROUND, BANDED, OUT>(a, st);
    if (a.Co <= 128) return launch_var<KL, 4, V3, ROUND, BANDED, OUT>(a, st);
    return launch_var<KL, 8, V3, ROUND, BANDED, OUT>(a, st);
  };
  if (a.k <= 32) return by_co(std::integral_constant<int, 1>{});
  return by_co(std::integral_constant<int, 2>{});
}

}  // namespace
