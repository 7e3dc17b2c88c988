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

// The arguments of a launch of the forms (dg_edge_conv_eval_variant); gc
// and gq are f32, or bf16 (the tensor-core forms), Cs channels a row.
struct AmpVarArgs {
  const void *gc, *gq;
  const float *sq, *ac, *scale, *bias;
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
// Kernel 1's AMP tiled forms over the cloud with the tensor-core scores
// (edge_conv_amp_tc.cu; gc and gq bf16, Cs = Kp): v3, else v2 with the
// payload rounded (round) or select-x; the v2 grid comes first.
cudaError_t launch_amp_tc(const AmpVarArgs& a, bool v3, bool round,
                          cudaStream_t st);

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
// from starts[r0 / tile]; OUT is bf16 (AMP) or float (exact v2); OP the
// score operands' type: float, or bf16 for the tile's scores on the tensor
// cores (and v3's first tile by the sorting network).
template <int KL, int CPL, bool V3, bool ROUND, bool BANDED, typename OUT,
          typename OP>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    edge_conv_amp_kernel(const OP* __restrict__ gc,
                         const OP* __restrict__ gq, int Cs,
                         const float* __restrict__ sq, float* rmin,
                         float lim, const float* __restrict__ ac, int Co,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, float slope, int N,
                         int k, const int* __restrict__ starts, int tile,
                         int W, OUT* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const OP* G = gc + (size_t)b * N * Cs;
  const OP* GQ = gq + (size_t)b * N * Cs;
  const float* SQ = sq + (size_t)b * N;
  const int start = BANDED ? starts[r0 / tile] : 0;
  const int end = start + (BANDED ? W : N);
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL, BANDED, V3 ? dg::TS_CLASSES : dg::TS_KEYS, OP>(
      G, Cs, SQ, start, end - start, r0, k, tsm, ls, li, GQ,
      rmin + (size_t)b * N, lim);

  const int row = 2 * Co;
  const float* A = ac + (size_t)b * N * row;
  auto payload = [&](const float* arow, int c) {
    return ROUND ? round_bf16(arow[c]) : arow[c];
  };
  constexpr bool TC = std::is_same_v<OP, __nv_bfloat16>;
  if constexpr (TC) {
    // the tensor-core forms keep each warp's lists in its rows of the
    // selection's tile buffer (free once tiled_topk returns, a warp's rows
    // its own; scores at 0.., words at 64..) and walk the rows one at a
    // time: no list held in registers through the fold
#pragma unroll
    for (int rr = 0; rr < dg::TS_WR; ++rr) {
      float* srow = tsm + (dg::TS_WR * warp + rr) * dg::TC_LST;
#pragma unroll
      for (int q = 0; q < KL; ++q) {
        srow[32 * q + lane] = ls[rr][q];
        srow[64 + 32 * q + lane] = __int_as_float(li[rr][q]);
      }
    }
    __syncwarp();
  }
#pragma unroll(TC ? 1 : dg::TS_WR)
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    const int i = r0 + dg::TS_WR * warp + rr;
    float mx[CPL], mn[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      mx[u] = -INFINITY;
      mn[u] = INFINITY;
    }
    // slot t of the row's list: its score and word
    auto slot = [&](int t, float& val, int& pk) {
      if constexpr (TC) {
        const float* srow = tsm + (dg::TS_WR * warp + rr) * dg::TC_LST;
        val = srow[t];
        pk = __float_as_int(srow[64 + t]);
      } else {
        val = __shfl_sync(0xffffffffu, ls[rr][0], t & 31);
        pk = __shfl_sync(0xffffffffu, li[rr][0], t & 31);
#pragma unroll
        for (int q = 1; q < KL; ++q) {
          const float vq = __shfl_sync(0xffffffffu, ls[rr][q], t & 31);
          const int pq = __shfl_sync(0xffffffffu, li[rr][q], t & 31);
          if (t >> 5 == q) {
            val = vq;
            pk = pq;
          }
        }
      }
    };
    auto fold = [&](const float (&sel)[CPL]) {
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        mx[u] = fmaxf(mx[u], sel[u]);
        mn[u] = fminf(mn[u], sel[u]);
      }
    };
    // a tied class's mean: its members are the candidates scoring val
    auto tied_mean = [&](float val, float (&sel)[CPL]) {
      float sum[CPL];
#pragma unroll
      for (int u = 0; u < CPL; ++u) sum[u] = 0.f;
      int cnt = 0;
      const OP* qrow = GQ + (size_t)i * Cs;
      const float qq = SQ[i];
      for (int j0 = start; j0 < end; j0 += 32) {
        const float sc =
            dg::lane_score<OP>(qrow, G, Cs, SQ, qq, j0 + lane, lane);
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
    };
    if constexpr (TC) {
      // the tensor-core forms fold in two passes (max and min take any
      // order: the same bits): first v2's members and v3's singletons,
      // four slots' rows in flight, a tied class or a slot past the row's
      // classes folding nothing; then (v3) the tied classes
#pragma unroll 4
      for (int t = 0; t < k; ++t) {
        float val;
        int pk;
        slot(t, val, pk);
        const bool one = !V3 || dg::class_count(pk) == 1;
        const float* arow =
            A + (size_t)(one ? (V3 ? start + dg::class_low(pk) : pk) : i) *
                    row;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = lane + 32 * u;
          if (one && c < Co) {
            const float v = payload(arow, c);
            mx[u] = fmaxf(mx[u], v);
            mn[u] = fminf(mn[u], v);
          }
        }
      }
      if constexpr (V3) {
#pragma unroll 1
        for (int t = 0; t < k; ++t) {
          float val;
          int pk;
          slot(t, val, pk);
          if (dg::class_count(pk) < 2 || val == -INFINITY) continue;
          float sel[CPL];
          tied_mean(val, sel);
          fold(sel);
        }
      }
    } else {
#pragma unroll 1
      for (int t = 0; t < k; ++t) {
        float val;
        int pk;
        slot(t, val, pk);
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
          tied_mean(val, sel);
        }
        fold(sel);
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

template <int KL, int CPL, bool V3, bool ROUND, bool BANDED, typename OUT,
          typename OP>
cudaError_t launch_var(const dg::AmpVarArgs& a, cudaStream_t st) {
  auto kern = edge_conv_amp_kernel<KL, CPL, V3, ROUND, BANDED, OUT, OP>;
  constexpr size_t smem = std::is_same_v<OP, float> ? dg::TS_SMEM_BYTES
                                                    : dg::TC_SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.N / dg::TS_R, a.B), dg::TS_THREADS, smem, st>>>(
      reinterpret_cast<const OP*>(a.gc), reinterpret_cast<const OP*>(a.gq),
      a.Cs, a.sq, a.rmin, a.lim, a.ac, a.Co, a.scale,
               a.bias, a.slope, a.N, a.k, a.starts, a.tile, a.W,
               reinterpret_cast<OUT*>(a.out));
  return cudaGetLastError();
}

// The list size from k, the output channels a lane from Co (the cloud and
// the windows alike: kernel 12 at the fusion Net's stages 3 and 4, 64 ->
// 128 and 128 -> 256, as well as conv5's 64).
template <bool V3, bool ROUND, bool BANDED, typename OUT,
          typename OP = float>
cudaError_t launch_var_shape(const dg::AmpVarArgs& a, cudaStream_t st) {
  auto by_co = [&](auto kl) {
    constexpr int KL = decltype(kl)::value;
    if (a.Co <= 64)
      return launch_var<KL, 2, V3, ROUND, BANDED, OUT, OP>(a, st);
    if (a.Co <= 128)
      return launch_var<KL, 4, V3, ROUND, BANDED, OUT, OP>(a, st);
    return launch_var<KL, 8, V3, ROUND, BANDED, OUT, OP>(a, st);
  };
  if (a.k <= 32) return by_co(std::integral_constant<int, 1>{});
  return by_co(std::integral_constant<int, 2>{});
}

}  // namespace
