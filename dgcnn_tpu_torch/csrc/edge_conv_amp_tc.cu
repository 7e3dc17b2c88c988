// edge_conv_amp_tc: kernel 1's AMP tiled forms over the cloud with the
// tile's scores on the tensor cores (replaces, as edge_conv_amp.cu's
// forms do, dgcnn_tpu/ops/pallas_knn.py::fused_edge_conv_eval at
// select_dtype bf16, :830-907; edge_conv_amp.cu says what they compute):
// edge_conv_amp_kernel over bf16 operands, Kp channels a row (v3, v2
// project-first and v2 select-x at every Co), launched from
// dg_edge_conv_eval_variant after the operands and, for v2, the grid.
// Their own file, so that nvcc builds them beside the earlier form's.
//
// dg_knn_class_lists, beside them, writes the v3 selection's class lists
// (tiled_topk's TS_CLASSES over the tensor-core scores, its first tile by
// the sorting network or, asked for, by the insertions of the earlier
// form) and recounts each class: the members lane_score finds, as the
// consumers' rescans find them.  It is the checks' window on the lists:
// the two fills must give the same bits, and every class its count.
#include "edge_conv_amp.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The lists of the block's 64 rows (SORTED: the sorting network's first
// tile) into ls / li (B, N, k), and each slot's recount: the columns whose
// lane_score equals its score (cnt) and the lowest of them (low; -1 for
// none, as the slots past a row's classes).
template <int KL, bool SORTED>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    class_lists_kernel(const bf16* __restrict__ gc,
                       const bf16* __restrict__ gq, int Kp,
                       const float* __restrict__ sq, int N, int k,
                       float* __restrict__ ls_out, int* __restrict__ li_out,
                       int* __restrict__ cnt_out, int* __restrict__ low_out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* G = gc + (size_t)b * N * Kp;
  const bf16* GQ = gq + (size_t)b * N * Kp;
  const float* SQ = sq + (size_t)b * N;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL, false, dg::TS_CLASSES, bf16, SORTED>(
      G, Kp, SQ, 0, N, r0, k, tsm, ls, li, GQ);
#pragma unroll
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    const int i = r0 + dg::TS_WR * warp + rr;
    const bf16* qrow = GQ + (size_t)i * Kp;
    const float qq = SQ[i];
    int cnt[KL], low[KL];
#pragma unroll
    for (int q = 0; q < KL; ++q) {
      cnt[q] = 0;
      low[q] = -1;
    }
    for (int j0 = 0; j0 < N; j0 += 32) {
      const float sc =
          dg::lane_score<bf16>(qrow, G, Kp, SQ, qq, j0 + lane, lane);
#pragma unroll 1
      for (int t = 0; t < k; ++t) {
        float v = __shfl_sync(0xffffffffu, ls[rr][0], t & 31);
#pragma unroll
        for (int q = 1; q < KL; ++q) {
          const float w = __shfl_sync(0xffffffffu, ls[rr][q], t & 31);
          if (t >> 5 == q) v = w;
        }
        const unsigned m = __ballot_sync(0xffffffffu, sc == v);
        if (m && lane == (t & 31)) {
#pragma unroll
          for (int q = 0; q < KL; ++q)
            if (t >> 5 == q) {
              cnt[q] += __popc(m);
              if (low[q] < 0) low[q] = j0 + __ffs(m) - 1;
            }
        }
      }
    }
    const size_t o = ((size_t)b * N + i) * k;
#pragma unroll
    for (int q = 0; q < KL; ++q) {
      const int t = lane + 32 * q;
      if (t < k) {
        ls_out[o + t] = ls[rr][q];
        li_out[o + t] = li[rr][q];
        cnt_out[o + t] = cnt[q];
        low_out[o + t] = low[q];
      }
    }
  }
}

template <int KL, bool SORTED>
cudaError_t launch_lists(const bf16* gc, const bf16* gq, int Kp,
                         const float* sq, int B, int N, int k, float* ls,
                         int* li, int* cnt, int* low, cudaStream_t st) {
  auto kern = class_lists_kernel<KL, SORTED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dg::TC_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kern<<<dim3(N / dg::TS_R, B), dg::TS_THREADS, dg::TC_SMEM_BYTES, st>>>(
      gc, gq, Kp, sq, N, k, ls, li, cnt, low);
  return cudaGetLastError();
}

}  // namespace

namespace dg {

cudaError_t launch_amp_tc(const AmpVarArgs& a, bool v3, bool round,
                          cudaStream_t st) {
  if (v3) return launch_var_shape<true, true, false, bf16, bf16>(a, st);
  if (round) return launch_var_shape<false, true, false, bf16, bf16>(a, st);
  return launch_var_shape<false, false, false, bf16, bf16>(a, st);
}

}  // namespace dg

// The v3 class lists of graph (B, N, Cg; f32, or bf16 with flags bit 0)
// over its tensor-core scores: ls (B, N, k) f32 the classes' scores (-inf
// past a row's last), li (B, N, k) int32 their words (count << 16 |
// lowest member), cnt and low (B, N, k) int32 each slot's recount and its
// lowest counted column (-1: none).  flags bit 1: the first tile inserted
// column by column (the earlier form's fill) instead of sorted.  Scratch:
// gq and gc (B * N * Kp bf16 each, Kp = tc_channels(Cg); unread for a bf16
// graph of Kp channels), sq (B * N f32).
// N a multiple of 128 and <= MAX_N, 1 <= k <= min(TS_LIST, N).  Returns
// the first CUDA error.
extern "C" int dg_knn_class_lists(const void* graph, void* gq, void* gc,
                                  float* sq, int B, int N, int Cg, int k,
                                  int flags, float* ls, int* li, int* cnt,
                                  int* low, void* stream) {
  const bool gbf = flags & 1, serial = flags & 2;
  const int Kp = dg::tc_channels(Cg, gbf);
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || Cg < 1 || k < 1 ||
      k > dg::TS_LIST || k > N || Kp > dg::TC_MAX_KP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *tc, *tq;
  cudaError_t e = dg::launch_tc_operands(graph, gbf, B * N, Cg,
                                         static_cast<bf16*>(gq),
                                         static_cast<bf16*>(gc), sq, &tc,
                                         &tq, st);
  if (e != cudaSuccess) return (int)e;
  if (k <= 32)
    e = serial ? launch_lists<1, false>(tc, tq, Kp, sq, B, N, k, ls, li, cnt,
                                        low, st)
               : launch_lists<1, true>(tc, tq, Kp, sq, B, N, k, ls, li, cnt,
                                       low, st);
  else
    e = serial ? launch_lists<2, false>(tc, tq, Kp, sq, B, N, k, ls, li, cnt,
                                        low, st)
               : launch_lists<2, true>(tc, tq, Kp, sq, B, N, k, ls, li, cnt,
                                       low, st);
  return (int)e;
}
