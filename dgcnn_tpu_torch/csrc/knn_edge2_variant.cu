// knn_edge2_variant: kernels 6's and 13's forms other than the exact v1
// on Hopper (sm_90a).
//
// Replaces dgcnn_tpu/ops/pallas_knn.py::fused_knn_edge2 (body
// _knn_edge2_kernel) and pallas_banded.py::banded_knn_edge2 (the same body
// over each query tile's window) in the JAX package's default, the AMP
// mode (_train_exact() false: pallas_knn.py:981-1027, the bf16 output at
// :1096), and in the exact mode under DGCNN_TPU_EXTRACT=v2 (the semseg
// CLI's pin; _extract_version, :225):
//   scores    AMP: _scores(exact=False), bf16x3 for an f32 graph (one
//             chain over [hi | hi | lo] against [hi | lo | hi], 3 Cg
//             channels), one product of bf16 values for a bf16 graph
//             (edge_conv_amp.cu's amp_graph_kernel writes the operands);
//             exact v2: the f32 graph itself.
//   v2        a TS_MIN pass of the tiled selection writes each row's least
//             score over its candidates; the TS_KEYS pass lists the k
//             largest quantized scores (knn_select.cuh), lowest row first
//             among equal ones, the packed keys' order.
//   v3        (AMP at C1 % 128 != 0: every model) TS_CLASSES lists each
//             row's k largest distinct scores with their counts and lowest
//             members; a class is consumed as the mean of its members' a1
//             rows, summed in ascending row order from zero and divided by
//             the count (the one-hot is f32 at :1026: a1 is not rounded),
//             through both convs, then the max; a row with fewer than k
//             classes leaves the rest out of its max (the walk consumes its
//             last class again, which the max ignores).
//   consumer  edge2_consume.cuh's, kernel 6's exact tiled consumer; the
//             output bf16 (AMP, rounded to nearest even from the f32 max)
//             or f32 (exact v2).
// Tied classes (duplicate points) need their members: a row that has one
// scores its candidates once more with the tiled product's chain (the
// selection's bits) and adds each member's a1 row to its class's slot of
// the consumer's h1 tile.  Only the tiled route (k <= 64, C1 <= 64, C2 <=
// 128; the wrapper raises otherwise); the class walk at k > 32 runs one
// block an SM (VARIANT_BLOCKS), the other instances two.
//
// Bound on an H100 SXM: operations.  The scores' products run on the CUDA
// cores in f32 FMAs on bf16 values (bf16 mma would change the sums'
// order); at the DGCNNSemSeg shapes (B=16, N=4096, k=20) a block's bf16x3
// scores are 3 * 2*B*N^2*Cg flops at Cg = 3, one product at Cg = 64, the
// per-edge second conv 2*B*N*k*C1*C2.  The v2 forms score the candidates
// twice; v3 rows with tied classes three times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "edge2_consume.cuh"
#include "knn_select.cuh"

namespace {

using namespace dg::e2c;

// Kernels 6's and 13's forms but the exact v1: the keyed selection (v2:
// the rows' grids in rmin) or the class walk (V3) of tiled_topk over the
// score operands gc / gq (Cs channels; the graph itself in the exact v2
// form), then e2t_consume.  BANDED: the candidates are the W rows from
// starts[r0 / tile]; else the whole cloud.  OUT: bf16 (AMP) or float
// (exact v2).
// One block an SM for the class walk at two-slot lists (k > 32: partseg's
// k = 40): its consumer needs more than the 128 registers that two blocks
// leave a thread, and spilled 20-32 bytes at that cap (PERF.md §7: the
// spilling form at two blocks an SM measured faster).
template <int KL, bool V3>
constexpr int VARIANT_BLOCKS = V3 && KL == 2 ? 1 : 2;

template <int KL, bool V3, bool BANDED, typename OUT>
__global__ void __launch_bounds__(dg::TS_THREADS, VARIANT_BLOCKS<KL, V3>)
    knn_edge2_variant_kernel(const float* __restrict__ gc,
                             const float* __restrict__ gq, int Cs,
                             const float* __restrict__ sq, float* rmin,
                             float lim, const float* __restrict__ a1,
                             const float* __restrict__ b1, int C1,
                             const float* __restrict__ w2, int C2,
                             const float* __restrict__ s1,
                             const float* __restrict__ t1,
                             const float* __restrict__ s2,
                             const float* __restrict__ t2, float slope, int N,
                             int k, const int* __restrict__ starts, int tile,
                             int W, OUT* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
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
  e2t_consume<KL, V3>(tsm, li, a1 + (size_t)b * N * C1,
                      b1 + (size_t)b * N * C1, C1, w2, C2, s1, t1, s2, t2,
                      slope, r0, k, out + (size_t)b * N * C2,
                      ScoreOperands{gc, gq, sq, BANDED ? starts : nullptr, N,
                                    Cs, tile, end - start});
}

template <int KL, bool V3, bool BANDED, typename OUT>
cudaError_t launch_variant_kernel(const float* gc, const float* gq, int Cs,
                                  const float* sq, float* rmin, float lim,
                                  const float* a1, const float* b1,
                                  const float* w2, const float* s1,
                                  const float* t1, const float* s2,
                                  const float* t2, void* out, int B, int N,
                                  int C1, int C2, int k, float slope,
                                  const int* starts, int tile, int W,
                                  cudaStream_t st) {
  auto kern = knn_edge2_variant_kernel<KL, V3, BANDED, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)XSMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N / dg::TS_R, B), dg::TS_THREADS, XSMEM_BYTES, st>>>(
      gc, gq, Cs, sq, rmin, lim, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope,
      N, k, starts, tile, W, reinterpret_cast<OUT*>(out));
  return cudaGetLastError();
}

}  // namespace

// Kernel 6's forms other than the exact v1 (and kernel 13's, with starts):
// the AMP v3 and v2 forms and the exact v2 form, on the tiled route (k <=
// 64, C1 <= 64, C2 <= 128).  graph (B, N, Cg) f32, or bf16 in AMP (flags
// bit 0); bit 1: v3 (AMP); bit 2: the exact form (f32 scores and output).
// a1/b1 (B, N, C1), w2 (C1, C2), s1/t1 (C1,), s2/t2 (C2,) f32.  Scratch
// (AMP only): gq and gc (B * N * Cs f32, Cs = Cg for a bf16 graph, when
// gq is unread, 3 Cg for an f32 one); sq and rmin (B * N f32); out (B, N,
// C2), bf16 (AMP) or f32 (exact).  starts null: the candidates are the
// cloud (tile and W = N); else kernel 13's windows: the W rows from
// starts[r / tile] of a sorted cloud.  Returns the first CUDA error.
extern "C" int dg_knn_edge2_variant(
    const void* graph, const float* a1, const float* b1, const float* w2,
    const float* s1, const float* t1, const float* s2, const float* t2,
    const int* starts, float* gq, float* gc, float* sq, float* rmin,
    void* out, int B, int N, int Cg, int C1, int C2, int k, int tile, int W,
    float slope, int flags, void* stream) {
  const bool gbf = flags & 1, v3 = flags & 2, exact = flags & 4;
  const bool banded = starts != nullptr;
  if (B < 1 || N % 128 != 0 || N > dg::MAX_N || Cg < 1 || C1 < 1 ||
      C1 > XC1 || C2 < 1 || C2 > XC2 || k < 1 || k > W ||
      k > dg::TS_LIST || W % 128 != 0 || W < 128 || W > N ||
      (banded ? tile % 128 != 0 || tile < 128 || tile > W || N % tile != 0
              : W != N) ||
      (exact && (gbf || v3)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * N;
  const float* gf = reinterpret_cast<const float*>(graph);
  const float *gcp = gf, *gqp = gf;
  int Cs = Cg;
  cudaError_t e;
  if (!exact) {
    e = dg::launch_amp_graph(graph, gbf, rows, Cg, gq, gc, st);
    if (e != cudaSuccess) return (int)e;
    gcp = gc;
    gqp = gbf ? gc : gq;
    Cs = gbf ? Cg : 3 * Cg;
  }
  e = dg::launch_sqnorm(gbf ? gc : gf, rows, Cg, sq, st);
  if (e != cudaSuccess) return (int)e;
  if (!v3) {
    e = dg::launch_rowmin(gcp, gqp, Cs, sq, B, N, starts, tile, W, rmin, st);
    if (e != cudaSuccess) return (int)e;
  }
  const float lim = dg::keys_lim(W);
  auto go = [&](auto kl) {
    constexpr int KL = decltype(kl)::value;
    using bf16 = __nv_bfloat16;
#define DG_E2V(V3, BANDED, OUT)                                              \
  launch_variant_kernel<KL, V3, BANDED, OUT>(gcp, gqp, Cs, sq, rmin, lim,    \
                                             a1, b1, w2, s1, t1, s2, t2, out, \
                                             B, N, C1, C2, k, slope, starts,  \
                                             tile, W, st)
    if (exact) return banded ? DG_E2V(false, true, float)
                             : DG_E2V(false, false, float);
    if (v3) return banded ? DG_E2V(true, true, bf16)
                          : DG_E2V(true, false, bf16);
    return banded ? DG_E2V(false, true, bf16) : DG_E2V(false, false, bf16);
#undef DG_E2V
  };
  if (k <= 32) return (int)go(std::integral_constant<int, 1>{});
  return (int)go(std::integral_constant<int, 2>{});
}
