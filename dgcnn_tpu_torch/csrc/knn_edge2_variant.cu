// knn_edge2_variant: kernels 6's and 13's forms other than the exact v1
// on Hopper (sm_90a).
//
// Replaces dgcnn_tpu/ops/pallas_knn.py::fused_knn_edge2 (body
// _knn_edge2_kernel) and pallas_banded.py::banded_knn_edge2 (the same body
// over each query tile's window) in the JAX package's default, the AMP
// mode (_train_exact() false: pallas_knn.py:981-1027, the bf16 output at
// :1096), and in the exact mode under DGCNN_TPU_EXTRACT=v2 (the semseg
// CLI's pin; _extract_version, :225):
//   scores    AMP: _scores(exact=False), bf16x3 for an f32 graph, one
//             product of bf16 values for a bf16 graph.  The tensor-core
//             forms (the tensor flag: the cloud's tiled route, Kp <=
//             TC_MAX_KP, every model's blocks) take bf16 operands, [hi |
//             hi | lo | 0..] against [hi | lo | hi | 0..] (Kp = 3 Cg
//             padded to 16; knn_reduce.cu's launch_amp_operands) or the
//             bf16 graph itself, each tile's scores bf16 mma.sync
//             products with f32 sums (tiled_topk over __nv_bfloat16), the
//             v2 grid knn_reduce.cu's knn_rowmin_tc_kernel, v3's first
//             tile filled by the sorting network; the earlier form (simt,
//             the windows of kernel 13) one fmaf chain over f32 operands
//             ([hi | hi | lo] against [hi | lo | hi], 3 Cg channels;
//             edge_conv_amp.cu's amp_graph_kernel writes them); exact v2:
//             the f32 graph itself.
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
// scores its candidates once more as the tile did (knn_select.cuh's
// lane_score: the fmaf chain, or the tile's mma.sync k16 steps; the
// selection's bits) and adds each member's a1 row to its class's slot of
// the consumer's h1 tile.  The tiled route at k <= 64, C1 <= 64 and C2 <=
// 128 (every model); the earlier form's class walk at k > 32 runs one
// block an SM (VARIANT_BLOCKS), the other instances two.  Other shapes (k > 64, as the
// JAX kernel takes any k), or the oracle's call, take the row-warp route
// (knn_edge2_variant_rowwarp_kernel): knn_select.cuh's row_keys and
// pop_class on a warp's row of scores, whose class members come from the
// ballots of the row's scores (registers, or the shared row above 4096
// points), with no second scoring; the earlier tiled form's neighbours,
// classes and bits (its oracle).
//
// Bound on an H100 SXM: operations, the tensor-core forms' scores at the
// bf16 tensor-core rate (the earlier form's at the f32 CUDA-core rate); at
// the DGCNNSemSeg shapes (B=16, N=4096, k=20) a block's bf16x3
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
// (exact v2).  OP: the score operands' type, float or (the tensor-core
// forms) bf16.
// One block an SM for the earlier form's class walk at two-slot lists (k >
// 32: partseg's k = 40): its consumer needs more than the 128 registers
// that two blocks leave a thread, and spilled 20-32 bytes at that cap
// (PERF.md §7: the spilling form at two blocks an SM measured faster).
// The tensor-core forms run two blocks an SM.
template <int KL, bool V3, typename OP>
constexpr int VARIANT_BLOCKS =
    V3 && KL == 2 && std::is_same_v<OP, float> ? 1 : 2;

// The consumer of the tensor-core forms' v3 class walk as a call of its
// own: its lists pass through the thread's stack frame, so that their
// registers are not held through the consumer beside the class means'
// scoring (two blocks an SM without spills).
template <int KL, typename OUT>
__device__ __noinline__ void consume_classes(
    float* tsm, const int (&li)[dg::TS_WR][KL], const float* A,
    const float* b1b, int C1, const float* w2, int C2, const float* s1,
    const float* t1, const float* s2, const float* t2, float slope, int r0,
    int k, OUT* outb, const ScoreOperands<__nv_bfloat16>& so) {
  e2t_consume<KL, true>(tsm, li, A, b1b, C1, w2, C2, s1, t1, s2, t2, slope,
                        r0, k, outb, so);
}

template <int KL, bool V3, bool BANDED, typename OUT, typename OP>
__global__ void __launch_bounds__(dg::TS_THREADS,
                                  VARIANT_BLOCKS<KL, V3, OP>)
    knn_edge2_variant_kernel(const OP* __restrict__ gc,
                             const OP* __restrict__ gq, int Cs,
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
  const ScoreOperands<OP> so{gc, gq, sq, BANDED ? starts : nullptr, N, Cs,
                             tile, end - start};
  if constexpr (V3 && std::is_same_v<OP, __nv_bfloat16>)
    consume_classes<KL>(tsm, li, a1 + (size_t)b * N * C1,
                        b1 + (size_t)b * N * C1, C1, w2, C2, s1, t1, s2, t2,
                        slope, r0, k, out + (size_t)b * N * C2, so);
  else
    e2t_consume<KL, V3>(tsm, li, a1 + (size_t)b * N * C1,
                        b1 + (size_t)b * N * C1, C1, w2, C2, s1, t1, s2, t2,
                        slope, r0, k, out + (size_t)b * N * C2, so);
}

// The row-warp route's query rows a block: RowBlock's, but 8 warps from
// 48 scores a lane up too (at 16 warps its 128 registers spilled 8 bytes a
// thread there).
template <int NPL>
constexpr int VARIANT_QB = NPL >= 48 ? 8 : dg::RowBlock<NPL>::QB;

// The row-warp route of the same forms (k > TS_LIST, C1 > 64 or C2 > 128,
// or asked for: the oracle of the tiled route), knn_edge2.cu's row-warp
// block in the modes of knn_select.cuh: a warp a query row, its W
// candidates' scores in registers or the shared row (row_scores over gc,
// the query row's operands from gq), then V3 the class walk (pop_class; a
// tied class's a1 rows summed in ascending row order from zero and divided
// by the count, e2t_class_means's operations, through both convs as one
// edge) or v2's keys (row_keys) and k rounds of pop_nearest; each edge's
// h1 row in the warp's row of shared memory, its second conv and the max
// as knn_edge2.cu takes them.  C1, C2 <= E2_MAXC (128).
template <int NPL, bool V3, typename OUT>
__global__ void __launch_bounds__(VARIANT_QB<NPL> * 32, 1)
    knn_edge2_variant_rowwarp_kernel(
        const float* __restrict__ gc, const float* __restrict__ gq, int Cs,
        const float* __restrict__ sq, float lim,
        const float* __restrict__ a1, const float* __restrict__ b1, int C1,
        const float* __restrict__ w2, int C2, const float* __restrict__ s1,
        const float* __restrict__ t1, const float* __restrict__ s2,
        const float* __restrict__ t2, float slope, int N, int k,
        const int* __restrict__ starts, int tile, int W,
        OUT* __restrict__ out) {
  const int QB = dg::block_rows<NPL>(VARIANT_QB<NPL>);
  constexpr int CPL = dg::E2_CPL;
  extern __shared__ float smem[];
  float* sg = smem;                          // graph stage (or shared rows)
  float* ws = sg + dg::select_smem_bytes<NPL>(W, QB) / sizeof(float);  // w2
  float* hb = ws + C1 * dg::e2_ldw(C2);                      // QB h1 rows
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const int start = starts ? starts[blockIdx.x * QB / tile] : 0;
  // row_scores synchronises the block before its first read of shared
  // memory and after its first write, which covers w2 too
  dg::e2_stage_w2(w2, C1, C2, ws);
  dg::RowScores<NPL> s;
  dg::row_scores<NPL>(gc + ((size_t)b * N + start) * Cs, Cs,
                      sq + (size_t)b * N + start, W, i - start, lane, sg, s,
                      gq + ((size_t)b * N + i) * Cs);

  const size_t row = (size_t)b * N + i;
  const dg::E2Centre ctr = dg::e2_centre(b1 + row * C1, s1, t1, C1, lane);
  float sc2[CPL], tc2[CPL], mx[CPL];
#pragma unroll
  for (int v = 0; v < CPL; ++v) {
    const int c = lane + 32 * v;
    sc2[v] = c < C2 ? s2[c] : 0.f;
    tc2[v] = c < C2 ? t2[c] : 0.f;
    mx[v] = -INFINITY;
  }
  const float* A = a1 + ((size_t)b * N + start) * C1;
  float* hrow = hb + warp * C1;
  const int ldw = dg::e2_ldw(C2);
  auto consume = [&]() {  // the edge whose h1 row is in hrow
    __syncwarp();
#pragma unroll
    for (int v = 0; v < CPL; ++v) {
      const int c = lane + 32 * v;
      if (c < C2) {
        const float z = dg::e2_z2(hrow, ws, C1, ldw, c);
        mx[v] = fmaxf(mx[v],
                      dg::e2_lrelu(__fadd_rn(__fmul_rn(z, sc2[v]), tc2[v]),
                                   slope));
      }
    }
    __syncwarp();  // before the next edge overwrites hrow
  };
  if constexpr (V3) {
    for (int r = 0; r < k; ++r) {
      dg::RowMask<NPL> mk;
      int cnt;
      if (dg::pop_class<NPL>(s, lane, mk, cnt) == -INFINITY) break;
      float am[CPL];
#pragma unroll
      for (int u = 0; u < CPL; ++u) am[u] = 0.f;
      dg::class_members<NPL>(mk, [&](int j) {
        const float* arow = A + (size_t)j * C1;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = lane + 32 * u;
          if (c < C1) am[u] = cnt == 1 ? arow[c] : __fadd_rn(am[u], arow[c]);
        }
      });
      if (cnt > 1)
#pragma unroll
        for (int u = 0; u < CPL; ++u) am[u] = __fdiv_rn(am[u], (float)cnt);
      dg::e2_h1_vals(am, ctr, slope, C1, lane, hrow);
      consume();
    }
  } else {
    dg::row_keys<NPL>(s, lim);
    for (int r = 0; r < k; ++r) {
      const int j = dg::pop_nearest<NPL>(s, lane);
      dg::e2_h1_row(A + (size_t)j * C1, ctr, slope, C1, lane, hrow);
      consume();
    }
  }
#pragma unroll
  for (int v = 0; v < CPL; ++v) {
    const int c = lane + 32 * v;
    if (c < C2) dg::store_out(out + row * C2 + c, mx[v]);
  }
}

// The row-warp instance of the form, its bucket picked from W.
template <bool V3, typename OUT>
cudaError_t launch_variant_rowwarp(const float* gc, const float* gq, int Cs,
                                   const float* sq, float lim,
                                   const float* a1, const float* b1,
                                   const float* w2, const float* s1,
                                   const float* t1, const float* s2,
                                   const float* t2, void* out, int B, int N,
                                   int C1, int C2, int k, float slope,
                                   const int* starts, int tile, int W,
                                   cudaStream_t st) {
  return dg::with_npl(W, 0, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const size_t fixed = sizeof(float) * C1 * dg::e2_ldw(C2);
    const int QB = dg::launch_rows<NPL>(VARIANT_QB<NPL>, W, fixed,
                                        sizeof(float) * C1);
    if (QB == 0) return cudaErrorInvalidValue;
    auto kern = knn_edge2_variant_rowwarp_kernel<NPL, V3, OUT>;
    const size_t smem = dg::select_smem_bytes<NPL>(W, QB) + fixed +
                        sizeof(float) * QB * C1;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(N / QB, B), QB * 32, smem, st>>>(
        gc, gq, Cs, sq, lim, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope, N, k,
        starts, tile, W, reinterpret_cast<OUT*>(out));
    return cudaGetLastError();
  });
}

template <int KL, bool V3, bool BANDED, typename OUT, typename OP = float>
cudaError_t launch_variant_kernel(const void* gc, const void* gq, int Cs,
                                  const float* sq, float* rmin, float lim,
                                  const float* a1, const float* b1,
                                  const float* w2, const float* s1,
                                  const float* t1, const float* s2,
                                  const float* t2, void* out, int B, int N,
                                  int C1, int C2, int k, float slope,
                                  const int* starts, int tile, int W,
                                  cudaStream_t st) {
  auto kern = knn_edge2_variant_kernel<KL, V3, BANDED, OUT, OP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)XSMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N / dg::TS_R, B), dg::TS_THREADS, XSMEM_BYTES, st>>>(
      static_cast<const OP*>(gc), static_cast<const OP*>(gq), Cs, sq, rmin, lim, a1, b1, C1, w2, C2, s1, t1, s2, t2, slope,
      N, k, starts, tile, W, reinterpret_cast<OUT*>(out));
  return cudaGetLastError();
}

}  // namespace

// Kernel 6's forms other than the exact v1 (and kernel 13's, with starts):
// the AMP v3 and v2 forms and the exact v2 form.  graph (B, N, Cg) f32, or
// bf16 in AMP (flags bit 0); bit 1: v3 (AMP); bit 2: the exact form (f32
// scores and output); bit 3: the row-warp route at any shape.  a1/b1 (B, N,
// C1), w2 (C1, C2), s1/t1 (C1,), s2/t2 (C2,) f32.  Scratch: gq and gc (AMP
// only: B * N * Cs f32, Cs = Cg for a bf16 graph, when gq is unread, 3 Cg
// for an f32 one); sq and rmin (B * N f32); out (B, N, C2), bf16 (AMP) or
// f32 (exact).  starts null: the candidates are the cloud (tile and W = N);
// else kernel 13's windows: the W rows from starts[r / tile] of a sorted
// cloud.  The tiled route at k <= 64, C1 <= 64 and C2 <= 128, the row-warp
// route otherwise (C1, C2 <= 128).  Bit 4: the tensor-core scores (AMP on
// the cloud's tiled route, Kp = tc_channels(Cg) <= TC_MAX_KP); gq and gc
// then hold B * N * Kp bf16 (gq unread for a bf16 graph, neither for one
// whose Cg is a multiple of 16).  Returns the first CUDA error.
extern "C" int dg_knn_edge2_variant(
    const void* graph, const float* a1, const float* b1, const float* w2,
    const float* s1, const float* t1, const float* s2, const float* t2,
    const int* starts, float* gq, float* gc, float* sq, float* rmin,
    void* out, int B, int N, int Cg, int C1, int C2, int k, int tile, int W,
    float slope, int flags, void* stream) {
  const bool gbf = flags & 1, v3 = flags & 2, exact = flags & 4;
  const bool tensor = flags & 16;
  const int Kp = dg::tc_channels(Cg, gbf);
  const bool rowwarp = (flags & 8) || !dg::e2c::tiled_route(C1, C2, k);
  const bool banded = starts != nullptr;
  if (B < 1 || N % 128 != 0 || (banded ? W : N) > dg::MAX_N || Cg < 1 ||
      C1 < 1 ||
      C1 > dg::E2_MAXC || C2 < 1 || C2 > dg::E2_MAXC || k < 1 || k > W ||
      W % 128 != 0 || W < 128 || W > N ||
      (banded ? tile % 128 != 0 || tile < 128 || tile > W || N % tile != 0
              : W != N) ||
      (exact && (gbf || v3)) ||
      (tensor && (exact || banded || rowwarp || Kp > dg::TC_MAX_KP)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * N;
  using bf16 = __nv_bfloat16;
  if (tensor) {  // the bf16 operands, the graph itself where it is one
    const bf16 *tc, *tq;
    cudaError_t e = dg::launch_tc_operands(
        graph, gbf, rows, Cg, reinterpret_cast<bf16*>(gq),
        reinterpret_cast<bf16*>(gc), sq, &tc, &tq, st);
    if (e != cudaSuccess) return (int)e;
    if (!v3) {
      e = dg::launch_rowmin_tc(tc, tq, Kp, sq, B, N, rmin, st);
      if (e != cudaSuccess) return (int)e;
    }
    const float lim = dg::keys_lim(N);
    auto go = [&](auto kl) {
      constexpr int KL = decltype(kl)::value;
      return v3 ? launch_variant_kernel<KL, true, false, bf16, bf16>(
                      tc, tq, Kp, sq, rmin, lim, a1, b1, w2, s1, t1, s2, t2,
                      out, B, N, C1, C2, k, slope, nullptr, N, N, st)
                : launch_variant_kernel<KL, false, false, bf16, bf16>(
                      tc, tq, Kp, sq, rmin, lim, a1, b1, w2, s1, t1, s2, t2,
                      out, B, N, C1, C2, k, slope, nullptr, N, N, st);
    };
    if (k <= 32) return (int)go(std::integral_constant<int, 1>{});
    return (int)go(std::integral_constant<int, 2>{});
  }
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
  const float lim = dg::keys_lim(W);
  using bf16 = __nv_bfloat16;
  if (rowwarp) {  // one launch: the row's grid comes from its scores
#define DG_E2R(V3, OUT)                                                       \
  launch_variant_rowwarp<V3, OUT>(gcp, gqp, Cs, sq, lim, a1, b1, w2, s1, t1,  \
                                  s2, t2, out, B, N, C1, C2, k, slope,        \
                                  starts, tile, W, st)
    if (exact) return (int)DG_E2R(false, float);
    return (int)(v3 ? DG_E2R(true, bf16) : DG_E2R(false, bf16));
#undef DG_E2R
  }
  if (!v3) {
    e = dg::launch_rowmin(gcp, gqp, Cs, sq, B, N, starts, tile, W, rmin, st);
    if (e != cudaSuccess) return (int)e;
  }
  auto go = [&](auto kl) {
    constexpr int KL = decltype(kl)::value;
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
