// edge_conv_amp: kernel 1's and kernel 12's forms other than the exact
// v1 on Hopper (sm_90a): the AMP v3 and v2 forms and the exact v2 form.
//
// Replaces dgcnn_tpu/ops/pallas_knn.py::fused_edge_conv_eval (body
// _edge_conv1_kernel) and pallas_banded.py::banded_edge_conv_eval (the same
// body over each query tile's window) in the JAX package's default, the
// AMP mode, and in the exact mode under DGCNN_TPU_EXTRACT=v2 (the semseg
// CLI's pin; _extract_version, pallas_knn.py:225): the exact scores' keys
// (TS_MIN + TS_KEYS over the f32 graph), the f32 payload and output.
//
// The AMP form, the JAX package's default: its _edge_conv1_kernel at
// select_dtype bf16 (pallas_knn.py:830-907), at any k <= N (the JAX kernel
// has no k cap).
// The stage input is f32 (the cloud) or bf16 (an AMP stage's output), and
// the output bf16.
//   scores    _scores(exact=False): bf16 inputs give one product of bf16
//             values (exact products, f32 sums); f32 inputs split into
//             bf16 hi and lo parts and the inner product is hi.hi + hi.lo
//             + lo.hi.  amp_graph_kernel writes the operands of one chain
//             that gives it (knn_select.cuh's modes: [hi | hi | lo]
//             against [hi | lo | hi], 3 Cg channels), or the bf16 graph
//             as f32.  The squared norms are of the f32 values.
//   payload   select_x_plan (:244): 3->64 and 64->64 project-first with
//             v3, 64->128 project-first with v2, 128->256 select-x with
//             v2.  Project-first selects a = x @ W_nbr rounded to bf16,
//             W rounded to bf16 where x is bf16 (:868-879); the wrapper
//             rounds W.  Select-x selects x's bf16 rows and projects each
//             with the f32 W_nbr (:893): a selection commutes with the
//             projection, so the kernel projects each point once (f32, not
//             rounded) and selects those rows.  The centre term c = x @
//             W_ctr is f32 (W_ctr rounded where x is bf16).
//   v2        (_extract_loop_v2, _pack_keys :87-148) a TS_MIN pass of the
//             tiled selection writes each row's least score; the TS_KEYS
//             pass streams the scores again, each quantized to its row's
//             grid, q = max(rint(s * scale), -lim), which is exact in f32
//             (|q| < 2^24 for N >= 128): the list order (q desc, index
//             asc) is the packed keys' order.  The fold is the exact
//             route's over the k members.
//   v3        (_extract_loop_v3 :151-196) the TS_CLASSES pass lists each
//             row's k largest distinct scores with their member counts
//             and lowest members.  A class of one member is that member's
//             row; a tied class (duplicate points, or equal f32 scores) is
//             the mean of its members' rows, summed in ascending column
//             order from zero and divided by the count: the warp scores
//             its row against the cloud again, with the tiled product's
//             fmaf chain (the same bits), to find the members.  Slots
//             past the row's last class are skipped (the walk consumes
//             that class again, which max and min ignore).
//   epilogue  the f32 affine and LeakyReLU of the exact route, rounded to
//             bf16 (to nearest even) on the store.
// Routes, from k before the launch: at k <= TS_LIST (every model's k) the
// tiled selection (edge_conv_amp_kernel, above: v2 a TS_MIN pass, then
// TS_KEYS); above it, or asked for (the oracle of the tiled route), the
// row-warp selection in the same modes (edge_conv_amp_rowwarp_kernel:
// knn_select.cuh's row_keys and pop_class on a warp's row of scores, one
// scoring pass, no tied-class rescan), the same neighbours and the same
// bits.
// Bound: as the exact stage at CUDA-core rates (the products are f32
// FMAs; bf16 mma would change the sums' order); the tiled v2 stages score
// the cloud twice.
#include "edge_conv_amp.cuh"

namespace {

using dg::MAX_N;

// The score operands of the AMP stage: a bf16 graph as f32 into gc (gq is
// gc), or an f32 graph's [hi | hi | lo] into gq and [hi | lo | hi] into gc
// (3 Cg channels a row).
template <bool BF16>
__global__ void amp_graph_kernel(const void* __restrict__ graph, int rows,
                                 int Cg, float* __restrict__ gq,
                                 float* __restrict__ gc) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * Cg) return;
  if constexpr (BF16) {
    gc[e] = __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(graph)[e]);
  } else {
    const float v = reinterpret_cast<const float*>(graph)[e];
    const float h = round_bf16(v);
    const float l = round_bf16(__fsub_rn(v, h));
    const size_t r = e / Cg, c = e - r * Cg;
    const size_t o = r * 3 * Cg + c;
    gq[o] = h;
    gq[o + Cg] = h;
    gq[o + 2 * Cg] = l;
    gc[o] = h;
    gc[o + Cg] = l;
    gc[o + 2 * Cg] = h;
  }
}

__global__ void upcast_kernel(const __nv_bfloat16* __restrict__ x, size_t n,
                              float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = __bfloat162float(x[e]);
}

// The v2 grid: each row's least score over its candidates (TS_MIN): the
// cloud, or (BANDED) the window of W rows from starts[r0 / tile].
template <bool BANDED>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    amp_rowmin_kernel(const float* __restrict__ gc,
                      const float* __restrict__ gq, int Cs,
                      const float* __restrict__ sq, int N,
                      const int* __restrict__ starts, int tile, int W,
                      float* __restrict__ rmin) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  float ls[dg::TS_WR][1];
  int li[dg::TS_WR][1];
  dg::tiled_topk<1, BANDED, dg::TS_MIN>(
      gc + (size_t)b * N * Cs, Cs, sq + (size_t)b * N,
      BANDED ? starts[r0 / tile] : 0, BANDED ? W : N, r0, 1, tsm, ls, li,
      gq + (size_t)b * N * Cs, rmin + (size_t)b * N);
}

// The row-warp route of the same forms (k > TS_LIST, or asked for: the
// oracle of the tiled route at k <= TS_LIST): a warp a query row i, its W
// candidates' scores in registers or, above REG_MAX_N candidates or Co =
// 128 at W > 2048, in the shared row (row_scores over gc, the query row's
// operands from gq: the tiled route's bits), then V3 the class walk
// (pop_class: a singleton's row, a tied class's mean summed in ascending
// column order from zero and divided by the count) or v2's keys (row_keys,
// the row's least score taken from its scores) and k rounds of
// pop_nearest; the fold and the epilogue of edge_conv_amp_kernel.  Co <=
// 32 * CPL (Bucket: 256, 128 for the buckets above W = 2048, where Co
// above takes the shared row).
template <int NPL, bool V3, bool ROUND, typename OUT>
__global__ void __launch_bounds__(dg::RowBlock<NPL>::QB * 32, 1)
    edge_conv_amp_rowwarp_kernel(const float* __restrict__ gc,
                                 const float* __restrict__ gq, int Cs,
                                 const float* __restrict__ sq, float lim,
                                 const float* __restrict__ ac, int Co,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias, float slope,
                                 int N, int k, const int* __restrict__ starts,
                                 int tile, int W, OUT* __restrict__ out) {
  extern __shared__ float sg[];  // W rows x CS: CC channels of the window
  constexpr int CPL = dg::Bucket<NPL>::CPL;
  const int QB = dg::block_rows<NPL>(dg::RowBlock<NPL>::QB);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const int start = starts ? starts[blockIdx.x * QB / tile] : 0;
  dg::RowScores<NPL> s;
  dg::row_scores<NPL>(gc + ((size_t)b * N + start) * Cs, Cs,
                      sq + (size_t)b * N + start, W, i - start, lane, sg, s,
                      gq + ((size_t)b * N + i) * Cs);

  const int row = 2 * Co;
  const float* A = ac + ((size_t)b * N + start) * row;
  auto payload = [&](const float* arow, int c) {
    return ROUND ? round_bf16(arow[c]) : arow[c];
  };
  float mx[CPL], mn[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    mx[u] = -INFINITY;
    mn[u] = INFINITY;
  }
  auto fold = [&](const float (&sel)[CPL]) {
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      mx[u] = fmaxf(mx[u], sel[u]);
      mn[u] = fminf(mn[u], sel[u]);
    }
  };
  if constexpr (V3) {
    for (int r = 0; r < k; ++r) {
      dg::RowMask<NPL> mk;
      int cnt;
      if (dg::pop_class<NPL>(s, lane, mk, cnt) == -INFINITY) break;
      float sel[CPL];
#pragma unroll
      for (int u = 0; u < CPL; ++u) sel[u] = 0.f;
      dg::class_members<NPL>(mk, [&](int j) {
        const float* arow = A + (size_t)j * row;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = lane + 32 * u;
          if (c < Co)
            sel[u] = cnt == 1 ? payload(arow, c)
                              : __fadd_rn(sel[u], payload(arow, c));
        }
      });
      if (cnt > 1)
#pragma unroll
        for (int u = 0; u < CPL; ++u) sel[u] = __fdiv_rn(sel[u], (float)cnt);
      fold(sel);
    }
  } else {
    dg::row_keys<NPL>(s, lim);
    for (int r = 0; r < k; ++r) {
      const float* arow = A + (size_t)dg::pop_nearest<NPL>(s, lane) * row;
      float sel[CPL];
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        sel[u] = c < Co ? payload(arow, c) : 0.f;
      }
      fold(sel);
    }
  }
  const float* crow = ac + ((size_t)b * N + i) * row + Co;
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

// The row-warp instance of the form, its bucket picked from W.
template <bool V3, bool ROUND, typename OUT>
cudaError_t launch_var_rowwarp(const dg::AmpVarArgs& a, cudaStream_t st) {
  return dg::with_npl(a.W, a.Co, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const int QB = dg::launch_rows<NPL>(dg::RowBlock<NPL>::QB, a.W);
    auto kern = edge_conv_amp_rowwarp_kernel<NPL, V3, ROUND, OUT>;
    const size_t smem = dg::select_smem_bytes<NPL>(a.W, QB);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.N / QB, a.B), QB * 32, smem, st>>>(
        a.gc, a.gq, a.Cs, a.sq, a.lim, a.ac, a.Co, a.scale, a.bias, a.slope,
        a.N, a.k, a.starts, a.tile, a.W, reinterpret_cast<OUT*>(a.out));
    return cudaGetLastError();
  });
}

template <bool BANDED>
cudaError_t launch_rowmin_kernel(const float* gc, const float* gq, int Cs,
                                 const float* sq, int B, int N,
                                 const int* starts, int tile, int W,
                                 float* rmin, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      amp_rowmin_kernel<BANDED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dg::TS_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  amp_rowmin_kernel<BANDED>
      <<<dim3(N / dg::TS_R, B), dg::TS_THREADS, dg::TS_SMEM_BYTES, st>>>(
          gc, gq, Cs, sq, N, starts, tile, W, rmin);
  return cudaGetLastError();
}

}  // namespace

namespace dg {

cudaError_t launch_amp_graph(const void* graph, bool bf16, int rows, int Cg,
                             float* gq, float* gc, cudaStream_t st) {
  const size_t gn = (size_t)rows * Cg;
  if (bf16)
    amp_graph_kernel<true><<<(gn + 255) / 256, 256, 0, st>>>(graph, rows, Cg,
                                                             gc, gc);
  else
    amp_graph_kernel<false><<<(gn + 255) / 256, 256, 0, st>>>(graph, rows,
                                                              Cg, gq, gc);
  return cudaGetLastError();
}

cudaError_t launch_rowmin(const float* gc, const float* gq, int Cs,
                          const float* sq, int B, int N, const int* starts,
                          int tile, int W, float* rmin, cudaStream_t st) {
  if (starts)
    return launch_rowmin_kernel<true>(gc, gq, Cs, sq, B, N, starts, tile, W,
                                      rmin, st);
  return launch_rowmin_kernel<false>(gc, gq, Cs, sq, B, N, nullptr, N, N,
                                     rmin, st);
}

}  // namespace dg

// Kernel 1's forms other than the exact v1 (and kernel 12's, with starts):
// the AMP v3 and v2 forms and the exact v2 form.  graph (B, N, Cg) and x
// (B, N, Cin), each f32 or bf16 in AMP (flags bit 0: graph bf16, bit 1: x
// bf16), f32 in the exact form (bit 4); wcat (Cin, 2 Co) f32 = [W_nbr |
// W_ctr] as the stage projects with them (rounded to bf16 where the plan
// says); scale/bias (Co,) f32; bit 2: select-x (AMP v2), bit 3: v3
// (AMP).  Scratch: gq and gc (AMP only: B * N * Cs f32, Cs = Cg for
// a bf16 graph, when gq is unread, 3 Cg for an f32 one), xf (B * N * Cin
// f32, a bf16 x only); sq and rmin (B * N f32), ac (B * N * 2 Co f32);
// out (B, N, Co), bf16 (AMP) or f32 (exact).  starts null: the candidates
// are the cloud (tile and W = N); else kernel 12's windows: the W rows
// from starts[r / tile] of a sorted cloud.  N a multiple of 128, N (the
// cloud; banded: W, the window, over any N) <= MAX_N (32768), k <= W,
// Co <= 256.  The tiled route at k <=
// TS_LIST, the row-warp route above or with bit 5 (its register buckets,
// or the shared row: knn_select.cuh's with_npl).  Returns the first CUDA
// error.
extern "C" int dg_edge_conv_eval_variant(
    const void* graph, const void* x, const float* wcat, const float* scale,
    const float* bias, float* gq, float* gc, float* xf, float* sq,
    float* rmin, float* ac, void* out, const int* starts, int B, int N,
    int Cg, int Cin, int Co, int k, int tile, int W, float slope, int flags,
    void* stream) {
  const bool gbf = flags & 1, xbf = flags & 2, sx = flags & 4, v3 = flags & 8;
  const bool exact = flags & 16, banded = starts != nullptr;
  const bool rowwarp = (flags & 32) || k > dg::TS_LIST;
  if (B < 1 || N % 128 != 0 || (banded ? W : N) > MAX_N || Co < 1 ||
      Co > dg::MAX_CO || Cg < 1 || Cin < 1 || k < 1 || k > W ||
      W % 128 != 0 || W < 128 || W > N ||
      (banded ? tile % 128 != 0 || tile < 128 || tile > W || N % tile != 0
              : W != N) ||
      (sx && v3) || (exact && (gbf || xbf || sx || v3)))
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
  const float* xp = reinterpret_cast<const float*>(x);
  if (xbf) {
    const size_t xn = (size_t)rows * Cin;
    upcast_kernel<<<(xn + 255) / 256, 256, 0, st>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), xn, xf);
    xp = xf;
  }
  e = dg::launch_project(xp, rows, Cin, wcat, 2 * Co, ac, st);
  if (e != cudaSuccess) return (int)e;
  const dg::AmpVarArgs a{gcp,    gqp, sq, ac, scale, bias, rmin,
                         out,    starts, B, N, Cs, Co, k,
                         tile,   W,   dg::keys_lim(W), slope};
  using bf16 = __nv_bfloat16;
  if (rowwarp) {  // one launch: the row's grid comes from its scores
    if (v3) return (int)launch_var_rowwarp<true, true, bf16>(a, st);
    if (exact) return (int)launch_var_rowwarp<false, false, float>(a, st);
    if (sx) return (int)launch_var_rowwarp<false, false, bf16>(a, st);
    return (int)launch_var_rowwarp<false, true, bf16>(a, st);
  }
  if (v3)
    return (int)(banded ? dg::launch_amp_banded(a, true, true, false, st)
                        : launch_var_shape<true, true, false, bf16>(a, st));
  e = dg::launch_rowmin(gcp, gqp, Cs, sq, B, N, starts, tile, W, rmin, st);
  if (e != cudaSuccess) return (int)e;
  if (banded) return (int)dg::launch_amp_banded(a, false, !sx && !exact,
                                                 exact, st);
  if (exact) return (int)launch_var_shape<false, false, false, float>(a, st);
  if (sx) return (int)launch_var_shape<false, false, false, bf16>(a, st);
  return (int)launch_var_shape<false, true, false, bf16>(a, st);
}
