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
//             + lo.hi.  The tensor-core forms (below) take the bf16
//             operands [hi | hi | lo | 0..] against [hi | lo | hi | 0..],
//             3 Cg padded to Kp, a multiple of 16 (knn_reduce.cu's
//             launch_amp_operands), or the bf16 graph itself (Cg padded
//             to Kp where it is not a multiple of 16); the earlier form
//             amp_graph_kernel's f32 operands of one chain that gives it
//             (knn_select.cuh's modes: [hi | hi | lo] against [hi | lo |
//             hi], 3 Cg channels), or the bf16 graph as f32.  The squared
//             norms are of the f32 values.
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
//             its row against the cloud again as the tile did
//             (knn_select.cuh's lane_score: the fmaf chain, or the tile's
//             mma.sync k16 steps; the same bits), to find the members.
//             Slots
//             past the row's last class are skipped (the walk consumes
//             that class again, which max and min ignore).
//   epilogue  the f32 affine and LeakyReLU of the exact route, rounded to
//             bf16 (to nearest even) on the store.
// Routes, from k and the caller's flags before the launch (the Python
// wrapper's amp_route): at k <= TS_LIST (every model's k) the tiled
// selection (edge_conv_amp_kernel, above: v2 a TS_MIN pass, then
// TS_KEYS).  On the cloud, with the tensor flag (Kp <= TC_MAX_KP: every
// model's stages), its AMP forms score on the tensor cores: each 64 x 128
// tile's scores are bf16 mma.sync m16n8k16 products with f32 sums
// (tiled_topk over __nv_bfloat16), the v2 grid is knn_reduce.cu's
// knn_rowmin_tc_kernel over the same operands (the keys' bits), and v3's
// first tile fills each row's class list by the sorting network.  A bf16
// x bf16 product is exact in f32; the sums' order and the tensor core's
// truncating adds differ from the fmaf chain, as the TPU's MXU differs,
// within the AMP contract (ROADMAP B).  Without the flag (simt, the
// windows of kernel 12, the exact v2 form) the earlier form: the fmaf
// chain over f32 operands on the CUDA cores.  Above k = TS_LIST, or asked
// for, the row-warp selection in the same modes
// (edge_conv_amp_rowwarp_kernel: knn_select.cuh's row_keys and pop_class
// on a warp's row of scores, one scoring pass, no tied-class rescan): the
// earlier tiled form's neighbours and bits, its oracle.
// Bound: the tensor-core forms' products at the bf16 tensor-core rate; the
// earlier form's at CUDA-core rates, its tiled v2 stages scoring the cloud
// twice.
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

__global__ void sqnorm_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                                   int rows, int C, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const __nv_bfloat16* p = g + (size_t)r * C;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = __bfloat162float(p[c]);
    acc = fmaf(v, v, acc);
  }
  out[r] = acc;
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
        static_cast<const float*>(a.gc), static_cast<const float*>(a.gq),
        a.Cs, a.sq, a.lim, a.ac, a.Co, a.scale, a.bias, a.slope,
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

cudaError_t launch_tc_operands(const void* graph, bool bf16, int rows,
                               int Cg, __nv_bfloat16* gq, __nv_bfloat16* gc,
                               float* sq, const __nv_bfloat16** tc,
                               const __nv_bfloat16** tq, cudaStream_t st) {
  const int Kp = tc_channels(Cg, bf16);
  *tc = *tq = static_cast<const __nv_bfloat16*>(graph);
  if (!(bf16 && Kp == Cg)) {
    const cudaError_t e =
        launch_amp_operands(graph, bf16, rows, Cg, Kp, gq, gc, st);
    if (e != cudaSuccess) return e;
    *tc = gc;
    *tq = bf16 ? gc : gq;
  }
  if (!bf16)
    return launch_sqnorm(static_cast<const float*>(graph), rows, Cg, sq, st);
  sqnorm_bf16_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(graph), rows, Cg, sq);
  return cudaGetLastError();
}

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
// (AMP); bit 6: the tensor-core scores (AMP on the cloud's tiled route,
// Kp = tc_channels(Cg) <= TC_MAX_KP).  Scratch: gq and gc (AMP only: B * N
// * Cs f32, Cs = Cg for a bf16 graph, when gq is unread, 3 Cg for an f32
// one; with bit 6 B * N * Kp bf16, gq unread for a bf16 graph and neither
// for one whose Cg is a multiple of 16), xf (B * N * Cin f32, a bf16 x
// only); sq and rmin (B * N f32), ac (B * N * 2 Co f32);
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
  const bool tensor = flags & 64;
  const int Kp = dg::tc_channels(Cg, gbf);
  if (B < 1 || N % 128 != 0 || (banded ? W : N) > MAX_N || Co < 1 ||
      Co > dg::MAX_CO || Cg < 1 || Cin < 1 || k < 1 || k > W ||
      W % 128 != 0 || W < 128 || W > N ||
      (banded ? tile % 128 != 0 || tile < 128 || tile > W || N % tile != 0
              : W != N) ||
      (sx && v3) || (exact && (gbf || xbf || sx || v3)) ||
      (tensor && (exact || banded || rowwarp || Kp > dg::TC_MAX_KP)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * N;
  using bf16 = __nv_bfloat16;
  const float* gf = reinterpret_cast<const float*>(graph);
  const void *gcp = gf, *gqp = gf;
  int Cs = Cg;
  cudaError_t e;
  if (tensor) {  // the bf16 operands, the graph itself where it is one
    const bf16 *tc, *tq;
    e = dg::launch_tc_operands(graph, gbf, rows, Cg,
                               reinterpret_cast<bf16*>(gq),
                               reinterpret_cast<bf16*>(gc), sq, &tc, &tq, st);
    gcp = tc;
    gqp = tq;
    Cs = Kp;
  } else {
    if (!exact) {
      e = dg::launch_amp_graph(graph, gbf, rows, Cg, gq, gc, st);
      if (e != cudaSuccess) return (int)e;
      gcp = gc;
      gqp = gbf ? gc : gq;
      Cs = gbf ? Cg : 3 * Cg;
    }
    e = dg::launch_sqnorm(gbf ? gc : gf, rows, Cg, sq, st);
  }
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
  if (tensor) {
    if (!v3) {
      e = dg::launch_rowmin_tc(static_cast<const bf16*>(gcp),
                               static_cast<const bf16*>(gqp), Kp, sq, B, N,
                               rmin, st);
      if (e != cudaSuccess) return (int)e;
    }
    return (int)dg::launch_amp_tc(a, v3, !sx, st);
  }
  if (rowwarp) {  // one launch: the row's grid comes from its scores
    if (v3) return (int)launch_var_rowwarp<true, true, bf16>(a, st);
    if (exact) return (int)launch_var_rowwarp<false, false, float>(a, st);
    if (sx) return (int)launch_var_rowwarp<false, false, bf16>(a, st);
    return (int)launch_var_rowwarp<false, true, bf16>(a, st);
  }
  if (v3)
    return (int)(banded ? dg::launch_amp_banded(a, true, true, false, st)
                        : launch_var_shape<true, true, false, bf16>(a, st));
  e = dg::launch_rowmin(static_cast<const float*>(gcp),
                        static_cast<const float*>(gqp), Cs, sq, B, N, starts,
                        tile, W, rmin, st);
  if (e != cudaSuccess) return (int)e;
  if (banded) return (int)dg::launch_amp_banded(a, false, !sx && !exact,
                                                 exact, st);
  if (exact) return (int)launch_var_shape<false, false, false, float>(a, st);
  if (sx) return (int)launch_var_shape<false, false, false, bf16>(a, st);
  return (int)launch_var_shape<false, true, false, bf16>(a, st);
}
