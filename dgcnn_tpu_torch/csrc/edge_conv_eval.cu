// edge_conv_eval: one whole eval EdgeConv stage on Hopper (sm_90a).
//
// Replaces the TPU kernel dgcnn_tpu/ops/pallas_knn.py::fused_edge_conv_eval
// (body _edge_conv1_kernel), in its exact (f32) mode:
//
//   a = x @ W_nbr, c = x @ W_ctr                      (projections)
//   nbr(i) = the k highest 2<g_i,g_j> - |g_i|^2 - |g_j|^2, self included,
//            lowest index first among equal scores     (kNN over graph)
//   sel = (s > 0 ? max_{j in nbr(i)} a_j : min_{j in nbr(i)} a_j) + c_i
//   out_i = LeakyReLU(sel * s + t)                     (folded BN)
//
// Bound on an H100 SXM: operations.  At the DGCNNCls shapes (B=64, N=1024,
// k=20) the N x N scores are 2*B*N^2*Cg flops a stage, ~35 GFLOP over the
// four stages, against ~0.2 GB of activations in and out: at the f32
// CUDA-core peak (67 TFLOP/s) the scores alone take ~0.5 ms, the bytes at
// 3.35 TB/s ~0.06 ms.
//
// Design, three launches on the caller's stream:
//   1. sqnorm_kernel   |g_j|^2 per point, into scratch.
//   2. project_kernel  [a | c] = x @ [W_nbr | W_ctr] with the register-
//                      blocked GEMM of project.cu, into a (B*N, 2*Co)
//                      scratch.
//   3. the selection, one of two routes decided from the shape before
//      the launch:
//      k <= TS_LIST (64) and Co <= 256 (every model: k = 20, 32, 40)
//        edge_conv_eval_tiled_kernel: the tiled selection of
//        knn_select.cuh (tiled_topk), as kernel 3 runs it.  A block of
//        256 threads owns 64 query rows and streams the cloud in tiles
//        of 128 columns; each tile's scores are a register-blocked
//        product (a staged value feeds four FMAs, where the row-warp
//        form spent one shared load an FMA), and each warp keeps eight
//        rows' running top-k in registers, so no score stays in
//        registers across tiles: no spills at N = 4096, two blocks an
//        SM.  Then each warp walks its rows' lists in list order and
//        folds the members' rows of a (coalesced) into a running
//        max/min over the Co channels.
//      any other shape  select_kernel: the row-warp selection, one warp
//        per query row with its N scores in registers and k rounds of a
//        warp arg-max on (score, -index).
//   Both routes pick the neighbours in torch.topk's order and fold them
//   in that order; max and min are exact, and the epilogue applies the
//   same _rn affine and LeakyReLU, so their outputs are the same bits.
// No idx, no (B, N, k, Co) edge tensor and no score matrix reach device
// memory.  The scores run on the CUDA cores in f32 (the exact mode needs
// f32 products, which rules out TF32).
//
// Kernel 12, dgcnn_tpu/ops/pallas_banded.py::banded_edge_conv_eval (the
// --fast_extract path), is the same stage on a cloud in its PC1-sorted
// order, each query tile scoring only a window of `band` sorted rows from
// starts[tile index].  It takes the same two routes on the same rule:
//   k <= 64 and Co <= 256: edge_conv_eval_tiled_kernel<..., true>, the
//     tiled selection over the window (tiled_topk's columns are the window
//     rows, each block's 64 query rows lying in one query tile), so a
//     block streams band / 128 column tiles instead of N / 128, the tile
//     that holds its own query rows first (knn_select.cuh); the lists hold
//     rows of the sorted cloud and the fold is unchanged.
//   any other shape: select_kernel over the window (it stages the window
//     instead of the cloud; band / 32 scores a lane).
// dg_banded_edge_conv_eval_rowwarp takes the row-warp route at any shape:
// at band = N in the identity order (starts 0) it is the exact stage's
// row-warp route, the oracle that holds the tiled routes to its bits.  At
// the DGCNNPartSeg conv5 shape (B=16, N=2048, Cg=64, band 512) the bound
// falls with the scores, to 2*B*N*band*Cg flops.
//
// The AMP form (dg_edge_conv_eval_amp), the JAX package's default: its
// _edge_conv1_kernel at select_dtype bf16 (pallas_knn.py:830-907), on
// the tiled route only (k <= 64, Co <= 256; the wrapper raises above).
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
// Bound: as the exact stage at CUDA-core rates (the products are f32
// FMAs; bf16 mma would change the sums' order); the v2 stages score the
// cloud twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "knn_select.cuh"

namespace {

using dg::MAX_N;

__global__ void sqnorm_kernel(const float* __restrict__ g, int rows, int C,
                              float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = g + (size_t)r * C;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(p[c], p[c], acc);
  out[r] = acc;
}

// The candidates of query row i are the W rows [start, start + W) of its
// cloud: start = 0 and W = N for the exact stage; for the banded stage
// (kernel 12) the cloud is in its PC1-sorted order, start is the window
// start of i's query tile (starts[(block's first row) / tile]) and W the
// band.  The window holds every row of its tile, so the query row is one of
// the staged rows, and a window-local winner j is row start + j of ac.
template <int NPL>
__global__ void __launch_bounds__(dg::Bucket<NPL>::QB * 32)
    select_kernel(const float* __restrict__ graph, int Cg,
                  const float* __restrict__ sq, const float* __restrict__ ac,
                  int Co, const float* __restrict__ scale,
                  const float* __restrict__ bias, float slope, int N, int k,
                  const int* __restrict__ starts, int tile, int W,
                  float* __restrict__ out) {
  extern __shared__ float sg[];  // W rows x CS: CC channels of the window
  constexpr int CPL = dg::Bucket<NPL>::CPL;
  constexpr int QB = dg::Bucket<NPL>::QB;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const int start = starts ? starts[blockIdx.x * QB / tile] : 0;
  float s[NPL];
  dg::row_scores<NPL>(graph + ((size_t)b * N + start) * Cg, Cg,
                      sq + (size_t)b * N + start, W, i - start, lane, sg, s);

  const int row = 2 * Co;
  const float* A = ac + ((size_t)b * N + start) * row;
  float mx[CPL], mn[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    mx[u] = -INFINITY;
    mn[u] = INFINITY;
  }
  for (int r = 0; r < k; ++r) {
    const float* arow = A + (size_t)dg::pop_nearest<NPL>(s, lane) * row;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = arow[c];
        mx[u] = fmaxf(mx[u], v);
        mn[u] = fminf(mn[u], v);
      }
    }
  }

  const float* crow = ac + ((size_t)b * N + i) * row + Co;
  float* orow = out + ((size_t)b * N + i) * Co;
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < Co) {
      const float sc = scale[c];
      const float sel = __fadd_rn(sc > 0.f ? mx[u] : mn[u], crow[c]);
      const float y = __fadd_rn(__fmul_rn(sel, sc), bias[c]);
      orow[c] = y >= 0.f ? y : __fmul_rn(slope, y);
    }
  }
}

// The tiled route: the block's 64 rows' lists (tiled_topk), then each
// warp its eight rows, CPL output channels a lane (Co <= 32 * CPL).  The
// members' rows of a are folded in list order, which is pop_nearest's
// order, and the epilogue is select_kernel's.  BANDED: the candidates are
// the W rows from starts[r0 / tile] (kernel 12), the query rows' own tile
// streamed first; else the whole cloud.
template <int KL, int CPL, bool BANDED>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    edge_conv_eval_tiled_kernel(const float* __restrict__ graph, int Cg,
                                const float* __restrict__ sq,
                                const float* __restrict__ ac, int Co,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, float slope,
                                int N, int k, const int* __restrict__ starts,
                                int tile, int W, float* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL, BANDED>(graph + (size_t)b * N * Cg, Cg,
                             sq + (size_t)b * N,
                             BANDED ? starts[r0 / tile] : 0, BANDED ? W : N,
                             r0, k, tsm, ls, li);

  const int row = 2 * Co;
  const float* A = ac + (size_t)b * N * row;
#pragma unroll
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    const int i = r0 + dg::TS_WR * warp + rr;
    float mx[CPL], mn[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      mx[u] = -INFINITY;
      mn[u] = INFINITY;
    }
#pragma unroll 4
    for (int t = 0; t < k; ++t) {
      int j = __shfl_sync(0xffffffffu, li[rr][0], t & 31);
#pragma unroll
      for (int q = 1; q < KL; ++q) {
        const int jq = __shfl_sync(0xffffffffu, li[rr][q], t & 31);
        if (t >> 5 == q) j = jq;
      }
      const float* arow = A + (size_t)j * row;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < Co) {
          const float v = arow[c];
          mx[u] = fmaxf(mx[u], v);
          mn[u] = fminf(mn[u], v);
        }
      }
    }
    const float* crow = A + (size_t)i * row + Co;
    float* orow = out + ((size_t)b * N + i) * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float sc = scale[c];
        const float sel = __fadd_rn(sc > 0.f ? mx[u] : mn[u], crow[c]);
        const float y = __fadd_rn(__fmul_rn(sel, sc), bias[c]);
        orow[c] = y >= 0.f ? y : __fmul_rn(slope, y);
      }
    }
  }
}

// The tiled kernel's launch arguments: the stage's tensors and shape, and
// for the banded stage the window starts, the query tile and the band.
struct TiledArgs {
  const float *graph, *scale, *bias;
  const int* starts;
  float *sq, *ac, *out;
  int B, N, Cg, Co, k, tile, W;
  float slope;
};

template <int KL, int CPL, bool BANDED>
cudaError_t launch_tiled(const TiledArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_conv_eval_tiled_kernel<KL, CPL, BANDED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dg::TS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  edge_conv_eval_tiled_kernel<KL, CPL, BANDED>
      <<<dim3(a.N / dg::TS_R, a.B), dg::TS_THREADS, dg::TS_SMEM_BYTES, st>>>(
          a.graph, a.Cg, a.sq, a.ac, a.Co, a.scale, a.bias, a.slope, a.N,
          a.k, a.starts, a.tile, a.W, a.out);
  return cudaGetLastError();
}

template <int KL, bool BANDED>
cudaError_t launch_tiled_co(const TiledArgs& a, cudaStream_t st) {
  if (a.Co <= 64) return launch_tiled<KL, 2, BANDED>(a, st);
  if (a.Co <= 128) return launch_tiled<KL, 4, BANDED>(a, st);
  return launch_tiled<KL, 8, BANDED>(a, st);
}

// The route of the exact and the banded stage, from the shape alone.
bool tiled_route(int Co, int k) { return k <= dg::TS_LIST && Co <= 256; }

// sqnorm, projection and the tiled selection of one stage, its list size
// picked from k.
template <bool BANDED>
cudaError_t launch_tiled_stage(const float* x, const float* wcat, int Cin,
                               const TiledArgs& a, cudaStream_t st) {
  cudaError_t e = dg::launch_sqnorm(a.graph, a.B * a.N, a.Cg, a.sq, st);
  if (e != cudaSuccess) return e;
  e = dg::launch_project(x, a.B * a.N, Cin, wcat, 2 * a.Co, a.ac, st);
  if (e != cudaSuccess) return e;
  if (a.k <= 32) return launch_tiled_co<1, BANDED>(a, st);
  return launch_tiled_co<2, BANDED>(a, st);
}

// sqnorm, projection and selection of one stage whose candidates are the
// windows described above select_kernel.
cudaError_t launch_stage(const float* graph, const float* x,
                         const float* wcat, const float* scale,
                         const float* bias, float* ac, float* sq, float* out,
                         int B, int N, int Cg, int Cin, int Co, int k,
                         float slope, const int* starts, int tile, int W,
                         cudaStream_t st) {
  const int rows = B * N;
  cudaError_t e = dg::launch_sqnorm(graph, rows, Cg, sq, st);
  if (e != cudaSuccess) return e;
  e = dg::launch_project(x, rows, Cin, wcat, 2 * Co, ac, st);
  if (e != cudaSuccess) return e;
  return dg::with_npl(W, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const size_t smem = dg::select_smem_bytes<NPL>(W);
    constexpr int QB = dg::Bucket<NPL>::QB;
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    select_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        graph, Cg, sq, ac, Co, scale, bias, slope, N, k, starts, tile, W,
        out);
    return cudaGetLastError();
  });
}

}  // namespace

namespace dg {

cudaError_t launch_sqnorm(const float* g, int rows, int C, float* out,
                          cudaStream_t st) {
  sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(g, rows, C, out);
  return cudaGetLastError();
}

}  // namespace dg

extern "C" const char* dg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// graph (B, N, Cg), x (B, N, Cin), wcat (Cin, 2*Co) = [W_nbr | W_ctr],
// scale/bias (Co,), scratch ac (B*N, 2*Co) and sq (B*N,), out (B, N, Co);
// all f32, contiguous, on the device.  The tiled route at k <= TS_LIST,
// the row-warp route above.  Returns the first CUDA error.
extern "C" int dg_edge_conv_eval(const float* graph, const float* x,
                                 const float* wcat, const float* scale,
                                 const float* bias, float* ac, float* sq,
                                 float* out, int B, int N, int Cg, int Cin,
                                 int Co, int k, float slope, void* stream) {
  if (B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 ||
      Co > dg::max_co(N) || Cg < 1 || Cin < 1 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!tiled_route(Co, k))
    return (int)launch_stage(graph, x, wcat, scale, bias, ac, sq, out, B, N,
                             Cg, Cin, Co, k, slope, nullptr, N, N, st);
  const TiledArgs a{graph, scale, bias, nullptr, sq, ac, out,
                    B, N, Cg, Co, k, N, N, slope};
  return (int)launch_tiled_stage<false>(x, wcat, Cin, a, st);
}

namespace {

int banded_stage(const float* graph, const float* x, const float* wcat,
                 const float* scale, const float* bias, const int* starts,
                 float* ac, float* sq, float* out, int B, int N, int Cg,
                 int Cin, int Co, int k, int tile, int band, float slope,
                 bool rowwarp, cudaStream_t st) {
  if (B < 1 || N % 128 != 0 || N > MAX_N || band % 128 != 0 || band < 128 ||
      band > N || tile % 128 != 0 || tile < 128 || tile > band ||
      N % tile != 0 || Co < 1 || Co > dg::max_co(band) || Cg < 1 ||
      Cin < 1 || k < 1 || k > band)
    return (int)cudaErrorInvalidValue;
  if (rowwarp || !tiled_route(Co, k))
    return (int)launch_stage(graph, x, wcat, scale, bias, ac, sq, out, B, N,
                             Cg, Cin, Co, k, slope, starts, tile, band, st);
  const TiledArgs a{graph, scale, bias, starts, sq, ac, out,
                    B, N, Cg, Co, k, tile, band, slope};
  return (int)launch_tiled_stage<true>(x, wcat, Cin, a, st);
}

}  // namespace

// Kernel 12, banded_edge_conv_eval: the same stage on a cloud in its
// PC1-sorted order, the candidates of each query tile of `tile` rows the
// `band` rows from starts[tile index] (the sort, the window starts and the
// un-sort are the caller's).  starts (N / tile,) int32 on the device; the
// other arguments as above.  The tiled route at k <= TS_LIST, the row-warp
// route above.  Returns the first CUDA error.
extern "C" int dg_banded_edge_conv_eval(
    const float* graph, const float* x, const float* wcat,
    const float* scale, const float* bias, const int* starts, float* ac,
    float* sq, float* out, int B, int N, int Cg, int Cin, int Co, int k,
    int tile, int band, float slope, void* stream) {
  return banded_stage(graph, x, wcat, scale, bias, starts, ac, sq, out, B, N,
                      Cg, Cin, Co, k, tile, band, slope, false,
                      (cudaStream_t)stream);
}

// As dg_banded_edge_conv_eval on the row-warp route at any shape.
extern "C" int dg_banded_edge_conv_eval_rowwarp(
    const float* graph, const float* x, const float* wcat,
    const float* scale, const float* bias, const int* starts, float* ac,
    float* sq, float* out, int B, int N, int Cg, int Cin, int Co, int k,
    int tile, int band, float slope, void* stream) {
  return banded_stage(graph, x, wcat, scale, bias, starts, ac, sq, out, B, N,
                      Cg, Cin, Co, k, tile, band, slope, true,
                      (cudaStream_t)stream);
}

// ---------------------------------------------------------------- AMP
namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// The v2 grid: each row's least AMP score (TS_MIN).
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    amp_rowmin_kernel(const float* __restrict__ gc,
                      const float* __restrict__ gq, int Cs,
                      const float* __restrict__ sq, int N,
                      float* __restrict__ rmin) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  float ls[dg::TS_WR][1];
  int li[dg::TS_WR][1];
  dg::tiled_topk<1, false, dg::TS_MIN>(
      gc + (size_t)b * N * Cs, Cs, sq + (size_t)b * N, 0, N, r0, 1, tsm, ls,
      li, gq + (size_t)b * N * Cs, rmin + (size_t)b * N);
}

// The AMP selection and fold of a block's 64 rows: V3 the class walk,
// else v2 (the rows' grids in rmin); ROUND: the payload (project-first)
// rounded to bf16, else the f32 projection (select-x).  ac holds [a | c]
// as in the exact route.
template <int KL, int CPL, bool V3, bool ROUND>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    edge_conv_amp_kernel(const float* __restrict__ gc,
                         const float* __restrict__ gq, int Cs,
                         const float* __restrict__ sq, float* rmin,
                         float lim, const float* __restrict__ ac, int Co,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, float slope, int N,
                         int k, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* G = gc + (size_t)b * N * Cs;
  const float* GQ = gq + (size_t)b * N * Cs;
  const float* SQ = sq + (size_t)b * N;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  dg::tiled_topk<KL, false, V3 ? dg::TS_CLASSES : dg::TS_KEYS>(
      G, Cs, SQ, 0, N, r0, k, tsm, ls, li, GQ, rmin + (size_t)b * N, lim);

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
      if (!V3 || pk >> 16 == 1) {  // one row: v2's member, a v3 singleton
        const float* arow = A + (size_t)(V3 ? pk & 0xffff : pk) * row;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = lane + 32 * u;
          sel[u] = c < Co ? payload(arow, c) : 0.f;
        }
      } else {
        if (val == -INFINITY) continue;  // past the row's last class
        // a tied class: its members are the columns scoring val
        float sum[CPL];
#pragma unroll
        for (int u = 0; u < CPL; ++u) sum[u] = 0.f;
        int cnt = 0;
        const float* qrow = GQ + (size_t)i * Cs;
        const float qq = SQ[i];
        for (int j0 = 0; j0 < N; j0 += 32) {
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
    __nv_bfloat16* orow = out + ((size_t)b * N + i) * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float sc = scale[c];
        const float sel = __fadd_rn(sc > 0.f ? mx[u] : mn[u], crow[c]);
        const float y = __fadd_rn(__fmul_rn(sel, sc), bias[c]);
        orow[c] = __float2bfloat16_rn(y >= 0.f ? y : __fmul_rn(slope, y));
      }
    }
  }
}

struct AmpArgs {
  const float *gc, *gq, *sq, *ac, *scale, *bias;
  float* rmin;
  __nv_bfloat16* out;
  int B, N, Cs, Co, k;
  float lim, slope;
};

template <int KL, int CPL, bool V3, bool ROUND>
cudaError_t launch_amp(const AmpArgs& a, cudaStream_t st) {
  auto kern = edge_conv_amp_kernel<KL, CPL, V3, ROUND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dg::TS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.N / dg::TS_R, a.B), dg::TS_THREADS, dg::TS_SMEM_BYTES,
         st>>>(a.gc, a.gq, a.Cs, a.sq, a.rmin, a.lim, a.ac, a.Co, a.scale,
               a.bias, a.slope, a.N, a.k, a.out);
  return cudaGetLastError();
}

template <int KL, bool V3, bool ROUND>
cudaError_t launch_amp_co(const AmpArgs& a, cudaStream_t st) {
  if (a.Co <= 64) return launch_amp<KL, 2, V3, ROUND>(a, st);
  if (a.Co <= 128) return launch_amp<KL, 4, V3, ROUND>(a, st);
  return launch_amp<KL, 8, V3, ROUND>(a, st);
}

template <bool V3, bool ROUND>
cudaError_t launch_amp_kl(const AmpArgs& a, cudaStream_t st) {
  if (a.k <= 32) return launch_amp_co<1, V3, ROUND>(a, st);
  return launch_amp_co<2, V3, ROUND>(a, st);
}

}  // namespace

// Kernel 1's AMP form.  graph (B, N, Cg) and x (B, N, Cin), each f32 or
// bf16 (flags bit 0: graph bf16, bit 1: x bf16); wcat (Cin, 2 Co) f32 =
// [W_nbr | W_ctr] as the stage projects with them (rounded to bf16 where
// the plan says); scale/bias (Co,) f32; flags bit 2: select-x, bit 3: v3
// (select-x with v3 is not taken).  Scratch: gq and gc (B * N * Cs f32,
// Cs = Cg for a bf16 graph, when gq may be gc, 3 Cg for an f32 one), xf
// (B * N * Cin f32, unread for an f32 x), sq and rmin (B * N f32), ac (B *
// N * 2 Co f32); out (B, N, Co) bf16.  N a multiple of 128, N <= 4096, Co
// <= 256, k <= 64.  Returns the first CUDA error.
extern "C" int dg_edge_conv_eval_amp(
    const void* graph, const void* x, const float* wcat, const float* scale,
    const float* bias, float* gq, float* gc, float* xf, float* sq,
    float* rmin, float* ac, void* out, int B, int N, int Cg, int Cin, int Co,
    int k, float slope, int flags, void* stream) {
  const bool gbf = flags & 1, xbf = flags & 2, sx = flags & 4, v3 = flags & 8;
  if (B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 || Co > 256 || Cg < 1 ||
      Cin < 1 || k < 1 || k > N || k > dg::TS_LIST || (sx && v3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * N;
  const int Cs = gbf ? Cg : 3 * Cg;
  const size_t gn = (size_t)rows * Cg;
  if (gbf)
    amp_graph_kernel<true><<<(gn + 255) / 256, 256, 0, st>>>(graph, rows, Cg,
                                                             gc, gc);
  else
    amp_graph_kernel<false><<<(gn + 255) / 256, 256, 0, st>>>(graph, rows,
                                                              Cg, gq, gc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = dg::launch_sqnorm(gbf ? gc : reinterpret_cast<const float*>(graph),
                        rows, Cg, sq, st);
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
  const float* gqp = gbf ? gc : gq;
  const int bits = 32 - __builtin_clz((unsigned)(N - 1) | 1u);
  const AmpArgs a{gc, gqp, sq, ac, scale, bias, rmin,
                  reinterpret_cast<__nv_bfloat16*>(out), B, N, Cs, Co, k,
                  (float)((1u << (31 - bits)) - 1u), slope};
  if (v3) return (int)launch_amp_kl<true, true>(a, st);
  e = cudaFuncSetAttribute(amp_rowmin_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dg::TS_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  amp_rowmin_kernel<<<dim3(N / dg::TS_R, B), dg::TS_THREADS,
                      dg::TS_SMEM_BYTES, st>>>(gc, gqp, Cs, sq, N, rmin);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (sx) return (int)launch_amp_kl<false, false>(a, st);
  return (int)launch_amp_kl<false, true>(a, st);
}
