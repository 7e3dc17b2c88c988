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
//        per query row with its N scores in registers (up to 4096
//        points; above, or at Co > 128 above 2048 points, in
//        knn_select.cuh's shared row) and k rounds of a warp arg-max on
//        (score, -index).
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
// The forms other than the exact v1 (the AMP v3 and v2 forms, and the
// exact v2 form of the semseg CLI's pin), kernel 12's too, are
// edge_conv_amp.cu's.
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
  const int QB = dg::block_rows<NPL>(dg::Bucket<NPL>::QB);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * QB + warp;
  const int start = starts ? starts[blockIdx.x * QB / tile] : 0;
  dg::RowScores<NPL> s;
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
  return dg::with_npl(W, Co, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const int QB = dg::launch_rows<NPL>(dg::Bucket<NPL>::QB, W);
    const size_t smem = dg::select_smem_bytes<NPL>(W, QB);
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

bool& force_srow() {
  static bool on = false;
  return on;
}

unsigned long long& srow_launches() {
  static unsigned long long n = 0;
  return n;
}

cudaError_t launch_sqnorm(const float* g, int rows, int C, float* out,
                          cudaStream_t st) {
  sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(g, rows, C, out);
  return cudaGetLastError();
}

}  // namespace dg

extern "C" const char* dg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// on != 0: every row route of the kNN kernels takes the shared row
// (knn_select.cuh), whatever N and Co are; 0: the register buckets where
// they hold the row.  For the check of the shared row's bits against the
// buckets'; it applies to the launches after it, in every thread.
extern "C" void dg_force_shared_rows(int on) { dg::force_srow() = on != 0; }

// The launches that with_npl (knn_select.cuh) has sent to the shared row
// since the library was loaded; the wrappers count theirs from it.
extern "C" unsigned long long dg_srow_launches() {
  return dg::srow_launches();
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
  if (B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 || Co > dg::MAX_CO ||
      Cg < 1 || Cin < 1 || k < 1 || k > N)
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
  if (B < 1 || N % 128 != 0 || band > MAX_N || band % 128 != 0 ||
      band < 128 || band > N || tile % 128 != 0 || tile < 128 ||
      tile > band || N % tile != 0 || Co < 1 || Co > dg::MAX_CO || Cg < 1 ||
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
