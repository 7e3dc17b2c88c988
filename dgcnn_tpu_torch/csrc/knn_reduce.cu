// knn_reduce / knn_reduce_xw: the forward of one training EdgeConv stage's
// neighbour reductions on Hopper (sm_90a).
//
// Replace the TPU kernels dgcnn_tpu/ops/pallas_knn.py::fused_knn_reduce
// (body _knn_reduce_kernel) and ::fused_knn_reduce_xw (body
// _knn_reduce_xw_kernel), with with_sumsq=True, in their exact (f32) mode:
//
//   nbr(i) = the k highest 2<g_i,g_j> - |g_i|^2 - |g_j|^2, self included,
//            lowest index first among equal scores      (kNN over graph)
//   idx[i, t] = the t-th member of nbr(i)
//   amax_i, amin_i, asum_i, asumsq_i = max, min, sum, sum of squares over
//            t of a[idx[i, t]]                         (per channel)
//
// where knn_reduce takes a (= x @ W_nbr, projected by the caller) and
// knn_reduce_xw takes the raw features xf and w, a = xf @ w.
//
// The v2 form (dg_knn_reduce_v2, dg_knn_reduce_xw_v2: DGCNN_TPU_EXTRACT=v2,
// as the semseg CLI pins it, read by _knn_reduce_kernel at
// pallas_knn.py:386 and _knn_reduce_xw_kernel at :431) picks nbr(i) by the
// packed keys of the same f32 scores (_pack_keys, :87; _extract_loop_v2,
// :123): each score quantized to its row's grid, q = max(rint(s * scale),
// -lim) with scale = -lim / min_j s(i, j), the k largest q, lowest index
// first among equal ones.  A TS_MIN pass of the tiled selection writes
// each row's least score, and the TS_KEYS pass lists the k largest keys
// (knn_select.cuh); the reductions over the list are the v1 form's.  Tiled
// route only: k <= TS_LIST, else the entry returns cudaErrorInvalidValue.
//
// Bound on an H100 SXM: operations.  At the DGCNNCls training shapes
// (B=32, N=1024, k=20, Cg = 3 / 64 / 64 / 128) the scores are 2*B*N^2*Cg
// flops, ~17 GFLOP over the four stages: ~0.26 ms at the f32 CUDA-core
// peak (67 TFLOP/s), against ~0.35 GB of a in and reductions out, ~0.1 ms
// at 3.35 TB/s.  At the DGCNNSemSeg ones (B=32, N=4096, k=20, Cg = 3 /
// 64 / 64) the scores are ~140 GFLOP, ~2.1 ms.
//
// The AMP form (dg_knn_reduce_amp, dg_knn_reduce_xw_amp), the JAX
// package's default in training (_knn_reduce_kernel and
// _knn_reduce_xw_kernel at select_dtype bf16, pallas_knn.py:371-467):
//   scores    _scores(exact=False) of the f32 graph: bf16 hi and lo parts,
//             hi.hi + hi.lo + lo.hi, as kernel 1's AMP form takes them
//             (edge_conv_amp.cu's launch_amp_graph: one chain over [hi |
//             hi | lo] against [hi | lo | hi], 3 Cg channels), less the
//             squared norms of the f32 values.
//   v2        the packed keys of those scores (TS_MIN, then TS_KEYS), as
//             the exact v2 form above.
//   payload   a's rows rounded to bf16 (to nearest even) as they are read
//             (_parts(a, exact=False), :388-389); max, min, the sum and
//             the sum of squares of those values in f32, t ascending, with
//             the exact form's operations.  So amax and amin are values of
//             round_bf16(a): kernel 5's AMP form finds its ties on them.
//   select-x  (kernel 4, :441-452) the TPU kernel selects x's bf16 rows
//             and rounds each projected selection to bf16.  A selection
//             commutes with the projection, so the port rounds x to bf16
//             once (xw_round_kernel), projects the whole cloud with
//             launch_project and rounds each selected row of that product
//             to bf16 as above.  Its backward recomputes the product with
//             the same launch (dg_project on the rounded x) and so finds
//             the bits the forward reduced.
// Tiled route only (k <= TS_LIST), f32 inputs and outputs.
//
// Design, two routes decided from k before the launch:
//   k <= TS_LIST (64; every model: k = 20, 32, 40)  knn_reduce_tiled_kernel:
//     the tiled selection of knn_select.cuh.  A block of 256 threads owns 64
//     query rows and streams the cloud in tiles of 128 columns; each tile's
//     scores are a register-blocked product (4 x 8 a thread, channels
//     staged 32 at a time by cp.async in two buffers), so a staged value
//     feeds four FMAs where the row-warp form spent one shared load an
//     FMA; each warp keeps eight rows' running top-k in registers, filled
//     by sorting the first tile.  No
//     score stays in registers across tiles: no spills at N = 4096, two
//     blocks an SM.
//   k > TS_LIST  knn_reduce_kernel: the row-warp selection (sqnorm, one warp
//     per query row with its N scores in registers, k rounds of warp
//     arg-max).
// Both give the same scores bit for bit (one fmaf chain over the channels,
// 0 ascending, then the same _rn operations) and the same neighbours in
// torch.topk's order.  Each winner's index goes to idx and its row of a is
// read whole (coalesced) into running max/min/sum/sum-of-squares, t
// ascending, with _rn intrinsics so that nothing is contracted into an
// FMA: the two routes' outputs are the same bits.  The rows are read
// exactly, so amax and amin are bit-equal to members' values: the backward
// kernel (edge_reduce_bwd.cu) finds its ties by comparing against them.
// knn_reduce_xw projects the whole cloud once into a scratch a with the
// register-blocked GEMM of project.cu (launch_project) and then runs the
// same selection: for the 128 -> 256 stage that is k = 20 times fewer FMAs
// than projecting each selected raw row as the TPU kernel does.  The
// backward recomputes a with the same launch (dg_project below), which
// sums each element in the same order, so its a and the forward's are the
// same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "knn_select.cuh"

namespace {

using dg::MAX_N;

// The row-warp route (k > TS_LIST): a warp a query row.
template <int NPL>
__global__ void __launch_bounds__(dg::Bucket<NPL>::QB * 32)
    knn_reduce_kernel(const float* __restrict__ graph, int Cg,
                      const float* __restrict__ sq,
                      const float* __restrict__ a, int Co, int N, int k,
                      int* __restrict__ idx, float* __restrict__ amax,
                      float* __restrict__ amin, float* __restrict__ asum,
                      float* __restrict__ asumsq) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  constexpr int CPL = dg::Bucket<NPL>::CPL;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * dg::Bucket<NPL>::QB + warp;
  float s[NPL];
  dg::row_scores<NPL>(graph + (size_t)b * N * Cg, Cg, sq + (size_t)b * N, N,
                      i, lane, sg, s);

  const float* A = a + (size_t)b * N * Co;
  const size_t row = (size_t)b * N + i;
  int* irow = idx + row * k;
  float mx[CPL], mn[CPL], sm[CPL], s2[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    mx[u] = -INFINITY;
    mn[u] = INFINITY;
    sm[u] = 0.f;
    s2[u] = 0.f;
  }
  for (int r = 0; r < k; ++r) {
    const int j = dg::pop_nearest<NPL>(s, lane);
    if (lane == 0) irow[r] = j;
    const float* arow = A + (size_t)j * Co;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const float v = arow[c];
        mx[u] = fmaxf(mx[u], v);
        mn[u] = fminf(mn[u], v);
        sm[u] = __fadd_rn(sm[u], v);
        s2[u] = __fadd_rn(s2[u], __fmul_rn(v, v));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u;
    if (c < Co) {
      const size_t o = row * Co + c;
      amax[o] = mx[u];
      amin[o] = mn[u];
      asum[o] = sm[u];
      asumsq[o] = s2[u];
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The tiled route: the block's 64 rows' lists, then the reductions, a
// warp its eight rows; CPL output channels a lane (Co <= 32 * CPL).  MODE
// TS_TOPK is v1; TS_KEYS v2, on the rows' grids in rmin, its query rows
// from gq.  AMP: the AMP form (TS_KEYS over the AMP score operands, Cg =
// 3 x the graph's channels), a's values rounded to bf16 as they are read.
template <int KL, int CPL, int MODE, bool AMP>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    knn_reduce_tiled_kernel(const float* __restrict__ graph,
                            const float* __restrict__ gq, int Cg,
                            const float* __restrict__ sq,
                            const float* __restrict__ a, int Co, int N, int k,
                            int* __restrict__ idx, float* __restrict__ amax,
                            float* __restrict__ amin, float* __restrict__ asum,
                            float* __restrict__ asumsq, float* rmin,
                            float lim) {
  extern __shared__ __align__(16) float tsm[];
  const int b = blockIdx.y, r0 = blockIdx.x * dg::TS_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ls[dg::TS_WR][KL];
  int li[dg::TS_WR][KL];
  const float* G = graph + (size_t)b * N * Cg;
  dg::tiled_topk<KL, false, MODE>(G, Cg, sq + (size_t)b * N, 0, N, r0, k,
                                  tsm, ls, li, gq + (size_t)b * N * Cg,
                                  MODE == dg::TS_KEYS ? rmin + (size_t)b * N
                                                      : nullptr,
                                  lim);

  const float* A = a + (size_t)b * N * Co;
#pragma unroll
  for (int rr = 0; rr < dg::TS_WR; ++rr) {
    const size_t row = (size_t)b * N + r0 + dg::TS_WR * warp + rr;
    int* irow = idx + row * k;
#pragma unroll
    for (int q = 0; q < KL; ++q)
      if (lane + 32 * q < k) irow[lane + 32 * q] = li[rr][q];
    float mx[CPL], mn[CPL], sm[CPL], s2[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      mx[u] = -INFINITY;
      mn[u] = INFINITY;
      sm[u] = 0.f;
      s2[u] = 0.f;
    }
#pragma unroll 4
    for (int t = 0; t < k; ++t) {
      int j = __shfl_sync(0xffffffffu, li[rr][0], t & 31);
#pragma unroll
      for (int q = 1; q < KL; ++q) {
        const int jq = __shfl_sync(0xffffffffu, li[rr][q], t & 31);
        if (t >> 5 == q) j = jq;
      }
      const float* arow = A + (size_t)j * Co;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < Co) {
          const float v = AMP ? round_bf16(arow[c]) : arow[c];
          mx[u] = fmaxf(mx[u], v);
          mn[u] = fminf(mn[u], v);
          sm[u] = __fadd_rn(sm[u], v);
          s2[u] = __fadd_rn(s2[u], __fmul_rn(v, v));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Co) {
        const size_t o = row * Co + c;
        amax[o] = mx[u];
        amin[o] = mn[u];
        asum[o] = sm[u];
        asumsq[o] = s2[u];
      }
    }
  }
}

// gq: the query rows' operands of TS_KEYS (graph, but for the AMP form);
// Cg: the channels of graph and gq.
struct TiledArgs {
  const float *graph, *gq, *a, *sq;
  int* idx;
  float *amax, *amin, *asum, *asumsq, *rmin;
  int B, N, Cg, Co, k;
};

template <int KL, int CPL, int MODE, bool AMP>
cudaError_t launch_tiled(const TiledArgs& t, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_reduce_tiled_kernel<KL, CPL, MODE, AMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dg::TS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  knn_reduce_tiled_kernel<KL, CPL, MODE, AMP>
      <<<dim3(t.N / dg::TS_R, t.B), dg::TS_THREADS, dg::TS_SMEM_BYTES, st>>>(
          t.graph, t.gq, t.Cg, t.sq, t.a, t.Co, t.N, t.k, t.idx, t.amax,
          t.amin, t.asum, t.asumsq, t.rmin, dg::keys_lim(t.N));
  return cudaGetLastError();
}

template <int KL, int MODE, bool AMP = false>
cudaError_t launch_tiled_co(const TiledArgs& t, cudaStream_t st) {
  if (t.Co <= 64) return launch_tiled<KL, 2, MODE, AMP>(t, st);
  if (t.Co <= 128) return launch_tiled<KL, 4, MODE, AMP>(t, st);
  return launch_tiled<KL, 8, MODE, AMP>(t, st);
}

// sqnorm of the graph, then the selection over a: the tiled route at
// k <= TS_LIST, the row-warp route above.  rmin (B * N scratch) asks for
// the v2 form: the rows' grids first, then the keyed tiled route (k <=
// TS_LIST only).
cudaError_t reduce(const float* graph, const float* a, float* sq, int* idx,
                   float* amax, float* amin, float* asum, float* asumsq,
                   float* rmin, int B, int N, int Cg, int Co, int k,
                   cudaStream_t st) {
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  const TiledArgs t{graph, graph, a,  sq, idx, amax, amin, asum, asumsq,
                    rmin,  B,     N, Cg, Co,  k};
  if (rmin != nullptr) {
    if (k > dg::TS_LIST) return cudaErrorInvalidValue;
    e = dg::launch_rowmin(graph, graph, Cg, sq, B, N, nullptr, N, N, rmin,
                          st);
    if (e != cudaSuccess) return e;
    if (k <= 32) return launch_tiled_co<1, dg::TS_KEYS>(t, st);
    return launch_tiled_co<2, dg::TS_KEYS>(t, st);
  }
  if (k <= 32) return launch_tiled_co<1, dg::TS_TOPK>(t, st);
  if (k <= dg::TS_LIST) return launch_tiled_co<2, dg::TS_TOPK>(t, st);
  return dg::with_npl(N, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const size_t smem = dg::select_smem_bytes<NPL>(N);
    constexpr int QB = dg::Bucket<NPL>::QB;
    cudaError_t err = cudaFuncSetAttribute(
        knn_reduce_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    knn_reduce_kernel<NPL><<<dim3(N / QB, B), QB * 32, smem, st>>>(
        graph, Cg, sq, a, Co, N, k, idx, amax, amin, asum, asumsq);
    return cudaGetLastError();
  });
}

bool bad_shape(int B, int N, int Cg, int Co, int k) {
  return B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 ||
         Co > dg::max_co(N) || Cg < 1 || k < 1 || k > N;
}

// The AMP form: the score operands (gq, gc: B * N * 3 Cg floats each) and
// the squared norms of the f32 graph, the rows' grids, then the keyed
// tiled route with a's values rounded to bf16.
cudaError_t reduce_amp(const float* graph, const float* a, float* gq,
                       float* gc, float* sq, float* rmin, int* idx,
                       float* amax, float* amin, float* asum, float* asumsq,
                       int B, int N, int Cg, int Co, int k,
                       cudaStream_t st) {
  if (bad_shape(B, N, Cg, Co, k) || k > dg::TS_LIST)
    return cudaErrorInvalidValue;
  cudaError_t e = dg::launch_amp_graph(graph, false, B * N, Cg, gq, gc, st);
  if (e != cudaSuccess) return e;
  e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  const int Cs = 3 * Cg;
  e = dg::launch_rowmin(gc, gq, Cs, sq, B, N, nullptr, N, N, rmin, st);
  if (e != cudaSuccess) return e;
  const TiledArgs t{gc,   gq,   a, sq, idx, amax, amin, asum, asumsq,
                    rmin, B,    N, Cs, Co,  k};
  if (k <= 32) return launch_tiled_co<1, dg::TS_KEYS, true>(t, st);
  return launch_tiled_co<2, dg::TS_KEYS, true>(t, st);
}

// x rounded to bf16 (to nearest even), as f32: the AMP select-x form's
// raw rows.
__global__ void xw_round_kernel(const float* __restrict__ x, size_t n,
                                float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = round_bf16(x[e]);
}

}  // namespace

// graph (B, N, Cg), a (B, N, Co), scratch sq (B*N,); out idx (B, N, k)
// int32 and amax/amin/asum/asumsq (B, N, Co); f32 otherwise, contiguous,
// on the device.  Returns the first CUDA error.
extern "C" int dg_knn_reduce(const float* graph, const float* a, float* sq,
                             int* idx, float* amax, float* amin, float* asum,
                             float* asumsq, int B, int N, int Cg, int Co,
                             int k, void* stream) {
  if (bad_shape(B, N, Cg, Co, k)) return (int)cudaErrorInvalidValue;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, nullptr, B,
                     N, Cg, Co, k, (cudaStream_t)stream);
}

// The v2 form of dg_knn_reduce: rmin (B * N f32) is scratch for the rows'
// grids; k <= 64.
extern "C" int dg_knn_reduce_v2(const float* graph, const float* a,
                                float* sq, float* rmin, int* idx, float* amax,
                                float* amin, float* asum, float* asumsq,
                                int B, int N, int Cg, int Co, int k,
                                void* stream) {
  if (bad_shape(B, N, Cg, Co, k) || rmin == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, rmin, B, N,
                     Cg, Co, k, (cudaStream_t)stream);
}

// As dg_knn_reduce over a = xf (B, N, Cin) @ w (Cin, Co), projected into
// the scratch a (B, N, Co) first; rmin non-null: the v2 form, as
// dg_knn_reduce_v2.
static int reduce_xw(const float* graph, const float* xf, const float* w,
                     float* a, float* sq, float* rmin, int* idx, float* amax,
                     float* amin, float* asum, float* asumsq, int B, int N,
                     int Cg, int Cin, int Co, int k, cudaStream_t st) {
  if (bad_shape(B, N, Cg, Co, k) || Cin < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = dg::launch_project(xf, B * N, Cin, w, Co, a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, rmin, B, N,
                     Cg, Co, k, st);
}

extern "C" int dg_knn_reduce_xw(const float* graph, const float* xf,
                                const float* w, float* a, float* sq, int* idx,
                                float* amax, float* amin, float* asum,
                                float* asumsq, int B, int N, int Cg, int Cin,
                                int Co, int k, void* stream) {
  return reduce_xw(graph, xf, w, a, sq, nullptr, idx, amax, amin, asum,
                   asumsq, B, N, Cg, Cin, Co, k, (cudaStream_t)stream);
}

extern "C" int dg_knn_reduce_xw_v2(const float* graph, const float* xf,
                                   const float* w, float* a, float* sq,
                                   float* rmin, int* idx, float* amax,
                                   float* amin, float* asum, float* asumsq,
                                   int B, int N, int Cg, int Cin, int Co,
                                   int k, void* stream) {
  if (rmin == nullptr) return (int)cudaErrorInvalidValue;
  return reduce_xw(graph, xf, w, a, sq, rmin, idx, amax, amin, asum, asumsq,
                   B, N, Cg, Cin, Co, k, (cudaStream_t)stream);
}

// The AMP form of dg_knn_reduce (k <= 64): scratch gq and gc (B * N * 3
// Cg f32 each: the score operands), sq and rmin (B * N f32).
extern "C" int dg_knn_reduce_amp(const float* graph, const float* a,
                                 float* gq, float* gc, float* sq,
                                 float* rmin, int* idx, float* amax,
                                 float* amin, float* asum, float* asumsq,
                                 int B, int N, int Cg, int Co, int k,
                                 void* stream) {
  return (int)reduce_amp(graph, a, gq, gc, sq, rmin, idx, amax, amin, asum,
                         asumsq, B, N, Cg, Co, k, (cudaStream_t)stream);
}

// The AMP form of dg_knn_reduce_xw: xr (B * N * Cin f32) takes x rounded
// to bf16, a (B, N, Co) its product with w (launch_project), then the
// reductions of dg_knn_reduce_amp over a's values rounded to bf16; the
// same scratch as dg_knn_reduce_amp.
extern "C" int dg_knn_reduce_xw_amp(const float* graph, const float* xf,
                                    const float* w, float* xr, float* a,
                                    float* gq, float* gc, float* sq,
                                    float* rmin, int* idx, float* amax,
                                    float* amin, float* asum, float* asumsq,
                                    int B, int N, int Cg, int Cin, int Co,
                                    int k, void* stream) {
  if (bad_shape(B, N, Cg, Co, k) || Cin < 1 || k > dg::TS_LIST)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t xn = (size_t)B * N * Cin;
  xw_round_kernel<<<(unsigned)((xn + 255) / 256), 256, 0, st>>>(xf, xn, xr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = dg::launch_project(xr, B * N, Cin, w, Co, a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_amp(graph, a, gq, gc, sq, rmin, idx, amax, amin, asum,
                         asumsq, B, N, Cg, Co, k, st);
}

// out (M, ncols) = x (M, K) @ w (K, ncols): the projection of
// dg_knn_reduce_xw on its own, for the backward's recomputation of a.
extern "C" int dg_project(const float* x, const float* w, float* out, int M,
                          int K, int ncols, void* stream) {
  if (M < 1 || K < 1 || ncols < 1) return (int)cudaErrorInvalidValue;
  return (int)dg::launch_project(x, M, K, w, ncols, out,
                                 (cudaStream_t)stream);
}
