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
// (knn_select.cuh); the reductions over the list are the v1 form's.  On
// the row-warp route (below) the same keys come from row_keys, the row's
// least score taken from its registers, in one scoring pass.
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
// f32 inputs and outputs, at any k <= N (the JAX kernels have no k cap).
// On the tiled route (k <= TS_LIST), for Cg <= 128, the AMP form's scores
// come from the tensor cores in both its passes (the rows' grids, then
// the keys): the operands are written as bf16, [hi | hi | lo] and [hi |
// lo | hi] padded with zeros to Kp = 3 Cg rounded up to 16 channels
// (amp_operands_kernel: half the bytes of the f32 operands), and each 64 x
// 128 tile's scores are bf16 mma.sync m16n8k16 products with f32 sums
// (knn_select.cuh's tiled_topk over __nv_bfloat16), less the f32 squared
// norms as before;
// the rows' grids come first from knn_rowmin_tc_kernel, 128 query rows a
// block resident in shared memory, the same scores' minima.
// Each bf16 x bf16 product is exact in f32; the order of the f32 sums and
// the tensor core's truncating adds differ from the fmaf chain, as the
// TPU's MXU differs, within the AMP contract (ROADMAP B).  The keyed
// selection, its ties and the reductions are unchanged.  The earlier
// form, the fmaf chain over f32 operands on the CUDA cores (~6x the exact
// form's score work: 3 Cg channels, scored twice), stays callable (flags
// bit 1, simt) as the oracle and the A/B's other side; the row-warp route
// keeps it.
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
//   k > TS_LIST, or rowwarp (the oracle of the tiled route)
//     knn_reduce_kernel: the row-warp selection (sqnorm, one warp per query
//     row with its N scores in registers, or in knn_select.cuh's shared
//     row above 4096 points or at Co > 128 above 2048, k rounds of warp
//     arg-max; v2 on the keys of row_keys, the AMP form's scores through
//     its query operands and a's values rounded).
// Both give the same scores bit for bit (one fmaf chain over the channels,
// 0 ascending, then the same _rn operations; but the AMP form's
// tensor-core scores, above) and the same neighbours in torch.topk's
// order.  Each winner's index goes to idx and its row of a is read whole
// (coalesced) into running max/min/sum/sum-of-squares, t ascending, with
// _rn intrinsics so that nothing is contracted into an FMA: the two
// routes' outputs are the same bits.  The rows are read
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The row-warp route (k > TS_LIST, or asked for): a warp a query row.
// KEYS: v2, the row's keys (knn_select.cuh's row_keys) of the scores whose
// query operands are gq's row (the AMP scores; gq is graph in the exact v2
// form); AMP: a's values rounded to bf16 as they are read.
template <int NPL, bool KEYS, bool AMP>
__global__ void __launch_bounds__(dg::ROW_QB<NPL, KEYS> * 32, 1)
    knn_reduce_kernel(const float* __restrict__ graph,
                      const float* __restrict__ gq, int Cg,
                      const float* __restrict__ sq,
                      const float* __restrict__ a, int Co, int N, int k,
                      int* __restrict__ idx, float* __restrict__ amax,
                      float* __restrict__ amin, float* __restrict__ asum,
                      float* __restrict__ asumsq, float lim) {
  extern __shared__ float sg[];  // N rows x CS: CC channels of the cloud
  constexpr int CPL = dg::Bucket<NPL>::CPL;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i =
      blockIdx.x * dg::block_rows<NPL>(dg::ROW_QB<NPL, KEYS>) + warp;
  dg::RowScores<NPL> s;
  dg::row_scores<NPL>(graph + (size_t)b * N * Cg, Cg, sq + (size_t)b * N, N,
                      i, lane, sg, s,
                      KEYS ? gq + ((size_t)b * N + i) * Cg : nullptr);
  if constexpr (KEYS) dg::row_keys<NPL>(s, lim);

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

// The tiled route: the block's 64 rows' lists, then the reductions, a
// warp its eight rows; CPL output channels a lane (Co <= 32 * CPL).  MODE
// TS_TOPK is v1; TS_KEYS v2, on the rows' grids in rmin, its query rows
// from gq.  AMP: the AMP form (TS_KEYS over the AMP score operands, Cg =
// 3 x the graph's channels), a's values rounded to bf16 as they are read.
// OP __nv_bfloat16: the AMP form's tensor-core scores (graph and gq the
// bf16 operands, Cg their padded channels).  AMP stays the last template
// argument (chip_smoke.py tells the AMP instances by it).
template <int KL, int CPL, int MODE, typename OP, bool AMP>
__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    knn_reduce_tiled_kernel(const OP* __restrict__ graph,
                            const OP* __restrict__ gq, int Cg,
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
  const OP* G = graph + (size_t)b * N * Cg;
  dg::tiled_topk<KL, false, MODE, OP>(
      G, Cg, sq + (size_t)b * N, 0, N, r0, k, tsm, ls, li,
      gq + (size_t)b * N * Cg,
      MODE == dg::TS_KEYS ? rmin + (size_t)b * N : nullptr, lim);

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
// Cg: the channels of graph and gq.  The tensor-core instances (OP bf16)
// read graph and gq as bf16 (launch_tiled casts them).
struct TiledArgs {
  const float *graph, *gq, *a, *sq;
  int* idx;
  float *amax, *amin, *asum, *asumsq, *rmin;
  int B, N, Cg, Co, k;
};

template <int KL, int CPL, int MODE, bool AMP, typename OP = float>
cudaError_t launch_tiled(const TiledArgs& t, cudaStream_t st) {
  constexpr size_t smem = std::is_same_v<OP, float> ? dg::TS_SMEM_BYTES
                                                    : dg::TC_SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      knn_reduce_tiled_kernel<KL, CPL, MODE, OP, AMP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  knn_reduce_tiled_kernel<KL, CPL, MODE, OP, AMP>
      <<<dim3(t.N / dg::TS_R, t.B), dg::TS_THREADS, smem, st>>>(
          reinterpret_cast<const OP*>(t.graph),
          reinterpret_cast<const OP*>(t.gq), t.Cg, t.sq, t.a, t.Co, t.N, t.k,
          t.idx, t.amax, t.amin, t.asum, t.asumsq, t.rmin,
          dg::keys_lim(t.N));
  return cudaGetLastError();
}

template <int KL, int MODE, bool AMP = false, typename OP = float>
cudaError_t launch_tiled_co(const TiledArgs& t, cudaStream_t st) {
  if (t.Co <= 64) return launch_tiled<KL, 2, MODE, AMP, OP>(t, st);
  if (t.Co <= 128) return launch_tiled<KL, 4, MODE, AMP, OP>(t, st);
  return launch_tiled<KL, 8, MODE, AMP, OP>(t, st);
}

// The row-warp instance: v1 (TS_TOPK), or MODE TS_KEYS over the query
// operands t.gq, a's values rounded to bf16 with AMP.
template <int MODE, bool AMP = false>
cudaError_t launch_rowwarp(const TiledArgs& t, cudaStream_t st) {
  return dg::with_npl(t.N, t.Co, [&](auto npl) {
    constexpr int NPL = decltype(npl)::value;
    const int QB =
        dg::launch_rows<NPL>(dg::ROW_QB<NPL, MODE == dg::TS_KEYS>, t.N);
    auto kern = knn_reduce_kernel<NPL, MODE == dg::TS_KEYS, AMP>;
    const size_t smem = dg::select_smem_bytes<NPL>(t.N, QB);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(t.N / QB, t.B), QB * 32, smem, st>>>(
        t.graph, t.gq, t.Cg, t.sq, t.a, t.Co, t.N, t.k, t.idx, t.amax,
        t.amin, t.asum, t.asumsq, dg::keys_lim(t.N));
    return cudaGetLastError();
  });
}

// The selection and reductions of t: the tiled route at k <= TS_LIST, the
// row-warp route above it or with rowwarp.  MODE TS_KEYS: v2, the rows'
// grids first on the tiled route (launch_rowmin into t.rmin).
template <int MODE, bool AMP = false>
cudaError_t select_reduce(const TiledArgs& t, bool rowwarp, cudaStream_t st) {
  if (rowwarp || t.k > dg::TS_LIST) return launch_rowwarp<MODE, AMP>(t, st);
  if constexpr (MODE == dg::TS_KEYS) {
    const cudaError_t e = dg::launch_rowmin(t.graph, t.gq, t.Cg, t.sq, t.B,
                                            t.N, nullptr, t.N, t.N, t.rmin,
                                            st);
    if (e != cudaSuccess) return e;
  }
  if (t.k <= 32) return launch_tiled_co<1, MODE, AMP>(t, st);
  return launch_tiled_co<2, MODE, AMP>(t, st);
}

// sqnorm of the graph, then the selection over a.  rmin (B * N scratch)
// asks for the v2 form.
cudaError_t reduce(const float* graph, const float* a, float* sq, int* idx,
                   float* amax, float* amin, float* asum, float* asumsq,
                   float* rmin, int B, int N, int Cg, int Co, int k,
                   bool rowwarp, cudaStream_t st) {
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  const TiledArgs t{graph, graph, a,  sq, idx, amax, amin, asum, asumsq,
                    rmin,  B,     N, Cg, Co,  k};
  if (rmin != nullptr) return select_reduce<dg::TS_KEYS>(t, rowwarp, st);
  return select_reduce<dg::TS_TOPK>(t, rowwarp, st);
}

bool bad_shape(int B, int N, int Cg, int Co, int k) {
  return B < 1 || N % 128 != 0 || N > MAX_N || Co < 1 || Co > dg::MAX_CO ||
         Cg < 1 || k < 1 || k > N;
}

// The tensor-core operands' channels: 3 Cg padded to a multiple of 16.
int amp_tc_channels(int Cg) { return (3 * Cg + 15) / 16 * 16; }

// The AMP form's tensor-core operands of an f32 graph (rows x Cg): [hi |
// hi | lo | 0..] into gq and [hi | lo | hi | 0..] into gc, Kp bf16
// channels a row (hi = bf16(v), lo = bf16(v - hi), to nearest even).
__global__ void amp_operands_kernel(const float* __restrict__ graph,
                                    int rows, int Cg, int Kp,
                                    __nv_bfloat16* __restrict__ gq,
                                    __nv_bfloat16* __restrict__ gc) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * Kp) return;
  const size_t r = e / Kp;
  const int c = (int)(e - r * Kp), part = c / Cg, ch = c - part * Cg;
  float q = 0.f, x = 0.f;
  if (part < 3) {
    const float v = graph[r * Cg + ch];
    const float h = round_bf16(v), l = round_bf16(__fsub_rn(v, h));
    q = part < 2 ? h : l;
    x = part == 1 ? l : h;
  }
  gq[e] = __float2bfloat16_rn(q);
  gc[e] = __float2bfloat16_rn(x);
}

// The v2 grid of the tensor-core scores, each row's least score over the
// cloud: as TS_MIN over the bf16 operands, on its own.  A block of 256
// threads owns RM_R = 128 query rows (warp w rows 16 w .. + 15), their
// operands resident in shared memory, and streams the cloud's columns in
// tiles of TS_J, TC_KC channels at a time in two buffers by cp.async: half
// the column traffic of tiled_topk's 64-row blocks, none of the query
// rows'.  Each score is tiled_topk's: the same mma.sync k16 steps in the
// same order from a zero accumulator (an MMA's output depends on its
// operands and accumulator alone), finished by the same _rn operations;
// the thread folds them into its two rows' running minima, and the quad's
// lanes fold those.  Kp <= RM_MAX_KP (Cg <= 128, every model's): larger
// graphs take the earlier form (reduce_amp).
constexpr int RM_R = 128;
constexpr int RM_MAX_KP = 384;
size_t rowmin_smem_bytes(int Kp) {
  return sizeof(__nv_bfloat16) *
         ((size_t)RM_R * (Kp + 8) + 2 * (size_t)dg::TS_J * dg::TC_LD);
}

__global__ void __launch_bounds__(dg::TS_THREADS, 2)
    knn_rowmin_tc_kernel(const __nv_bfloat16* __restrict__ gc,
                         const __nv_bfloat16* __restrict__ gq, int Kp,
                         const float* __restrict__ sq, int N,
                         float* __restrict__ rmin) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rsm[];
  constexpr int J = dg::TS_J, KC = dg::TC_KC, LD = dg::TC_LD;
  const int LQ = Kp + 8;
  bf16* qs = reinterpret_cast<bf16*>(rsm);  // RM_R rows of Kp channels
  bf16* gs = qs + RM_R * LQ;                // two chunks of J columns
  const int b = blockIdx.y, r0 = blockIdx.x * RM_R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* G = gc + (size_t)b * N * Kp;
  const bf16* Q = gq + (size_t)b * N * Kp;
  const float* SQ = sq + (size_t)b * N;
  const int per = Kp / 8;  // 16-byte copies a row
  for (int e = threadIdx.x; e < RM_R * per; e += dg::TS_THREADS) {
    const int r = e / per, c = 8 * (e - r * per);
    dg_bf16::copy16(qs + r * LQ + c, Q + (size_t)(r0 + r) * Kp + c, true);
  }
  const int chunks = (Kp + KC - 1) / KC, steps = (N / J) * chunks;
  auto load = [&](int step, int buf) {
    const int tl = step / chunks, c = step - tl * chunks;
    const int n8 = min(KC, Kp - c * KC) / 8;
    for (int e = threadIdx.x; e < J * n8; e += dg::TS_THREADS) {
      const int r = e / n8, cc = 8 * (e - r * n8);
      dg_bf16::copy16(gs + (buf * J + r) * LD + cc,
                      G + (size_t)(tl * J + r) * Kp + c * KC + cc, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load(0, 0);  // with the query rows' copies
  const float qq[2] = {SQ[r0 + 16 * warp + g], SQ[r0 + 16 * warp + g + 8]};
  float mn[2] = {INFINITY, INFINITY};
  float acc[J / 8][4];
  // A: the warp's 16 rows; B: 8 columns a n-tile (ldmatrix as tiled_topk)
  const bf16* qa = qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                            LQ + 8 * (lane >> 4);
  const int boff =
      ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  for (int s = 0; s < steps; ++s) {
    const int tl = s / chunks, c = s - tl * chunks;
    if (c == 0)
#pragma unroll
      for (int j = 0; j < J / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // step s (and the query rows) landed for every thread, and every
    // thread is done with step s - 1, whose buffer the next copy fills
    __syncthreads();
    if (s + 1 < steps) load(s + 1, (s + 1) & 1);
    const bf16* gb = gs + (s & 1) * J * LD + boff;
    const int nk = min(KC, Kp - c * KC) / 16;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (kk < nk) {
        unsigned a[4];
        dg_bf16::ldsm_x4(a, qa + c * KC + 16 * kk);
#pragma unroll
        for (int j = 0; j < J / 8; j += 2) {
          unsigned bb[4];
          dg_bf16::ldsm_x4(bb, gb + 8 * j * LD + 16 * kk);
          dg_bf16::mma(acc[j], a, bb[0], bb[1]);
          dg_bf16::mma(acc[j + 1], a, bb[2], bb[3]);
        }
      }
    }
    if (c + 1 < chunks) continue;
#pragma unroll
    for (int j = 0; j < J / 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float sqc = SQ[tl * J + 8 * j + 2 * t + cc];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mn[h] = fminf(mn[h],
                        __fsub_rn(__fsub_rn(__fmul_rn(2.f, acc[j][2 * h + cc]),
                                            qq[h]),
                                  sqc));
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mn[h] = fminf(mn[h], __shfl_xor_sync(0xffffffffu, mn[h], 1));
    mn[h] = fminf(mn[h], __shfl_xor_sync(0xffffffffu, mn[h], 2));
    if (t == 0) rmin[(size_t)b * N + r0 + 16 * warp + g + 8 * h] = mn[h];
  }
}

// The AMP form: the score operands and the squared norms of the f32 graph,
// then the keyed selection (the rows' grids first on the tiled route) with
// a's values rounded to bf16.  The tiled route takes the tensor-core
// scores (gq, gc: B * N * Kp bf16 each) up to Kp = RM_MAX_KP, unless simt
// asks for the earlier form; the row-warp route (rowwarp, or k >
// TS_LIST), simt and Cg > 128 take the f32 operands (gq, gc: B * N * 3 Cg
// floats each).
cudaError_t reduce_amp(const float* graph, const float* a, float* gq,
                       float* gc, float* sq, float* rmin, int* idx,
                       float* amax, float* amin, float* asum, float* asumsq,
                       int B, int N, int Cg, int Co, int k, bool rowwarp,
                       bool simt, cudaStream_t st) {
  if (bad_shape(B, N, Cg, Co, k)) return cudaErrorInvalidValue;
  cudaError_t e = dg::launch_sqnorm(graph, B * N, Cg, sq, st);
  if (e != cudaSuccess) return e;
  if (rowwarp || simt || k > dg::TS_LIST ||
      amp_tc_channels(Cg) > RM_MAX_KP) {
    e = dg::launch_amp_graph(graph, false, B * N, Cg, gq, gc, st);
    if (e != cudaSuccess) return e;
    const TiledArgs t{gc,   gq, a, sq,     idx, amax, amin, asum, asumsq,
                      rmin, B,  N, 3 * Cg, Co,  k};
    return select_reduce<dg::TS_KEYS, true>(t, rowwarp, st);
  }
  using bf16 = __nv_bfloat16;
  const int Kp = amp_tc_channels(Cg);
  bf16* oq = reinterpret_cast<bf16*>(gq);
  bf16* oc = reinterpret_cast<bf16*>(gc);
  const size_t n = (size_t)B * N * Kp;
  amp_operands_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      graph, B * N, Cg, Kp, oq, oc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = rowmin_smem_bytes(Kp);
  e = cudaFuncSetAttribute(knn_rowmin_tc_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  knn_rowmin_tc_kernel<<<dim3(N / RM_R, B), dg::TS_THREADS, smem, st>>>(
      oc, oq, Kp, sq, N, rmin);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const TiledArgs t{gc,   gq, a, sq, idx, amax, amin, asum, asumsq,
                    rmin, B,  N, Kp, Co,  k};
  if (k <= 32) return launch_tiled_co<1, dg::TS_KEYS, true, bf16>(t, st);
  return launch_tiled_co<2, dg::TS_KEYS, true, bf16>(t, st);
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
// on the device.  The tiled route at k <= TS_LIST, the row-warp route
// above.  Returns the first CUDA error.
extern "C" int dg_knn_reduce(const float* graph, const float* a, float* sq,
                             int* idx, float* amax, float* amin, float* asum,
                             float* asumsq, int B, int N, int Cg, int Co,
                             int k, void* stream) {
  if (bad_shape(B, N, Cg, Co, k)) return (int)cudaErrorInvalidValue;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, nullptr, B,
                     N, Cg, Co, k, false, (cudaStream_t)stream);
}

// The v2 form of dg_knn_reduce: rmin (B * N f32) is scratch for the rows'
// grids; rowwarp: the row-warp route at any k (the oracle of the tiled
// one; each form's entry below takes it likewise).
extern "C" int dg_knn_reduce_v2(const float* graph, const float* a,
                                float* sq, float* rmin, int* idx, float* amax,
                                float* amin, float* asum, float* asumsq,
                                int B, int N, int Cg, int Co, int k,
                                int rowwarp, void* stream) {
  if (bad_shape(B, N, Cg, Co, k) || rmin == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, rmin, B, N,
                     Cg, Co, k, rowwarp, (cudaStream_t)stream);
}

// As dg_knn_reduce over a = xf (B, N, Cin) @ w (Cin, Co), projected into
// the scratch a (B, N, Co) first; rmin non-null: the v2 form, as
// dg_knn_reduce_v2.
static int reduce_xw(const float* graph, const float* xf, const float* w,
                     float* a, float* sq, float* rmin, int* idx, float* amax,
                     float* amin, float* asum, float* asumsq, int B, int N,
                     int Cg, int Cin, int Co, int k, bool rowwarp,
                     cudaStream_t st) {
  if (bad_shape(B, N, Cg, Co, k) || Cin < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = dg::launch_project(xf, B * N, Cin, w, Co, a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce(graph, a, sq, idx, amax, amin, asum, asumsq, rmin, B, N,
                     Cg, Co, k, rowwarp, st);
}

extern "C" int dg_knn_reduce_xw(const float* graph, const float* xf,
                                const float* w, float* a, float* sq, int* idx,
                                float* amax, float* amin, float* asum,
                                float* asumsq, int B, int N, int Cg, int Cin,
                                int Co, int k, void* stream) {
  return reduce_xw(graph, xf, w, a, sq, nullptr, idx, amax, amin, asum,
                   asumsq, B, N, Cg, Cin, Co, k, false,
                   (cudaStream_t)stream);
}

extern "C" int dg_knn_reduce_xw_v2(const float* graph, const float* xf,
                                   const float* w, float* a, float* sq,
                                   float* rmin, int* idx, float* amax,
                                   float* amin, float* asum, float* asumsq,
                                   int B, int N, int Cg, int Cin, int Co,
                                   int k, int rowwarp, void* stream) {
  if (rmin == nullptr) return (int)cudaErrorInvalidValue;
  return reduce_xw(graph, xf, w, a, sq, rmin, idx, amax, amin, asum, asumsq,
                   B, N, Cg, Cin, Co, k, rowwarp, (cudaStream_t)stream);
}

// The AMP form of dg_knn_reduce: scratch gq and gc (each the larger of 3
// Cg f32 and Kp = 3 Cg rounded up to 16 bf16 a point, 16-byte aligned: the
// score operands), sq and rmin (B * N f32).  flags bit 0: the row-warp
// route at any k (rowwarp); bit 1: the earlier form of the tiled route,
// the fmaf chain over f32 operands (simt).
extern "C" int dg_knn_reduce_amp(const float* graph, const float* a,
                                 float* gq, float* gc, float* sq,
                                 float* rmin, int* idx, float* amax,
                                 float* amin, float* asum, float* asumsq,
                                 int B, int N, int Cg, int Co, int k,
                                 int flags, void* stream) {
  return (int)reduce_amp(graph, a, gq, gc, sq, rmin, idx, amax, amin, asum,
                         asumsq, B, N, Cg, Co, k, flags & 1, flags & 2,
                         (cudaStream_t)stream);
}

// The AMP form of dg_knn_reduce_xw: xr (B * N * Cin f32) takes x rounded
// to bf16, a (B, N, Co) its product with w (launch_project), then the
// reductions of dg_knn_reduce_amp over a's values rounded to bf16; the
// same scratch and flags as dg_knn_reduce_amp.
extern "C" int dg_knn_reduce_xw_amp(const float* graph, const float* xf,
                                    const float* w, float* xr, float* a,
                                    float* gq, float* gc, float* sq,
                                    float* rmin, int* idx, float* amax,
                                    float* amin, float* asum, float* asumsq,
                                    int B, int N, int Cg, int Cin, int Co,
                                    int k, int flags, void* stream) {
  if (bad_shape(B, N, Cg, Co, k) || Cin < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t xn = (size_t)B * N * Cin;
  xw_round_kernel<<<(unsigned)((xn + 255) / 256), 256, 0, st>>>(xf, xn, xr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = dg::launch_project(xr, B * N, Cin, w, Co, a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_amp(graph, a, gq, gc, sq, rmin, idx, amax, amin, asum,
                         asumsq, B, N, Cg, Co, k, flags & 1, flags & 2, st);
}

// out (M, ncols) = x (M, K) @ w (K, ncols): the projection of
// dg_knn_reduce_xw on its own, for the backward's recomputation of a.
extern "C" int dg_project(const float* x, const float* w, float* out, int M,
                          int K, int ncols, void* stream) {
  if (M < 1 || K < 1 || ncols < 1) return (int)cudaErrorInvalidValue;
  return (int)dg::launch_project(x, M, K, w, ncols, out,
                                 (cudaStream_t)stream);
}
