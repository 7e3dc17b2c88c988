// The kNN selections of the port's neighbour-picking kernels.  Three
// components: the row-warp selection below (row_scores, pop_nearest) of
// knn_idx.cu, knn_sum.cu, edge_conv_eval.cu, edge_conv_amp.cu,
// knn_edge2.cu, knn_edge2_variant.cu and knn_reduce.cu at k > TS_LIST
// (kernel 6 and the banded kernel 13 also at C1 > 64 or C2 > 128), in each
// mode (the exact v1 arg-max, the keyed v2 of row_keys, the class walk v3
// of pop_class, on exact or AMP scores), with a row's scores in registers
// (a register bucket) or in shared memory (the shared row); and the tiled
// selection further down (tiled_topk) of those kernels (11, 10, 1 and 12,
// 6 and 13, 3 and 4) at k <= TS_LIST.  All give the same neighbours in
// the same order, in every mode.  The banded kernels 12 and
// 13 hand either selection a window of their sorted cloud as the
// candidates: row_scores takes it as the cloud, tiled_topk as its column
// range.
//
// A warp owns one query row i of a cloud and scores its N columns.  In a
// register bucket it keeps them in registers, NPL = N / 32 a lane (column
// j = 32 * t + lane in s[t]), so the N x N score matrix never leaves the
// SM; a block holds QB query rows of one cloud and stages the cloud's
// graph features through shared memory CC channels at a time (Bucket
// below).  The buckets end at REG_MAX_N points (128 scores a lane).  The
// shared row (NPL = SROW) keeps the same slots in shared memory, slot t of
// lane l at word 32 t + l of the warp's row, and stages the cloud in tiles
// of SR_TJ columns, so that no register and no staged buffer grows with
// N: it takes the clouds above REG_MAX_N, up to MAX_N, the rows whose Co
// the bucket's lanes cannot hold (max_co), and, asked for
// (force_srow), any row route as the check of its bits.  The scores follow
// the reference's operation order, (2 * <g_i, g_j> - |g_i|^2) - |g_j|^2,
// with the _rn intrinsics so that nvcc cannot contract them into an FMA,
// each the same fmaf chain over the channels, 0 ascending, in every
// component; the k neighbours then come out one per round of a warp
// arg-max on (score, -index): torch.topk's order, lowest index first among
// ties.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace dg {

// the most points a whole-cloud kNN kernel's cloud, or a banded kernel's
// window, holds (the banded kernels 12 and 13 take any N)
constexpr int MAX_N = 32768;
constexpr int REG_MAX_N = 4096;  // register buckets: N / 32 <= 128 a lane
constexpr int MAX_CO = 256;      // the widest Co of the kNN kernels
constexpr int SROW = 0;          // the NPL of the shared row
// the dynamic shared memory a block may take on sm_90
constexpr size_t SMEM_MAX = 227 * 1024;

// The block shape of a register bucket of NPL scores a lane.  Up to 64
// (N <= 2048) a block runs QB = 16 warps, stages CC = 8 graph channels a
// pass and a lane reduces up to CPL = 8 output channels (Co <= 256).
// Above, a thread holds 96 or 128 scores: the block drops to 8 warps, so
// that __launch_bounds__(QB * 32) leaves a thread up to 255 registers, and
// a lane reduces up to 4 output channels (Co <= 128).  Such a block takes
// the whole register file, one block an SM; a pass stages 4 channels
// (81,920 B at N = 4096).  At 128 scores a lane ptxas still spills ~100
// bytes a thread, in the score loop and the rounds' lane-local arg-max.
// The staging width does not change the scores' bits: each score sums its
// channels in ascending order whatever CC is, and padded channels add
// exact zeros.
template <int NPL>
struct Bucket {
  static constexpr int QB = NPL <= 64 ? 16 : 8;   // query rows (warps)
  static constexpr int CC = NPL <= 64 ? 8 : 4;    // channels per pass
  static constexpr int CS = CC + 1;  // padded row stride: no bank conflicts
  static constexpr int CPL = NPL <= 64 ? 8 : 4;   // output channels a lane
};

// The shared row: up to 8 query rows a block (its launch picks them,
// srow_qb), 8 output channels a lane (Co <= 256).
template <>
struct Bucket<SROW> {
  static constexpr int QB = 8, CC = 8, CS = 9, CPL = 8;
};

// The widest Co that the register bucket of N takes.
inline int max_co(int N) { return N / 32 <= 64 ? 256 : 128; }

// Query rows (warps) a block of the row-warp kernels that hold more than
// the scores through their rounds: kernel 6's per-edge state (knn_edge2.cu,
// knn_edge2_variant.cu) and the keyed and class modes below.  From 64
// scores a lane up, 8 warps, so that __launch_bounds__ leaves a thread up
// to 255 registers: at Bucket's 16 warps (128 registers) the keyed forms of
// kernels 3, 10 and 11 spilled 64-460 bytes a thread at N = 2048.
template <int NPL>
struct RowBlock {
  static constexpr int QB = NPL >= 64 ? 8 : Bucket<NPL>::QB;
};

// The query rows a block of kernels 3, 10 and 11's row-warp route: Bucket's
// for the exact v1 arg-max, RowBlock's for the keyed (v2) mode.
template <int NPL, bool KEYED>
constexpr int ROW_QB = KEYED ? RowBlock<NPL>::QB : Bucket<NPL>::QB;

// A warp's row of scores: NPL registers a lane, or the shared row's slots.
struct SRow {
  float* p;      // this lane's slot 0; slot t (column 32 t + lane) is p[32 t]
  unsigned* mk;  // the row's ballots (pop_class), a word a slot
  int n;         // slots a lane, W / 32
};
template <int NPL>
using RowScores =
    std::conditional_t<NPL == SROW, SRow, float[NPL == SROW ? 1 : NPL]>;

// The shared row's staging: tiles of SR_TJ columns, SR_CC channels a pass
// (row stride SR_CS: no bank conflicts).
constexpr int SR_TJ = 256, SR_CC = 8, SR_CS = SR_CC + 1;

// Shared memory of a shared-row block of qb rows over W candidates: the
// rows, their ballots and the staged tile.
__host__ __device__ inline size_t srow_smem_bytes(int W, int qb) {
  return sizeof(float) * ((size_t)qb * (W + W / 32) + SR_TJ * SR_CS);
}

// The rows (warps) a block of the shared row over W candidates takes: the
// most, up to 8 and a power of two (so that it divides N), whose shared
// memory, with the kernel's own `fixed` bytes and `per_row` bytes a row,
// fits SMEM_MAX; 0 if one row does not (W > MAX_N).
inline int srow_qb(int W, size_t fixed = 0, size_t per_row = 0) {
  for (int qb = 8; qb >= 1; qb >>= 1)
    if (srow_smem_bytes(W, qb) + fixed + qb * per_row <= SMEM_MAX) return qb;
  return 0;
}

// The rows a block of a row route: qb, the kernel's rule, for a register
// bucket; the launch's (srow_qb) for the shared row.
template <int NPL>
__device__ __forceinline__ int block_rows(int qb) {
  return NPL == SROW ? (int)(blockDim.x >> 5) : qb;
}
template <int NPL>
inline int launch_rows(int qb, int W, size_t fixed = 0, size_t per_row = 0) {
  return NPL == SROW ? srow_qb(W, fixed, per_row) : qb;
}

// Dynamic shared memory of the selection of a row-route block for a cloud
// (window) of N points: a register bucket's graph stage, or the shared
// row's srow_smem_bytes at qb rows.
template <int NPL>
__host__ __device__ inline size_t select_smem_bytes(int N, int qb = 0) {
  if constexpr (NPL == SROW) return srow_smem_bytes(N, qb);
  return (size_t)N * Bucket<NPL>::CS * sizeof(float);
}

// Set by dg_force_shared_rows (edge_conv_eval.cu): every row route then
// takes the shared row, the check that it gives the register buckets'
// bits.
bool& force_srow();
// The launches with_npl sent to the shared row (dg_srow_launches).
unsigned long long& srow_launches();

// One 4-byte asynchronous copy from global to shared memory (cp.async,
// sm_80 and later): *dst = *src, or 0 when `in` is false.  Nothing waits
// for it until cp.async.wait_all, and it holds no register.
__device__ __forceinline__ void async_copy4(float* dst, const float* src,
                                            bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Channel c0 + c of query row i for the score chain: its staged value (row
// i of sg), or qrow's (zero past Cg, as the staged rows are padded).
template <int NPL>
__device__ __forceinline__ float query_channel(const float* sg, int i,
                                               const float* __restrict__ qrow,
                                               int Cg, int c0, int c) {
  if (qrow == nullptr) return sg[i * Bucket<NPL>::CS + c];
  return c0 + c < Cg ? qrow[c0 + c] : 0.f;
}

// row_scores for the buckets above 64 scores a lane (one block an SM).
// The graph stage is copied with cp.async: a staging loop of plain loads
// keeps one load in flight a thread, and at one block an SM that took most
// of the kernel's time at Cg = 64 (PERF.md, Findings).  The squared norms
// ride in each row's padding slot (channel CC) of the last pass and each
// score is finished in that pass's loop: finished in a loop of its own over
// SQ in global memory, the compiler issues all NPL loads at once and holds
// them in as many registers, which spill at 128 scores a lane.  Each score
// takes the operations of row_scores below in the same order.
template <int NPL>
__device__ __forceinline__ void row_scores_async(
    const float* __restrict__ G, int Cg, const float* __restrict__ SQ, int N,
    int i, int lane, float* sg, float (&s)[NPL],
    const float* __restrict__ qrow) {
  constexpr int CC = Bucket<NPL>::CC, CS = Bucket<NPL>::CS;
  const int passes = (Cg + CC - 1) / CC;
#pragma unroll
  for (int t = 0; t < NPL; ++t) s[t] = 0.f;
  for (int p = 0; p < passes; ++p) {
    const int c0 = p * CC;
    const bool last = p == passes - 1;
    __syncthreads();  // every warp is done with the previous pass
    for (int e = threadIdx.x; e < N * CC; e += blockDim.x) {
      const int j = e / CC, c = e - j * CC;
      const bool in = c0 + c < Cg;
      async_copy4(sg + j * CS + c, in ? G + (size_t)j * Cg + c0 + c : G, in);
    }
    if (last)
      for (int j = threadIdx.x; j < N; j += blockDim.x)
        async_copy4(sg + j * CS + CC, SQ + j, true);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float q[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c)
      q[c] = query_channel<NPL>(sg, i, qrow, Cg, c0, c);
    if (last) {
      const float qq = sg[i * CS + CC];
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int j = t * 32 + lane;
        if (j < N) {
          const float* r = sg + j * CS;
#pragma unroll
          for (int c = 0; c < CC; ++c) s[t] = fmaf(q[c], r[c], s[t]);
          s[t] = __fsub_rn(__fsub_rn(__fmul_rn(2.f, s[t]), qq), r[CC]);
        } else {
          s[t] = -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int j = t * 32 + lane;
        if (j < N) {
          const float* r = sg + j * CS;
#pragma unroll
          for (int c = 0; c < CC; ++c) s[t] = fmaf(q[c], r[c], s[t]);
        }
      }
    }
  }
}

// row_scores for the shared row: the block's sm holds its rows (row w at
// word w * N), their ballots and one staged tile.  The cloud comes in
// tiles of SR_TJ columns and SR_CC channels a pass, each lane's SR_TJ / 32
// scores of the tile in registers across the passes, so a score is the
// same fmaf chain over the channels, 0 ascending (padded channels add
// exact zeros), finished by the same _rn operations: row_scores' bits.
// The query row's operands come from qrow or G's row i.
__device__ __forceinline__ void srow_scores(const float* __restrict__ G,
                                            int Cg,
                                            const float* __restrict__ SQ,
                                            int N, int i, int lane, float* sm,
                                            SRow& s,
                                            const float* __restrict__ qrow) {
  constexpr int U = SR_TJ / 32;
  const int qb = blockDim.x >> 5, warp = threadIdx.x >> 5;
  s.n = N / 32;
  s.p = sm + (size_t)warp * N + lane;
  s.mk = reinterpret_cast<unsigned*>(sm + (size_t)qb * N) + warp * s.n;
  float* stage = sm + (size_t)qb * (N + s.n);
  const float* q = qrow != nullptr ? qrow : G + (size_t)i * Cg;
  const float qq = SQ[i];
  for (int j0 = 0; j0 < N; j0 += SR_TJ) {
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    for (int c0 = 0; c0 < Cg; c0 += SR_CC) {
      __syncthreads();  // every warp is done with the previous pass
      for (int e = threadIdx.x; e < SR_TJ * SR_CC; e += blockDim.x) {
        const int j = e / SR_CC, c = e - j * SR_CC;
        const bool in = j0 + j < N && c0 + c < Cg;
        async_copy4(stage + j * SR_CS + c,
                    in ? G + (size_t)(j0 + j) * Cg + c0 + c : G, in);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      float qc[SR_CC];
#pragma unroll
      for (int c = 0; c < SR_CC; ++c) qc[c] = c0 + c < Cg ? q[c0 + c] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* r = stage + (32 * u + lane) * SR_CS;
#pragma unroll
        for (int c = 0; c < SR_CC; ++c) acc[u] = fmaf(qc[c], r[c], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + 32 * u + lane;
      if (j < N)
        s.p[j - lane] =
            __fsub_rn(__fsub_rn(__fmul_rn(2.f, acc[u]), qq), SQ[j]);
    }
  }
}

// Scores of query row i against the N points of its cloud: G is the
// cloud's (N, Cg) graph features, SQ its (N,) squared norms, sg the
// block's dynamic shared memory.  Every thread of the block calls it
// (it synchronises the block).  Columns past N score -inf.  qrow, when
// given, holds the query row's own Cg operands in place of G's row i: the
// AMP scores of f32 inputs, [hi | hi | lo] against the cloud's [hi | lo |
// hi] (tiled_topk's GQ, below), so that each score has the tiled route's
// bits.  The shared row (SROW) sets up s on sg (srow_scores).
template <int NPL>
__device__ __forceinline__ void row_scores(const float* __restrict__ G, int Cg,
                                           const float* __restrict__ SQ, int N,
                                           int i, int lane, float* sg,
                                           RowScores<NPL>& s,
                                           const float* __restrict__ qrow =
                                               nullptr) {
  if constexpr (NPL == SROW) {
    srow_scores(G, Cg, SQ, N, i, lane, sg, s, qrow);
  } else if constexpr (NPL > 64) {
    row_scores_async<NPL>(G, Cg, SQ, N, i, lane, sg, s, qrow);
  } else {
    constexpr int CC = Bucket<NPL>::CC, CS = Bucket<NPL>::CS;
#pragma unroll
    for (int t = 0; t < NPL; ++t) s[t] = 0.f;
    for (int c0 = 0; c0 < Cg; c0 += CC) {
      __syncthreads();
      for (int e = threadIdx.x; e < N * CC; e += blockDim.x) {
        const int j = e / CC, c = e - j * CC;
        sg[j * CS + c] = (c0 + c < Cg) ? G[(size_t)j * Cg + c0 + c] : 0.f;
      }
      __syncthreads();
      float q[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c)
        q[c] = query_channel<NPL>(sg, i, qrow, Cg, c0, c);
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const int j = t * 32 + lane;
        if (j < N) {
          const float* r = sg + j * CS;
#pragma unroll
          for (int c = 0; c < CC; ++c) s[t] = fmaf(q[c], r[c], s[t]);
        }
      }
    }
    const float qq = SQ[i];
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const int j = t * 32 + lane;
      s[t] = (j < N) ? __fsub_rn(__fsub_rn(__fmul_rn(2.f, s[t]), qq), SQ[j])
                     : -INFINITY;
    }
  }
}

// One round of the extraction: the column with the highest score, lowest
// index first among equal scores.  Every lane returns it; its score
// becomes -inf.
template <int NPL>
__device__ __forceinline__ int pop_nearest(RowScores<NPL>& s, int lane) {
  // lane-local best; t ascending, so the first maximum has the lowest index
  float best;
  int bj = lane;
  if constexpr (NPL == SROW) {
    best = s.p[0];
    for (int t = 1; t < s.n; ++t) {
      const float v = s.p[32 * t];
      if (v > best) {
        best = v;
        bj = t * 32 + lane;
      }
    }
  } else {
    best = s[0];
#pragma unroll
    for (int t = 1; t < NPL; ++t) {
      if (s[t] > best) {
        best = s[t];
        bj = t * 32 + lane;
      }
    }
  }
  // warp arg-max on (score, -index)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (ob > best || (ob == best && oj < bj)) {
      best = ob;
      bj = oj;
    }
  }
  if constexpr (NPL == SROW) {
    if ((bj & 31) == lane) s.p[bj - lane] = -INFINITY;
  } else {
#pragma unroll
    for (int t = 0; t < NPL; ++t)
      if (t * 32 + lane == bj) s[t] = -INFINITY;
  }
  return bj;
}

// The row-warp forms of the keyed (v2) and class (v3) selections, the
// tiled route's TS_MIN + TS_KEYS and TS_CLASSES (below) on a warp's row of
// scores (registers or the shared row).  Both take the scores of
// row_scores (the exact f32 scores, or the AMP ones through qrow), so each
// form gives the tiled route's neighbours, in its order, at any k <= N.

// Calls f(v) on each of this lane's slots of a row in ascending order; f
// may assign to v.
template <int NPL, typename F>
__device__ __forceinline__ void row_slots(RowScores<NPL>& s, F&& f) {
  if constexpr (NPL == SROW) {
    for (int t = 0; t < s.n; ++t) f(s.p[32 * t]);
  } else {
#pragma unroll
    for (int t = 0; t < NPL; ++t) f(s[t]);
  }
}

// v2: each score of the row becomes its key's quantized part in its own
// slot, q = max(rint(s * scale), -lim), with scale = -lim / m where the
// row's least score m (a warp min over its candidates; the -inf past them
// is skipped) is negative, 0 otherwise: TS_MIN's grid and TS_KEYS's
// operations.  q is an integer below 2^24 in magnitude, exact in f32, so
// pop_nearest's order on the keys, (q desc, index asc), is the packed
// keys' order (_pack_keys: q * 2^b + n - 1 - j).
template <int NPL>
__device__ __forceinline__ void row_keys(RowScores<NPL>& s, float lim) {
  float m = INFINITY;
  row_slots<NPL>(s, [&](float& v) {
    if (v > -INFINITY) m = fminf(m, v);
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = m < 0.f ? __fdiv_rn(-lim, m) : 0.f;
  row_slots<NPL>(s, [&](float& v) {
    if (v > -INFINITY) v = fmaxf(rintf(__fmul_rn(v, scale)), -lim);
  });
}

// The ballots of a row's columns, one word a register slot t: lane t % 32
// of word t / 32 holds the lanes (columns 32 t + lane) that a test took.
template <int NPL>
struct RowMask {
  static constexpr int W = (NPL + 31) / 32;
  unsigned w[W];
};
// The shared row's: its ballots in shared memory, a word a slot.
template <>
struct RowMask<SROW> {
  const unsigned* w;
  int n;
};

// v3: one round of the class walk (_extract_loop_v3).  The row's largest
// remaining score v (a warp max: the next class), its members (the columns
// that score v) retired to -inf and their ballots left in mk, the count of
// members in cnt (on every lane).  v is -inf once the row has no class
// left: fewer than k distinct scores, where the walk consumes its last
// class again, which the max and min it feeds ignore.
template <int NPL>
__device__ __forceinline__ float pop_class(RowScores<NPL>& s, int lane,
                                           RowMask<NPL>& mk, int& cnt) {
  float v;
  if constexpr (NPL == SROW) {
    v = s.p[0];
    for (int t = 1; t < s.n; ++t) v = fmaxf(v, s.p[32 * t]);
  } else {
    v = s[0];
#pragma unroll
    for (int t = 1; t < NPL; ++t) v = fmaxf(v, s[t]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  cnt = 0;
  if constexpr (NPL == SROW) {
    __syncwarp();  // every lane is done with the last class's ballots
    for (int t = 0; t < s.n; ++t) {
      const bool in = s.p[32 * t] == v && v > -INFINITY;
      const unsigned b = __ballot_sync(0xffffffffu, in);
      if (lane == 0) s.mk[t] = b;
      cnt += __popc(b);
      if (in) s.p[32 * t] = -INFINITY;
    }
    __syncwarp();
    mk.w = s.mk;
    mk.n = s.n;
  } else {
#pragma unroll
    for (int q = 0; q < RowMask<NPL>::W; ++q) mk.w[q] = 0u;
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const bool in = s[t] == v && v > -INFINITY;
      const unsigned b = __ballot_sync(0xffffffffu, in);
      if (lane == (t & 31)) mk.w[t >> 5] = b;
      cnt += __popc(b);
      if (in) s[t] = -INFINITY;
    }
  }
  return v;
}

// Calls f(j) for each column j of the ballots mk in ascending order, every
// lane with the same j (the sum order of a class's mean: members ascending
// from zero, as the tiled route's e2t_class_means and the v3 fold sum).
template <int NPL, typename F>
__device__ __forceinline__ void class_members(const RowMask<NPL>& mk,
                                              F&& f) {
  if constexpr (NPL == SROW) {
    for (int t = 0; t < mk.n; ++t) {
      unsigned m = mk.w[t];
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        f(32 * t + src);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < RowMask<NPL>::W; ++q) {
      unsigned slots = __ballot_sync(0xffffffffu, mk.w[q] != 0u);
      while (slots) {
        const int l = __ffs(slots) - 1;  // register slot t = 32 q + l
        slots &= slots - 1;
        unsigned m = __shfl_sync(0xffffffffu, mk.w[q], l);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          f(32 * (32 * q + l) + src);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// The tiled selection (knn_idx.cu, knn_sum.cu, knn_reduce.cu,
// edge_conv_eval.cu and knn_edge2.cu at k <= TS_LIST; knn_edge2.cu also
// needs C1 <= 64 and C2 <= 128).  A
// block of TS_THREADS threads owns TS_R query rows of one cloud and
// streams the cloud past them in column tiles of TS_J, ascending.  Each
// tile's scores are one register-blocked product: thread (ty, tx) of 16
// x 16 holds rows 4 ty + i and columns 4 tx + j, 64 + 4 tx + j (i, j < 4), and the
// channels come through shared memory TS_C at a time, copied by cp.async
// into one buffer while the other is read (k-major, so that a float4 read
// gives four rows or four columns and one staged value feeds four FMAs).
// Each score is the fmaf chain of row_scores over the channels, 0
// ascending, finished by the same _rn operations, so it has row_scores'
// bits.  A finished tile goes to shared memory, and warp w keeps the
// running top-k of rows 8 w .. 8 w + 7 in registers: position p of a row's
// list, sorted by (score desc, index asc), is slot p / 32 of lane p % 32.
// The first tile's 128 columns are sorted into each list (a bitonic
// network on (score desc, index asc)); after it a column enters only with
// a score strictly greater than the k-th, after every entry whose score is
// >= its own, and columns arrive in ascending order, so among equal scores
// the lowest index stays first: torch.topk's order, as pop_nearest gives
// it.  No scores stay in registers between
// tiles, so the block's registers do not grow with N.
//
// The candidates are the W rows [start, start + W) of the cloud: start = 0
// and W = N for the exact kernels, the window of the block's query tile
// for the banded ones (whose 64 query rows always lie in one tile, since a
// tile is a multiple of 128 rows); the lists hold rows of the cloud (start
// + window position).  The exact kernels stream the column tiles in
// ascending order, as above.  The banded kernels (ANY) stream first the
// column tile that holds the block's own query rows, then the others in
// ascending order: their clouds are in PC1 order, so a window's ascending
// stream reaches a row's near neighbours late and its list improves a
// little with every tile, while the query rows' own tile holds most of
// them, and after it few columns enter.  Out of order, a column may meet
// an equal score of a higher row in the list, so ANY admits and places a
// column by (score desc, row asc), the list order itself: the list is the
// first k of all the window's columns in that order whatever order they
// come in, the same bits as the ascending stream.
constexpr int TS_THREADS = 256;
constexpr int TS_R = 64;                // query rows a block
constexpr int TS_J = 128;               // columns a tile
constexpr int TS_C = 32;                // channels a staged chunk
constexpr int TS_LIST = 64;             // the longest list: k <= 64
constexpr int TS_WR = TS_R / (TS_THREADS / 32);  // list rows a warp (8)
constexpr int TS_LDQ = TS_R + 4;        // k-major strides of the chunks
constexpr int TS_LDG = TS_J + 4;
constexpr int TS_SMEM_FLOATS =
    TS_R * TS_J + 2 * TS_C * TS_LDQ + 2 * TS_C * TS_LDG;
constexpr size_t TS_SMEM_BYTES = sizeof(float) * TS_SMEM_FLOATS;

__device__ __forceinline__ float4 ts_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Starts the copies of channels [c0, c0 + nch) of the block's query rows
// r0.. of Q (into qb, k-major) and of the tile's columns, rows j0.. of the
// cloud G (into gb), nch = min(TS_C, Cg - c0); columns at or past row `end`
// are zero-filled.  The product reads no channel past nch.  Q is G but for
// the AMP scores of f32 inputs (the modes below tiled_topk's note).
__device__ __forceinline__ void ts_load_chunk(const float* __restrict__ G,
                                              const float* __restrict__ Q,
                                              int Cg, int end, int r0, int j0,
                                              int c0, float* qb, float* gb) {
  const int nch = min(TS_C, Cg - c0);
  auto copy = [&](int e, int rows, int ld, int row0, bool bound) {
    const int r = nch == TS_C ? e / TS_C : e / nch;
    const int c = e - r * nch;
    const bool in = !bound || row0 + r < end;
    const float* src = rows == TS_R ? Q : G;
    async_copy4((rows == TS_R ? qb : gb) + c * ld + r,
                in ? src + (size_t)(row0 + r) * Cg + c0 + c : src, in);
  };
  for (int e = threadIdx.x; e < TS_R * nch; e += TS_THREADS)
    copy(e, TS_R, TS_LDQ, r0, false);
  for (int e = threadIdx.x; e < TS_J * nch; e += TS_THREADS)
    copy(e, TS_J, TS_LDG, j0, true);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The tensor-core score tile (tiled_topk's OP = __nv_bfloat16: kernels 3
// and 4 in the AMP mode).  The operands are bf16, Cg channels a row with
// Cg a multiple of 16 (zeros past the function's own): for the AMP
// scores of f32 inputs [hi | hi | lo | 0..] against [hi | lo | hi | 0..],
// so that one product gives hi.hi + hi.lo + lo.hi.  Each tile's 64 x 128
// scores are bf16 mma.sync m16n8k16 with f32 accumulators: warp w takes
// rows 16 (w % 4) .. + 15 and columns 64 (w / 4) .. + 63, eight n-tiles;
// the channels come TC_KC at a time through shared memory by cp.async (16
// bytes a copy) in two buffers, read by ldmatrix.  A bf16 x bf16 product
// is exact in f32; only the order of the f32 sums and the tensor core's
// truncating adds differ from the f32 chain, as on the TPU's MXU.  The
// finished tile's rows are TC_LST floats apart (no bank conflicts on the
// accumulators' stores); the walks over it are the f32 route's.
constexpr int TC_KC = 64;             // bf16 channels a staged chunk
constexpr int TC_LD = TC_KC + 8;      // row stride (bf16) of the chunks
constexpr int TC_LST = TS_J + 4;      // row stride (floats) of the tile
constexpr size_t TC_SMEM_BYTES =
    sizeof(float) * TS_R * TC_LST +
    sizeof(__nv_bfloat16) * 2 * (TS_R + TS_J) * TC_LD;

// Starts the copies of channels [c0, c0 + nch) (nch = min(TC_KC, Cg -
// c0), a multiple of 8) of the query rows r0.. of Q into qb and of the
// tile's columns, rows j0.. of G, into gb (rows TC_LD apart); columns at
// or past row `end` are zero-filled.
__device__ __forceinline__ void tc_load_chunk(
    const __nv_bfloat16* __restrict__ G, const __nv_bfloat16* __restrict__ Q,
    int Cg, int end, int r0, int j0, int c0, __nv_bfloat16* qb,
    __nv_bfloat16* gb) {
  const int per = min(TC_KC, Cg - c0) / 8;  // 16-byte copies a row
  for (int e = threadIdx.x; e < (TS_R + TS_J) * per; e += TS_THREADS) {
    const int r = e / per, c = 8 * (e - r * per);
    const bool qrow = r < TS_R;
    const int row = qrow ? r0 + r : j0 + r - TS_R;
    const bool in = qrow || row < end;
    const __nv_bfloat16* src = qrow ? Q : G;
    dg_bf16::copy16((qrow ? qb + r * TC_LD : gb + (r - TS_R) * TC_LD) + c,
                    in ? src + (size_t)row * Cg + c0 + c : src, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// (a, ai) comes before (b, bi) in a list: a higher score, or the same
// score and a lower index.
__device__ __forceinline__ bool ts_before(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// Sorts the 128 entries (v[u], ix[u]) of a warp, element e = lane + 32 u,
// into list order (ts_before) by a bitonic network: the first tile's fill
// of a row's list in 28 compare-exchange stages instead of one insertion
// a column.
__device__ __forceinline__ void ts_sort128(float (&v)[4], int (&ix)[4],
                                           int lane) {
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32) {  // the partner is in this lane: slot u ^ (j / 32)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = u ^ (j >> 5);
          if (w < u) continue;
          // in a block of `size` whose bit is clear the lower element
          // takes the earlier entry
          const bool up = ((lane + 32 * u) & size) == 0;
          if (ts_before(v[w], ix[w], v[u], ix[u]) == up) {
            const float tv = v[u];
            const int ti = ix[u];
            v[u] = v[w];
            ix[u] = ix[w];
            v[w] = tv;
            ix[w] = ti;
          }
        }
      } else {  // the partner is lane ^ j, same slot
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float ov = __shfl_xor_sync(0xffffffffu, v[u], j);
          const int oi = __shfl_xor_sync(0xffffffffu, ix[u], j);
          const bool up = ((lane + 32 * u) & size) == 0;
          const bool lower = (lane & j) == 0;
          const bool other_first = ts_before(ov, oi, v[u], ix[u]);
          if (lower == up ? other_first : !other_first) {
            v[u] = ov;
            ix[u] = oi;
          }
        }
      }
    }
  }
}

// Inserts the column (s, j) into a warp's full sorted list of k entries
// (every lane passes the same s and j): after the entries whose score is
// >= s (ANY: the entries before (s, j) in list order), the k-th dropping
// out.
template <int KL, bool ANY = false>
__device__ __forceinline__ void ts_insert(float (&ls)[KL], int (&li)[KL],
                                          int k, float s, int j, int lane) {
  int pos = 0;
#pragma unroll
  for (int q = 0; q < KL; ++q)
    pos += __popc(__ballot_sync(
        0xffffffffu, lane + 32 * q < k &&
                         (ANY ? ts_before(ls[q], li[q], s, j) : ls[q] >= s)));
  float us[KL];
  int ui[KL];
#pragma unroll
  for (int q = 0; q < KL; ++q) {
    us[q] = __shfl_up_sync(0xffffffffu, ls[q], 1);
    ui[q] = __shfl_up_sync(0xffffffffu, li[q], 1);
  }
#pragma unroll
  for (int q = 1; q < KL; ++q) {  // slot q's lane 0 follows slot q-1's 31
    const float cs = __shfl_sync(0xffffffffu, ls[q - 1], 31);
    const int ci = __shfl_sync(0xffffffffu, li[q - 1], 31);
    if (lane == 0) {
      us[q] = cs;
      ui[q] = ci;
    }
  }
#pragma unroll
  for (int q = 0; q < KL; ++q) {
    const int p = lane + 32 * q;
    if (p > pos) {
      ls[q] = us[q];
      li[q] = ui[q];
    } else if (p == pos) {
      ls[q] = s;
      li[q] = j;
    }
  }
}

// The k-th entry of a full list (its score, or its row), on every lane.
template <int KL, typename T>
__device__ __forceinline__ T ts_kth(const T (&ls)[KL], int k) {
  T v = __shfl_sync(0xffffffffu, ls[0], (k - 1) & 31);
#pragma unroll
  for (int q = 1; q < KL; ++q) {
    const T w = __shfl_sync(0xffffffffu, ls[q], (k - 1) & 31);
    if ((k - 1) >> 5 == q) v = w;
  }
  return v;
}

// The k <= 32 * KL nearest of the candidate rows [start, start + W) (W >=
// TS_J) for query rows r0 .. r0 + TS_R - 1 of a cloud: G its graph
// features (Cg channels a row), SQ its squared norms, sm the block's
// TS_SMEM_BYTES of dynamic shared memory.  Every thread of the block calls
// it; on return warp w holds in (ls, li)[rr] the sorted list of row r0 +
// TS_WR * w + rr, k >= 1 entries, k <= W, as rows of the cloud.  ANY: the
// query rows lie in the window, and the tile that holds them streams
// first (see above).
//
// MODE picks what the stream makes of the scores; TS_TOPK is the above.
// The other three are the selections v2 and v3 of the eval kernels 1, 6,
// 12 and 13 (dgcnn_tpu/ops/pallas_knn.py, _extract_loop_v2 / v3), on the
// whole cloud or (ANY) a window.  Their query rows come from GQ (rows of
// the cloud, Cg channels, like G): for the AMP scores of f32 inputs, three
// bf16 products, hi.hi + hi.lo + lo.hi, which the one product here gives
// as the chain over GQ = [hi | hi | lo] against G = [hi | lo | hi] (3 Cg
// channels).  GQ = G for bf16 inputs and for the exact scores (the exact
// v2 of the semseg CLI's pin).
//   TS_MIN      no list: rrow[r] = the least score of row r (the v2
//               keys' grid).
//   TS_KEYS     v2: each score becomes its key's quantized part, q =
//               max(rint(s * scale_r), -lim) with scale_r = -lim /
//               rrow[r] where rrow[r] < 0 (0 otherwise); q is an integer
//               below 2^24 in magnitude, exact in f32, so the list's
//               order (q desc, index asc) is the order of the packed keys
//               (q * 2^b + n - 1 - j, b the index bits).
//   TS_CLASSES  v3: the list holds the k largest DISTINCT scores of the
//               row, -inf in the slots past them, li[.] = (the count of
//               columns with that score) << 16 | (the lowest of them,
//               less `start`: its position in the window, so that a
//               window of a cloud above 65536 points fits the field;
//               class_low, and the consumers add start back), the count
//               read unsigned (class_count: 32768 members of one class
//               set the sign bit).
//               Every tile inserts: a column whose score is in the list
//               adds one to its count (ANY: and lowers its lowest member
//               if it is lower, since tiles come out of order); one that
//               is larger than the k-th distinct score (or the list is not
//               full) enters with count 1 and the k-th drops out.  The
//               list holds the same classes in any tile order: a class of
//               the final list is larger than the k-th of every earlier
//               list, so its first member enters and none is dropped.
// Over a window the v2 grid is the row's least score over the window, and
// the keys' index bits those of the band (the caller's lim).
// No buffer or register grows with W, and the v3 list's words hold a count
// up to 2^15 (unsigned) and a window position below 2^15: the route takes
// any W <= MAX_N (at 32768 the v2 keys hold 15 index bits and |q| <= lim =
// 2^16 - 1, exact in f32), over a cloud of any size (ANY: the banded
// kernels 12 and 13 take any N, their window W <= MAX_N; li's rows and
// ts_before's comparisons are ints of the cloud).
constexpr int TS_TOPK = 0, TS_KEYS = 1, TS_MIN = 2, TS_CLASSES = 3;

// A TS_CLASSES list word's member count and lowest member (its position
// in the candidates: add their first row, tiled_topk's `start`).
__device__ __forceinline__ int class_count(int w) {
  return (int)((unsigned)w >> 16);
}
__device__ __forceinline__ int class_low(int w) { return w & 0xffff; }

// OP: the operands' type; __nv_bfloat16 takes each tile's scores from the
// tensor cores (TC_KC above; Cg a multiple of 16, sm TC_SMEM_BYTES).
template <int KL, bool ANY = false, int MODE = TS_TOPK, typename OP = float>
__device__ __forceinline__ void tiled_topk(const OP* __restrict__ G,
                                           int Cg,
                                           const float* __restrict__ SQ,
                                           int start, int W, int r0, int k,
                                           float* sm,
                                           float (&ls)[TS_WR][KL],
                                           int (&li)[TS_WR][KL],
                                           const OP* __restrict__ GQ =
                                               nullptr,
                                           float* __restrict__ rrow = nullptr,
                                           float lim = 0.f) {
  constexpr bool TC = std::is_same_v<OP, __nv_bfloat16>;
  constexpr int LST = TC ? TC_LST : TS_J;  // the finished tile's row stride
  float* st = sm;                        // finished tile (TS_R, TS_J)
  float* qbuf = st + TS_R * TS_J;        // two query chunks
  float* gbuf = qbuf + 2 * TS_C * TS_LDQ;  // two column chunks
  __nv_bfloat16* tq = reinterpret_cast<__nv_bfloat16*>(st + TS_R * LST);
  __nv_bfloat16* tg = tq + 2 * TS_R * TC_LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (Cg + (TC ? TC_KC : TS_C) - 1) / (TC ? TC_KC : TS_C);
  const int tiles = (W + TS_J - 1) / TS_J;
  const int end = start + W;
  // the column tile of the t-th step: ANY, the query rows' tile, then the
  // others ascending
  const int first = ANY ? (r0 - start) / TS_J : 0;
  auto tile_at = [&](int t) {
    return ANY ? (t == 0 ? first : t - (t <= first)) : t;
  };
  const int steps = tiles * chunks;
  const OP* Q = MODE == TS_TOPK ? G : GQ;
  // the thread's rows: 4 ty + i (f32), or (TC) 16 (warp % 4) + g + 8 i
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = 16 * (warp & 3) + g, ncol = 64 * (warp >> 2) + 2 * t4;
  float qq[4], rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = TC ? mrow + 8 * (i & 1) : 4 * ty + i;
    qq[i] = SQ[r0 + r];
    if constexpr (MODE == TS_KEYS) {  // the row's scale
      const float m = rrow[r0 + r];
      rs[i] = m < 0.f ? __fdiv_rn(-lim, m) : 0.f;
    }
  }
  float rmin[TS_WR];
  if constexpr (MODE == TS_MIN) {
#pragma unroll
    for (int rr = 0; rr < TS_WR; ++rr) rmin[rr] = INFINITY;
  }
  if constexpr (MODE == TS_CLASSES) {
#pragma unroll
    for (int rr = 0; rr < TS_WR; ++rr)
#pragma unroll
      for (int q = 0; q < KL; ++q) {
        ls[rr][q] = -INFINITY;
        li[rr][q] = 0;
      }
  }
  float acc[4][8], sqj[8];
  float tacc[8][4], tsq[16];  // TC: the warp's 16 x 64 accumulators

  auto load_step = [&](int step, int buf) {
    const int tn = step / chunks, cn = step - tn * chunks;
    if constexpr (TC)
      tc_load_chunk(G, Q, Cg, end, r0, start + tile_at(tn) * TS_J,
                    cn * TC_KC, tq + buf * TS_R * TC_LD,
                    tg + buf * TS_J * TC_LD);
    else
      ts_load_chunk(G, Q, Cg, end, r0, start + tile_at(tn) * TS_J,
                    cn * TS_C, qbuf + buf * TS_C * TS_LDQ,
                    gbuf + buf * TS_C * TS_LDG);
  };
  load_step(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int t = s / chunks, c = s - t * chunks;
    const int j0 = tile_at(t) * TS_J;
    if (c == 0) {
      if constexpr (TC) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = j0 + ncol + 8 * (j >> 1) + (j & 1);
          tsq[j] = col < W ? SQ[start + col] : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j0 + 4 * tx + (j & 3) + 64 * (j >> 2);
          sqj[j] = col < W ? SQ[start + col] : 0.f;
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // step s has landed for every thread, and every thread is done with
    // step s - 1, whose buffers the next copy fills
    __syncthreads();
    if (s + 1 < steps) load_step(s + 1, (s + 1) & 1);
    if constexpr (TC) {
      // the chunk's k16 steps: A the warp's 16 query rows, B its 64
      // columns (ldmatrix as attention_bf16.cuh's tile_scores)
      const __nv_bfloat16* qa = tq + (s & 1) * TS_R * TC_LD +
                                (16 * (warp & 3) + (lane & 7) +
                                 8 * ((lane >> 3) & 1)) * TC_LD +
                                8 * (lane >> 4);
      const __nv_bfloat16* gb = tg + (s & 1) * TS_J * TC_LD +
                                (64 * (warp >> 2) + (lane & 7) +
                                 8 * (lane >> 4)) * TC_LD +
                                8 * ((lane >> 3) & 1);
      const int nk = min(TC_KC, Cg - c * TC_KC) / 16;
#pragma unroll
      for (int kk = 0; kk < TC_KC / 16; ++kk) {
        if (kk < nk) {
          unsigned a[4];
          dg_bf16::ldsm_x4(a, qa + 16 * kk);
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            unsigned b[4];
            dg_bf16::ldsm_x4(b, gb + 8 * j * TC_LD + 16 * kk);
            dg_bf16::mma(tacc[j], a, b[0], b[1]);
            dg_bf16::mma(tacc[j + 1], a, b[2], b[3]);
          }
        }
      }
      if (c + 1 < chunks) continue;
      // the tile is done: finish its scores into st (rows mrow, mrow + 8;
      // columns ncol + 8 j, + 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = j0 + ncol + 8 * j + cc;
            v[cc] = col < W
                        ? __fsub_rn(__fsub_rn(__fmul_rn(2.f,
                                                        tacc[j][2 * h + cc]),
                                              qq[h]),
                                    tsq[2 * j + cc])
                        : (MODE == TS_MIN ? INFINITY : -INFINITY);
            if constexpr (MODE == TS_KEYS)
              if (col < W) v[cc] = fmaxf(rintf(__fmul_rn(v[cc], rs[h])), -lim);
          }
          *reinterpret_cast<float2*>(st + (mrow + 8 * h) * LST + ncol +
                                     8 * j) = make_float2(v[0], v[1]);
        }
    } else {
    const float* qs = qbuf + (s & 1) * TS_C * TS_LDQ + 4 * ty;
    const float* gs = gbuf + (s & 1) * TS_C * TS_LDG + 4 * tx;
    const int nc = min(TS_C, Cg - c * TS_C);
    auto fma_channel = [&](int cc) {
      const float4 q = ts_ld4(qs + cc * TS_LDQ);
      const float4 g0 = ts_ld4(gs + cc * TS_LDG);
      const float4 g1 = ts_ld4(gs + cc * TS_LDG + 64);
      const float qv[4] = {q.x, q.y, q.z, q.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], gv[j], acc[i][j]);
    };
    if (nc == TS_C) {
#pragma unroll
      for (int cc = 0; cc < TS_C; ++cc) fma_channel(cc);
    } else {
      for (int cc = 0; cc < nc; ++cc) fma_channel(cc);
    }
    if (c + 1 < chunks) continue;

    // the tile is done: finish its scores into st
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * h + jj;
          const int col = j0 + 4 * tx + jj + 64 * h;
          v[jj] = col < W ? __fsub_rn(__fsub_rn(__fmul_rn(2.f, acc[i][j]),
                                                qq[i]), sqj[j])
                          : (MODE == TS_MIN ? INFINITY : -INFINITY);
          if constexpr (MODE == TS_KEYS)
            if (col < W) v[jj] = fmaxf(rintf(__fmul_rn(v[jj], rs[i])), -lim);
        }
        *reinterpret_cast<float4*>(st + (4 * ty + i) * LST + 4 * tx +
                                   64 * h) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      }
    }
    }  // the f32 product
    __syncthreads();
    // each warp walks its rows' scores in ascending column order; the next
    // step's barrier keeps st until every warp is done
    if constexpr (MODE == TS_MIN) {  // the rows' running minima
#pragma unroll
      for (int rr = 0; rr < TS_WR; ++rr) {
        const float* srow = st + (TS_WR * warp + rr) * LST;
        float m = fminf(fminf(srow[lane], srow[32 + lane]),
                        fminf(srow[64 + lane], srow[96 + lane]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
        rmin[rr] = fminf(rmin[rr], m);
      }
      continue;
    }
    if constexpr (MODE == TS_CLASSES) {  // every tile inserts
#pragma unroll
      for (int rr = 0; rr < TS_WR; ++rr) {
        const float* srow = st + (TS_WR * warp + rr) * LST;
        float thr = ts_kth<KL>(ls[rr], k);
#pragma unroll 1
        for (int u = 0; u < TS_J / 32; ++u) {
          const float sc = srow[32 * u + lane];
          const int j = start + j0 + 32 * u;
          unsigned m = __ballot_sync(0xffffffffu,
                                     sc >= thr && sc > -INFINITY);
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float v = __shfl_sync(0xffffffffu, sc, src);
            bool found = false;
#pragma unroll
            for (int q = 0; q < KL; ++q) {
              const bool here = lane + 32 * q < k && ls[rr][q] == v;
              found |= __any_sync(0xffffffffu, here);
              if (here) {
                li[rr][q] = (int)((unsigned)li[rr][q] + (1u << 16));
                if (ANY && (li[rr][q] & 0xffff) > j + src - start)
                  li[rr][q] = (li[rr][q] & ~0xffff) | (j + src - start);
              }
            }
            if (!found && v > thr) {
              ts_insert<KL>(ls[rr], li[rr], k, v,
                            (1 << 16) | (j + src - start), lane);
              thr = ts_kth<KL>(ls[rr], k);
            }
          }
        }
      }
      continue;
    }
    if (t == 0) {  // the first tile (W >= TS_J >= k) fills the lists
      // one copy of the sorting network, rolled over the rows: each row's
      // best 64 go back to its row of st, scores then index bits
#pragma unroll 1
      for (int rr = 0; rr < TS_WR; ++rr) {
        float* srow = st + (TS_WR * warp + rr) * LST;
        float v[4];
        int ix[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = srow[32 * u + lane];
          ix[u] = start + (ANY ? j0 : 0) + 32 * u + lane;
        }
        ts_sort128(v, ix, lane);
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          srow[32 * u + lane] = v[u];
          srow[64 + 32 * u + lane] = __int_as_float(ix[u]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < TS_WR; ++rr) {
        const float* srow = st + (TS_WR * warp + rr) * LST;
#pragma unroll
        for (int q = 0; q < KL; ++q) {
          ls[rr][q] = srow[32 * q + lane];
          li[rr][q] = __float_as_int(srow[64 + 32 * q + lane]);
        }
      }
      continue;
    }
#pragma unroll
    for (int rr = 0; rr < TS_WR; ++rr) {
      const float* srow = st + (TS_WR * warp + rr) * LST;
      float thr = ts_kth<KL>(ls[rr], k);
      int thi = ANY ? ts_kth<KL>(li[rr], k) : 0;  // the k-th entry's row
#pragma unroll
      for (int u = 0; u < TS_J / 32; ++u) {
        const float sc = srow[32 * u + lane];
        const int j = start + j0 + 32 * u;
        unsigned m = __ballot_sync(
            0xffffffffu, ANY ? ts_before(sc, j + lane, thr, thi) : sc > thr);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(0xffffffffu, sc, src);
          if (ANY ? ts_before(v, j + src, thr, thi) : v > thr) {
            ts_insert<KL, ANY>(ls[rr], li[rr], k, v, j + src, lane);
            thr = ts_kth<KL>(ls[rr], k);
            if (ANY) thi = ts_kth<KL>(li[rr], k);
          }
        }
      }
    }
  }
  if constexpr (MODE == TS_MIN) {
    if (lane == 0)
#pragma unroll
      for (int rr = 0; rr < TS_WR; ++rr)
        rrow[r0 + TS_WR * warp + rr] = rmin[rr];
  }
}

// An output element of the f32 forms, or of the AMP forms rounded to bf16
// (to nearest even).
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Calls f(std::integral_constant<int, NPL>{}) for the row route over N
// candidates: the smallest register bucket NPL (4, 8, 16, 32, 48, 64, 96
// or 128) that holds N / 32 scores a lane, or the shared row (SROW) where
// N > REG_MAX_N, where the bucket's lanes hold fewer output channels than
// co needs (max_co; co = 0 where a kernel's channels a lane do not follow
// the bucket) or where force_srow() asks for it.  N > MAX_N: no route.
template <typename F>
cudaError_t with_npl(int N, int co, F&& f) {
  if (N > MAX_N) return cudaErrorInvalidValue;
  if (N > REG_MAX_N || co > max_co(N) || force_srow()) {
    ++srow_launches();
    return f(std::integral_constant<int, SROW>{});
  }
  const int npl = N / 32;
  if (npl <= 4) return f(std::integral_constant<int, 4>{});
  if (npl <= 8) return f(std::integral_constant<int, 8>{});
  if (npl <= 16) return f(std::integral_constant<int, 16>{});
  if (npl <= 32) return f(std::integral_constant<int, 32>{});
  if (npl <= 48) return f(std::integral_constant<int, 48>{});
  if (npl <= 64) return f(std::integral_constant<int, 64>{});
  if (npl <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// Launches on `st`; each returns the launch error.  out[r] = |g_r|^2 for
// the rows of a (rows, C) matrix (edge_conv_eval.cu):
cudaError_t launch_sqnorm(const float* g, int rows, int C, float* out,
                          cudaStream_t st);
// out (M, ncols) = x (M, K) @ w (K, ncols) in f32 (project.cu).  Each
// output element's sum runs over K in one fixed order whatever M and
// ncols are, so two calls on the same rows give the same bits:
cudaError_t launch_project(const float* x, int M, int K, const float* w,
                           int ncols, float* out, cudaStream_t st);
// The score operands of the AMP mode (edge_conv_eval.cu): a bf16 graph
// (BF16) as f32 into gc, or an f32 graph's [hi | hi | lo] into gq and [hi |
// lo | hi] into gc (3 Cg channels a row):
cudaError_t launch_amp_graph(const void* graph, bool bf16, int rows, int Cg,
                             float* gq, float* gc, cudaStream_t st);
// The v2 grid (TS_MIN): rmin[b * N + r] = the least score of row r over
// the whole cloud (starts null, W = N) or its query tile's window of W
// rows from starts[r / tile] (edge_conv_eval.cu):
cudaError_t launch_rowmin(const float* gc, const float* gq, int Cs,
                          const float* sq, int B, int N, const int* starts,
                          int tile, int W, float* rmin, cudaStream_t st);
// The quantization limit of the v2 keys of a row of W candidates, 2^(31 -
// b) - 1 with b the index bits of W (_pack_keys):
inline float keys_lim(int W) {
  const int bits = 32 - __builtin_clz((unsigned)(W - 1) | 1u);
  return (float)((1u << (31 - bits)) - 1u);
}

}  // namespace dg
