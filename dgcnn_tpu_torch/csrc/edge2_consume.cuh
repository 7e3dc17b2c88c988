// The tiled consumer of kernel 6 and 13's tiled routes (knn_edge2.cu, the
// exact v1 form) and of their other forms (knn_edge2_variant.cu): a
// block's 64 rows' neighbour lists, as tiled_topk (knn_select.cuh) leaves
// them in registers, through the two-conv block's per-edge math in tiles
// of whole rows (edge2_tile.cuh), then each row's max.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "edge2.cuh"
#include "edge2_tile.cuh"
#include "knn_select.cuh"

namespace dg {
namespace e2c {

using dg::comp;
using dg::ld4;
constexpr int XE = dg::E2T_EDGES;  // edge slots a tile
constexpr int XR = dg::E2T_ROWS;   // the most rows a tile
constexpr int XC1 = dg::E2T_C1;    // C1 <= XC1: the row stride of h1
static_assert(dg::TS_THREADS == dg::E2T_THREADS,
              "the consumer stages h1 and z2 with edge2_tile.cuh's block");
constexpr int XC2 = 128;  // C2 <= XC2
constexpr int XP = 64;    // second-conv channels a pass: the row stride of y
constexpr size_t XSMEM_CONSUME =
    sizeof(float) * (XE * XC1 + XE * XP + XC1 * XC2 + 2 * XC1 + 2 * XC2) +
    sizeof(int) * (4 * XE + XR);
constexpr size_t XSMEM_SELECT = dg::TS_SMEM_BYTES > dg::TC_SMEM_BYTES
                                    ? dg::TS_SMEM_BYTES
                                    : dg::TC_SMEM_BYTES;
constexpr size_t XSMEM_BYTES =
    XSMEM_CONSUME > XSMEM_SELECT ? XSMEM_CONSUME : XSMEM_SELECT;

// The score operands of the v3 form's second scoring of a row: the
// cloud's gc / gq rows (Cs channels of OP: f32, or the tensor-core forms'
// bf16) and squared norms (the batch's from blockIdx.y), N points, and the
// candidates: the cloud (starts null, W = N) or the W rows from starts[i
// / tile].
template <typename OP = float>
struct ScoreOperands {
  const OP *gc, *gq;
  const float* sq;
  const int* starts;
  int N, Cs, tile, W;
};

inline bool tiled_route(int C1, int C2, int k) {
  return k <= dg::TS_LIST && C1 <= XC1 && C2 <= XC2;
}

// The tied classes of the tile's row r (v3: slots r k .. r k + k - 1
// whose count is above 1; jrow holds -2 - their lowest member) of query
// row i: each class's members' a1 rows (A, C1 <= 64 channels) summed in
// ascending row order from zero and divided by the count, into the
// class's slot of hb (lanes over channels lane and lane + 32).  A class's
// score is its lowest member's, and its members are the candidate rows
// of row i (so) that score the same: each score is the tile's over gq's
// row i against gc's (Cs channels; knn_select.cuh's lane_score: the fmaf
// chain, or the tile's mma.sync k16 steps) finished by its _rn
// operations, the selection's bits.  One warp a row; rows without a tied
// class return at once.
template <typename OP>
__device__ __forceinline__ void e2t_class_means(
    float* hb, const int* jrow, const int* ecnt, float* evl, int r, int k,
    int i, const float* __restrict__ A, int C1, const ScoreOperands<OP>& so,
    int lane) {
  const int* cnt = ecnt + r * k;
  float* val = evl + r * k;
  bool tied = false;
  for (int t = lane; t < k; t += 32) tied |= cnt[t] > 1;
  if (!__any_sync(0xffffffffu, tied)) return;
  // the cloud's operands and the row's candidates
  const int b = blockIdx.y, Cs = so.Cs;
  const OP* G = so.gc + (size_t)b * so.N * Cs;
  const OP* GQ = so.gq + (size_t)b * so.N * Cs;
  const float* SQ = so.sq + (size_t)b * so.N;
  const int start = so.starts ? so.starts[i / so.tile] : 0;
  const int end = start + so.W;
  const OP* qrow = GQ + (size_t)i * Cs;
  const float qq = SQ[i];
  // every lane scores (the tensor-core form's is the warp's product)
  auto score = [&](int j) {
    return dg::lane_score<OP>(qrow, G, Cs, SQ, qq, j, lane);
  };
  for (int t0 = 0; t0 < k; t0 += 32) {
    const int t = t0 + lane;
    const bool tied = t < k && cnt[t] > 1;
    const float s = score(tied ? -2 - jrow[r * k + t] : start);
    if (tied) val[t] = s;
  }
  for (int t = 0; t < k; ++t)
    if (cnt[t] > 1) {
      hb[(r * k + t) * XC1 + lane] = 0.f;
      hb[(r * k + t) * XC1 + 32 + lane] = 0.f;
    }
  __syncwarp();
  for (int j0 = start; j0 < end; j0 += 32) {
    const float sc = score(j0 + lane);
    int slot = -1;
    for (int t = 0; t < k; ++t)
      if (cnt[t] > 1 && val[t] == sc) slot = t;
    unsigned m = __ballot_sync(0xffffffffu, slot >= 0);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int t = __shfl_sync(0xffffffffu, slot, src);
      const float* arow = A + (size_t)(j0 + src) * C1;
      float* h = hb + (r * k + t) * XC1;
      if (lane < C1) h[lane] = __fadd_rn(h[lane], arow[lane]);
      if (lane + 32 < C1) h[lane + 32] = __fadd_rn(h[lane + 32], arow[lane + 32]);
    }
  }
  for (int t = 0; t < k; ++t)
    if (cnt[t] > 1) {
      float* h = hb + (r * k + t) * XC1;
      h[lane] = __fdiv_rn(h[lane], (float)cnt[t]);
      h[lane + 32] = __fdiv_rn(h[lane + 32], (float)cnt[t]);
    }
}

// The tiled consumer of the block's 64 rows r0.. (their lists in the
// warps' registers, li as tiled_topk leaves it): their edges in
// tiles of R = min(XR, XE / k) whole rows.  C1 and C2 are padded to
// multiples of 4 in shared memory with zeros, which add nothing to a z2
// chain (a chain that starts at +0 never holds -0).  A and b1b are the
// cloud's a1 and b1 rows, outb its output rows.  V3 (kernel 6's AMP v3):
// the lists hold classes (TS_CLASSES): a class of one member is its a1
// row, a tied class the mean of its members' rows (e2t_class_means over
// the candidates that ``so`` describes), and the slots past a row's
// last class are left out of its max; otherwise the lists hold the
// members.  The class scores are not read from the lists (ls), which
// would keep them in registers through the consumer: e2t_class_means
// scores a tied class's lowest member again.  OUT: float, or bf16 rounded
// from the f32 max (AMP).
template <int KL, bool V3, typename OUT, typename OP>
__device__ __forceinline__ void e2t_consume(
    float* tsm, const int (&li)[dg::TS_WR][KL], const float* __restrict__ A,
    const float* __restrict__ b1b, int C1, const float* __restrict__ w2,
    int C2, const float* __restrict__ s1, const float* __restrict__ t1,
    const float* __restrict__ s2, const float* __restrict__ t2, float slope,
    int r0, int k, OUT* __restrict__ outb, const ScoreOperands<OP>& so) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* hb = tsm;              // h1 of the tile's edges (XE, XC1)
  float* yb = hb + XE * XC1;    // h2 of one pass (XE, XP)
  float* w2s = yb + XE * XP;    // w2 (C1p, ldw)
  float* s1s = w2s + XC1 * XC2;  // s1, t1 (XC1); s2, t2 (XC2)
  float* t1s = s1s + XC1;
  float* s2s = t1s + XC1;
  float* t2s = s2s + XC2;
  int* jrow = reinterpret_cast<int*>(t2s + XC2);  // a1 row of an edge, or -1
  int* eloc = jrow + XE;                          // its row in the tile
  int* ecnt = eloc + XE;  // v3: its class's count (0: no class)
  float* evl = reinterpret_cast<float*>(ecnt + XE);  // v3: a tied class's score
  int* ncls = reinterpret_cast<int*>(evl + XE);  // v3: a tile row's classes
  constexpr bool TC = std::is_same_v<OP, __nv_bfloat16>;
  const int C1p = (C1 + 3) & ~3, ldw = (C2 + 3) & ~3;
  __syncthreads();  // every warp is done with the selection's shared memory
  for (int e = tid; e < C1p * ldw; e += dg::TS_THREADS) {
    const int r = e / ldw, c = e - r * ldw;
    w2s[e] = r < C1 && c < C2 ? w2[r * C2 + c] : 0.f;
  }
  if (tid < XC1) {
    s1s[tid] = tid < C1 ? s1[tid] : 0.f;
    t1s[tid] = tid < C1 ? t1[tid] : 0.f;
  }
  if (tid < XC2) {
    s2s[tid] = tid < C2 ? s2[tid] : 0.f;
    t2s[tid] = tid < C2 ? t2[tid] : 0.f;
  }
  // the candidates' first row (the v3 words hold window positions)
  const int wstart = V3 && so.starts ? so.starts[r0 / so.tile] : 0;
  const int R = dg::e2t_rows(k);
  // the products give thread (tx, ty) edges ty + 16 m and channels 4 tx + i
  const int tx = tid & 15, ty = tid >> 4;

  for (int rt = 0; rt < dg::TS_R; rt += R) {
    const int nr = min(R, dg::TS_R - rt);  // rows r0 + rt .. of this tile
    // each warp writes the lists of its rows that fall in the tile; the
    // previous tile read jrow and eloc before two barriers, and its max
    // read ecnt after them (the tensor-core forms' max reads ncls, written
    // after the next barrier)
    if constexpr (V3 && !TC)
      if (rt > 0) __syncthreads();
    [[maybe_unused]] bool tied = false;  // the tensor-core v3: a tied slot
#pragma unroll
    for (int rr = 0; rr < dg::TS_WR; ++rr) {
      const int r = dg::TS_WR * warp + rr - rt;
      if (r >= 0 && r < nr) {
#pragma unroll
        for (int q = 0; q < KL; ++q) {
          const int t = lane + 32 * q;
          if (t < k) {
            if constexpr (V3) {
              // a singleton: its row; a tied class: -2 - its lowest member
              const int cnt = dg::class_count(li[rr][q]);
              const int low = wstart + dg::class_low(li[rr][q]);
              jrow[r * k + t] = cnt == 1 ? low : (cnt > 1 ? -2 - low : -1);
              ecnt[r * k + t] = cnt;
              if constexpr (TC) tied |= cnt > 1;
            } else {
              jrow[r * k + t] = li[rr][q];
            }
            eloc[r * k + t] = r;
          }
        }
      }
    }
    for (int e = nr * k + tid; e < XE; e += dg::TS_THREADS) jrow[e] = -1;
    // the tensor-core v3 finds a tile's class means only where one of its
    // rows holds a tied class
    bool means = V3;
    if constexpr (V3 && TC)
      means = __syncthreads_or(tied);
    else
      __syncthreads();
    if constexpr (V3) {
      if (warp < nr) {
        if constexpr (TC) {  // the row's classes: its list's present prefix
          int n = 0;
          for (int t0 = 0; t0 < k; t0 += 32)
            n += __popc(__ballot_sync(
                0xffffffffu, t0 + lane < k && ecnt[warp * k + t0 + lane] > 0));
          if (lane == 0) ncls[warp] = n;
        }
        if (means)
          e2t_class_means(hb, jrow, ecnt, evl, warp, k, r0 + rt + warp, A,
                          C1, so, lane);
      }
      if (means) __syncthreads();
    }
    // h1 of every edge (e2_h1_row's operations); empty slots hold zeros
    dg::e2t_stage_h1<V3>(A, b1b + (size_t)(r0 + rt) * C1, C1, jrow, eloc,
                         s1s, t1s, C1, slope, hb);
    __syncthreads();
    for (int p0 = 0; p0 < C2; p0 += XP) {
      const int c0 = p0 + 4 * tx;
      const bool active = c0 < ldw;
      float acc[8][4];
      if (active) dg::e2t_z2_block(hb, w2s, ldw, C1p, c0, ty, acc);
      __syncthreads();  // the previous pass's (or tile's) reads of yb are done
      if (active) {
        float sc[4], tc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i] = s2s[c0 + i];
          tc[i] = t2s[c0 + i];
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          float y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = dg::e2_lrelu(__fadd_rn(__fmul_rn(acc[m][i], sc[i]), tc[i]),
                                slope);
          *reinterpret_cast<float4*>(yb + (ty + 16 * m) * XP + 4 * tx) =
              make_float4(y[0], y[1], y[2], y[3]);
        }
      }
      __syncthreads();
      // the max over each row's edges, t ascending: the row-warp order
      for (int q = tid; q < nr * XP; q += dg::TS_THREADS) {
        const int r = q / XP, c = q - r * XP;
        if (p0 + c < C2) {
          float mx = -INFINITY;
          if constexpr (V3 && TC) {  // the present slots only
            const int kr = ncls[r];
            for (int t = 0; t < kr; ++t)
              mx = fmaxf(mx, yb[(r * k + t) * XP + c]);
          } else {
            for (int t = 0; t < k; ++t)
              if (!V3 || ecnt[r * k + t] > 0)
                mx = fmaxf(mx, yb[(r * k + t) * XP + c]);
          }
          dg::store_out(outb + (size_t)(r0 + rt + r) * C2 + p0 + c, mx);
        }
      }
    }
  }
}

}  // namespace e2c
}  // namespace dg
