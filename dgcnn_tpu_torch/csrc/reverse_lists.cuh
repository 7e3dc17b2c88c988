// Reverse neighbour lists: for every point j of a cloud, the edges e = i *
// k + t whose neighbour idx[i, t] is j, in ascending e.  Kernels 5
// (edge_reduce_bwd.cu) and 8 (edge2_bwd.cu) sum their cotangents into a
// point's row over its list ("pull"), in that order from zero, instead of
// adding each edge's cotangent into the row by float atomics ("push"): the
// same bits from run to run, and those of a sequential f32 scatter-add
// over the edges in ascending order (numpy's add.at).  The lists are built
// on the card from idx (reverse_lists.cu): in-degrees by integer atomics,
// which are exact, an exclusive scan, a fill in any order, then each list
// sorted by edge id.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace dg {

// The int32 scratch build_reverse_lists takes for B clouds of N points
// and k neighbours a point.
inline size_t reverse_list_ints(int B, int N, int k) {
  const size_t rows = (size_t)B * N;
  const size_t chunks = (rows + 4095) / 4096;  // the scan's, of 4096 rows
  return 2 * rows + 1 + 2 * rows * k + 2 * chunks + 1;
}

// Builds the lists of idx (B, N, k) int32 (neighbours within each cloud)
// in `scratch` (reverse_list_ints ints) on `st`.  On return *off points at
// B * N + 1 offsets and *lst at B * N * k edge ids: the list of row g = b *
// N + j is lst[off[g] .. off[g + 1]), global edge ids (b * N + i) * k + t,
// ascending.  An index outside [0, N) belongs to no list.
cudaError_t build_reverse_lists(const int* idx, int B, int N, int k,
                                int* scratch, const int** off,
                                const int** lst, cudaStream_t st);

// out[g, c] = the sum over the list of row g, e ascending, of add[e, c],
// from zero with _rn adds: add (B * N * k, C) f32, out (B * N, C).
cudaError_t launch_pull_sum(const int* off, const int* lst,
                            const float* add, int rows, int C, float* out,
                            cudaStream_t st);

// As launch_pull_sum over bf16 addends (C <= 64), each widened to f32 and
// added in the same order with the same _rn adds: the f32 pull's bits on
// the widened values.
cudaError_t launch_pull_sum_bf16(const int* off, const int* lst,
                                 const __nv_bfloat16* add, int rows, int C,
                                 float* out, cudaStream_t st);

}  // namespace dg
