// edge_conv_amp_banded: kernel 12's tiled AMP v3 and v2 forms and exact
// v2 form, kernel 1's over each query tile's window of a PC1-sorted cloud
// (replaces dgcnn_tpu/ops/pallas_banded.py::banded_edge_conv_eval at its
// variants; edge_conv_amp.cu says what they compute), at every Co <= 256:
// the fusion Net's stages 3 (64 -> 128, project-first v2) and 4 (128 ->
// 256, select-x v2: the window's bf16 x rows, each projected once with the
// f32 W_nbr) as well as the segmentation models' conv5 (64).  Launched
// from dg_edge_conv_eval_variant (edge_conv_amp.cu).
#include "edge_conv_amp.cuh"

namespace dg {

cudaError_t launch_amp_banded(const AmpVarArgs& a, bool v3, bool round,
                              bool exact, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (v3) return launch_var_shape<true, true, true, bf16>(a, st);
  if (exact) return launch_var_shape<false, false, true, float>(a, st);
  if (round) return launch_var_shape<false, true, true, bf16>(a, st);
  return launch_var_shape<false, false, true, bf16>(a, st);
}

}  // namespace dg
