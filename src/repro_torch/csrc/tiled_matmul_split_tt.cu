// The split pair on wgmma's tt layout (op(A) stored (K, M) and op(B) stored (N, K)):
// one operand is the three bf16 terms of an f32 matrix, three ring entries
// per K tile. Its six kernels (3 tile widths x 2 output dtypes) are compiled
// in a unit of their own, beside tiled_matmul.cu, so nvcc builds them in
// parallel with the plain layouts; tiled_matmul.cu's launch_fast calls this
// entry with split_of 1 or 2.

#include "tiled_matmul.cuh"

REPRO_WGMMA_LAYOUT(repro_wgmma_split_tt) {
  return launch_wgmma_layout<true, true, 3>(
      g, out_dtype, bn, splits, segments, ws, counters, split_of, s_plane,
      stream);
}
