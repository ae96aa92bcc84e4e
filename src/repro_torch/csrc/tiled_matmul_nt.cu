// wgmma's nt layout: op(B) stored (N, K), K-contiguous (the input gradient's weight, a tied head's table).
// Its six kernels (3 tile widths x 2 output dtypes) are compiled in a unit
// of their own, beside tiled_matmul.cu, so nvcc builds the layouts in
// parallel; tiled_matmul.cu's launch_fast calls this entry.

#include "tiled_matmul.cuh"

REPRO_WGMMA_LAYOUT(repro_wgmma_nt) {
  return launch_wgmma_layout<false, true, 1>(
      g, out_dtype, bn, splits, segments, ws, counters, split_of, s_plane,
      stream);
}
