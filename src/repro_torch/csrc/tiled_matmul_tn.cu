// wgmma's tn layout: op(A) stored (K, M), M-contiguous (the weight gradient's activations).
// Its six kernels (3 tile widths x 2 output dtypes) are compiled in a unit
// of their own, beside tiled_matmul.cu, so nvcc builds the layouts in
// parallel; tiled_matmul.cu's launch_fast calls this entry.

#include "tiled_matmul.cuh"

REPRO_WGMMA_LAYOUT(repro_wgmma_tn) {
  return launch_wgmma_layout<true, false, 1>(
      g, out_dtype, bn, splits, segments, ws, counters, split_of, s_plane,
      stream);
}
