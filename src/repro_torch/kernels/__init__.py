"""The port's kernels: the hand-written Hopper GEMM, its plain version and
the ops layer every projection goes through."""
