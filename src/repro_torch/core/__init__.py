"""The paper's loop in the port: chip specs, the GEMM simulator, features,
the ML zoo and its torch scorer, the predictor, the profiler (with the
card's CUDA-event runner) and the autotuner."""
