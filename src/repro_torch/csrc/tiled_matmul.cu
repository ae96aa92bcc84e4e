// Tiled GEMM for Hopper (sm_90a): C = alpha * op(A) @ op(B) + beta * C_in.
//
// Replaces repro/kernels/tiled_matmul.py::_matmul_kernel, the Pallas TPU
// kernel behind every projection of the JAX package. It computes the same
// function: fp32 accumulation over K, then alpha * acc (+ beta * C_in, with
// C_in already rounded to the output type by the caller) cast to the output
// type. It is not a block-by-block copy of the TPU schedule: the TPU carries
// its accumulator across a sequential k grid axis in VMEM, while here one
// thread block owns one (BM, BN) output tile and loops over K itself, with
// the accumulator in registers (tensor-core fragments for bf16, per-thread
// micro-tiles for f32).
//
// What bounds it on an H100: a decode-step GEMM (M = a few rows) reads the
// whole weight matrix once and does ~2 FLOPs per weight byte, so it is bound
// by the bytes of the weights (3.35 TB/s); a prefill chunk of hundreds of
// rows is bound by tensor-core FLOPs (989 TFLOP/s bf16). This first design
// is simple and right rather than fast:
//   * A and B tiles are staged through shared memory with masked element
//     loads taken from arbitrary strides (all four layouts, ragged edges,
//     no padding copies); the loop order follows the contiguous axis so a
//     warp's loads coalesce.
//   * A decode GEMM is latency-bound per K step, so each thread issues all
//     of its loads for a K step at once, and issues the next step's loads
//     into registers before multiplying the current step out of shared
//     memory (a two-stage software pipeline).
//   * Where both bf16 operands have contiguous, 16-byte aligned rows (every
//     projection of the serving path), tiles move as 16-byte vectors: one
//     load and one shared store per 8 elements, so a K step costs each
//     thread one or two loads per tile and few registers.
//   * bf16 inputs go through WMMA (mma.sync) 16x16x16 fragments with fp32
//     accumulators: the tensor cores serve the FLOP-bound chunk GEMMs.
//   * f32 inputs use fp32 FMA on the CUDA cores, so an f32 product keeps
//     full f32 precision (no TF32).
//   * Beyond that, the weight-bound decode GEMMs get no special treatment
//     yet: there is no split-K, no cp.async or TMA and no wgmma. Those are
//     the follow-up that closes the gap to the bytes bound.
//
// Plain C entry point (loaded with ctypes); returns cudaGetLastError() after
// the launch. Launches on the caller's stream, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps per block, every tile shape

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct GemmArgs {
  const void* a;
  const void* b;
  const void* c_in;  // read only when beta != 0; already in the output type
  void* out;         // (M, N) row-major
  int64_t M, N, K;
  int64_t sam, sak;  // op(A)[m, k] = a[m * sam + k * sak]
  int64_t sbk, sbn;  // op(B)[k, n] = b[k * sbk + n * sbn]
  int64_t scm, scn;  // C_in[m, n] = c_in[m * scm + n * scn]
  float alpha, beta;
};

// One thread's share of a ROWS x COLS tile of a strided (R, C) matrix:
// element j of `v` is the tile's flat element threadIdx.x + j * kThreads,
// converted to float and zero outside the matrix. `cols_fast` numbers the
// tile with the column index fastest (for a matrix whose columns are
// contiguous, so a warp's loads coalesce), else the row index fastest.
template <int ROWS, int COLS>
struct TileSlice {
  static constexpr int kN = ROWS * COLS / kThreads;
  static_assert(ROWS * COLS % kThreads == 0, "tile must split evenly");
  float v[kN];

  __device__ __forceinline__ static void coords(int i, bool cols_fast, int& r,
                                                int& c) {
    if (cols_fast) {
      r = i / COLS;
      c = i % COLS;
    } else {
      c = i / ROWS;
      r = i % ROWS;
    }
  }

  // Issue every load of the slice before any is used, so they are all in
  // flight at once (and, issued before the current tile's math, overlap
  // it).
  template <typename Tin>
  __device__ __forceinline__ void fetch(const Tin* __restrict__ src,
                                        int64_t r0, int64_t c0, int64_t R,
                                        int64_t C, int64_t s_r, int64_t s_c,
                                        bool cols_fast) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      int r, c;
      coords(threadIdx.x + j * kThreads, cols_fast, r, c);
      const int64_t gr = r0 + r, gc = c0 + c;
      v[j] = (gr < R && gc < C) ? to_f32<Tin>(src[gr * s_r + gc * s_c])
                                : 0.0f;
    }
  }

  // Write the slice into shared memory as dst[r * LD + c] in type S.
  template <typename S, int LD>
  __device__ __forceinline__ void stash(S* dst, bool cols_fast) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      int r, c;
      coords(threadIdx.x + j * kThreads, cols_fast, r, c);
      dst[r * LD + c] = from_f32<S>(v[j]);
    }
  }
};

// The same for a bf16 tile whose columns are contiguous in memory and whose
// rows start on 16-byte boundaries: one 16-byte load and one 16-byte shared
// store per 8 elements. A vector that crosses the matrix's last column is
// assembled element by element, zero-filled.
template <int ROWS, int COLS>
struct VecSlice {
  static constexpr int kPerRow = COLS / 8;
  static constexpr int kN = ROWS * kPerRow / kThreads;
  static_assert(ROWS * kPerRow % kThreads == 0, "tile must split evenly");
  uint4 v[kN];

  __device__ __forceinline__ void fetch(const __nv_bfloat16* __restrict__ src,
                                        int64_t r0, int64_t c0, int64_t R,
                                        int64_t C, int64_t s_r) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int64_t gr = r0 + i / kPerRow, gc = c0 + (i % kPerRow) * 8;
      const __nv_bfloat16* p = src + gr * s_r + gc;
      if (gr < R && gc + 8 <= C) {
        v[j] = *reinterpret_cast<const uint4*>(p);
      } else {
        unsigned h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = (gr < R && gc + e < C) ? __bfloat16_as_ushort(p[e]) : 0u;
        v[j] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                          h[4] | (h[5] << 16), h[6] | (h[7] << 16));
      }
    }
  }

  template <int LD>
  __device__ __forceinline__ void stash(__nv_bfloat16* dst) const {
    static_assert(LD % 8 == 0, "rows must stay 16-byte aligned");
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(dst + (i / kPerRow) * LD + (i % kPerRow) * 8) =
          v[j];
    }
  }
};

// True when op(A) rows and B rows are contiguous bf16 runs that start on
// 16-byte boundaries, so both tiles can be moved 16 bytes at a time.
inline bool vector_tiles(const GemmArgs& g) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  return g.sak == 1 && g.sam % 8 == 0 && aligned(g.a) && g.sbn == 1 &&
         g.sbk % 8 == 0 && aligned(g.b);
}

// alpha * acc (+ beta * C_in) for one output element, stored in Tout.
template <typename Tout>
__device__ __forceinline__ void store_out(const GemmArgs& g, int64_t m,
                                          int64_t n, float acc) {
  if (m >= g.M || n >= g.N) return;
  float v = g.alpha * acc;
  if (g.beta != 0.0f) {
    const Tout* cin = static_cast<const Tout*>(g.c_in);
    v += g.beta * to_f32<Tout>(cin[m * g.scm + n * g.scn]);
  }
  static_cast<Tout*>(g.out)[m * g.N + n] = from_f32<Tout>(v);
}

// f32 inputs: fp32 FMA on CUDA cores. The 256 threads form a 16 x 16 grid;
// each owns a (BM/16) x (BN/16) micro-tile at stride 16 in both directions.
template <typename Tout, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const GemmArgs g) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = BK + 1;  // pad: the A tile is also written column-wise
  __shared__ float As[BM * LDA];
  __shared__ float Bs[BK * BN];
  const float* A = static_cast<const float*>(g.a);
  const float* B = static_cast<const float*>(g.b);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const bool a_k_fast = g.sak <= g.sam;
  const bool b_n_fast = g.sbn <= g.sbk;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // software pipeline: the next K step's tiles are fetched into registers
  // while the current one is multiplied out of shared memory
  TileSlice<BM, BK> ra;
  TileSlice<BK, BN> rb;
  ra.fetch(A, m0, 0, g.M, g.K, g.sam, g.sak, a_k_fast);
  rb.fetch(B, 0, n0, g.K, g.N, g.sbk, g.sbn, b_n_fast);
  for (int64_t k0 = 0; k0 < g.K; k0 += BK) {
    ra.template stash<float, LDA>(As, a_k_fast);
    rb.template stash<float, BN>(Bs, b_n_fast);
    __syncthreads();
    if (k0 + BK < g.K) {
      ra.fetch(A, m0, k0 + BK, g.M, g.K, g.sam, g.sak, a_k_fast);
      rb.fetch(B, k0 + BK, n0, g.K, g.N, g.sbk, g.sbn, b_n_fast);
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      store_out<Tout>(g, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// bf16 inputs: WMMA 16x16x16 bf16 fragments with fp32 accumulators. The 8
// warps form a 4 x 2 grid over the block tile; each owns a (BM/4) x (BN/2)
// warp tile of FM x FN fragments. VEC moves both tiles 16 bytes at a time
// (`vector_tiles`), else element by element from any strides.
template <typename Tout, int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const GemmArgs g) {
  constexpr int LDA = BK + 8;  // multiples of 8 elements, as WMMA requires
  constexpr int LDB = BN + 8;
  constexpr int WM = BM / 4, WN = BN / 2;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(BK % 16 == 0 && WM % 16 == 0 && WN % 16 == 0, "tile shape");
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(g.b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const bool a_k_fast = g.sak <= g.sam;
  const bool b_n_fast = g.sbn <= g.sbk;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // next K step's tiles, fetched into registers during the math
  std::conditional_t<VEC, VecSlice<BM, BK>, TileSlice<BM, BK>> ra;
  std::conditional_t<VEC, VecSlice<BK, BN>, TileSlice<BK, BN>> rb;
  const auto fetch = [&](int64_t k0) {
    if constexpr (VEC) {
      ra.fetch(A, m0, k0, g.M, g.K, g.sam);
      rb.fetch(B, k0, n0, g.K, g.N, g.sbk);
    } else {
      ra.fetch(A, m0, k0, g.M, g.K, g.sam, g.sak, a_k_fast);
      rb.fetch(B, k0, n0, g.K, g.N, g.sbk, g.sbn, b_n_fast);
    }
  };
  fetch(0);
  for (int64_t k0 = 0; k0 < g.K; k0 += BK) {
    if constexpr (VEC) {
      ra.template stash<LDA>(As);
      rb.template stash<LDB>(Bs);
    } else {
      ra.template stash<__nv_bfloat16, LDA>(As, a_k_fast);
      rb.template stash<__nv_bfloat16, LDB>(Bs, b_n_fast);
    }
    __syncthreads();
    if (k0 + BK < g.K) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  // Epilogue: each fragment goes through the warp's 16x16 staging tile so
  // the ragged edge can be masked element by element.
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        store_out<Tout>(g, m0 + wm * WM + i * 16 + r,
                        n0 + wn * WN + j * 16 + c, Cs[warp][e]);
      }
      __syncwarp();
    }
  }
}

template <typename Tin, typename Tout, int BM, int BN, int BK>
cudaError_t launch(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((g.N + BN - 1) / BN),
                  static_cast<unsigned>((g.M + BM - 1) / BM));
  if constexpr (std::is_same<Tin, __nv_bfloat16>::value) {
    if (vector_tiles(g))
      gemm_bf16_kernel<Tout, BM, BN, BK, true>
          <<<grid, kThreads, 0, stream>>>(g);
    else
      gemm_bf16_kernel<Tout, BM, BN, BK, false>
          <<<grid, kThreads, 0, stream>>>(g);
  } else {
    gemm_f32_kernel<Tout, BM, BN, BK><<<grid, kThreads, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_tile(const GemmArgs& g, int bm, int bn, int bk,
                        cudaStream_t stream) {
  if (bm == 64 && bn == 64 && bk == 32)
    return launch<Tin, Tout, 64, 64, 32>(g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Tile (bm, bn, bk) must be an
// instantiated shape; the only one is (64, 64, 32).
extern "C" int repro_tiled_matmul(const void* a, const void* b,
                                  const void* c_in, void* out, int64_t M,
                                  int64_t N, int64_t K, int64_t sam,
                                  int64_t sak, int64_t sbk, int64_t sbn,
                                  int64_t scm, int64_t scn, float alpha,
                                  float beta, int in_dtype, int out_dtype,
                                  int bm, int bn, int bk, void* stream) {
  const GemmArgs g{a,   b,   c_in, out, M,   N,     K,   sam,
                   sak, sbk, sbn,  scm, scn, alpha, beta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_tile<float, float>(g, bm, bn, bk, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_tile<float, __nv_bfloat16>(g, bm, bn, bk, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_tile<__nv_bfloat16, float>(g, bm, bn, bk, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_tile<__nv_bfloat16, __nv_bfloat16>(g, bm, bn, bk, s);
  return cudaErrorInvalidValue;
}
