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
// Three paths, chosen on the host by `plan` (kernels/tiled_matmul.py) from
// dtype, layout, alignment and M; each is one launch per GEMM.
//
// * stream (bf16, op(A) rows and B rows contiguous and 16-byte aligned,
//   M <= 64): the decode GEMMs. They read the whole weight matrix once and
//   do 2*M FLOPs per weight element, so the H100 bounds them by the weight
//   bytes (3.35 TB/s). What keeps a simple kernel from that rate is too few
//   bytes in flight: a 4x3584 @ 3584x512 product is 8 output tiles. So K is
//   split over CTAs until the grid covers the 132 SMs, and each CTA keeps a
//   4-stage ring of cp.async.cg 16-byte copies (8 KB of weights per stage)
//   in flight. The product runs as Ct = Bt * At with mma.sync m16n8k16: the
//   weights fill the 16-row operand (ldmatrix.trans reads the N-contiguous
//   tile), and the M <= 64 activation rows fill n = 8 * ceil(M / 8), so a
//   4-row decode wastes at most half of each mma instead of 15/16. The
//   weights may also be stored (N, K), K-contiguous (a tied LM head reads
//   the embedding table so): that layout loads its tile n-row by n-row, as
//   the activations are loaded, and the plain ldmatrix reads the same
//   operand Bt[n, k], so both layouts issue the same mma.sync sequence on
//   the same values and give a row the same bits.
// * wgmma (the same layouts, M > 64): the prefill chunks, bound by
//   tensor-core FLOPs (989 TFLOP/s bf16) from M ~ 300 up, and below that by
//   the weight bytes. A 128 x BN x 64 tile, BN = 256, 128 or 64 (`plan`
//   takes the widest whose tiles fill the 132 SMs: the wide tiles move
//   fewer operand bytes per FLOP, the narrow one needs fewer K-splits where
//   N is small): one producer thread keeps TMA loads of both operands in flight
//   into a 4-stage ring of 128-byte-swizzled shared memory guarded by
//   mbarriers, and two consumer warpgroups each issue wgmma.m64nBNk16 from
//   shared memory (A K-major, B MN-major) into fp32 registers. TMA
//   zero-fills the boxes past M, N and K, so only the epilogue masks.
// * general (every other case: f32, transposed A, a transposed B at
//   M > 64, unaligned views):
//   one 256-thread block per 64x64 output tile with the K loop inside,
//   masked strided loads prefetched into registers a K step ahead, 16-byte
//   vector tiles where rows allow, WMMA 16x16x16 for bf16 and fp32 FMA on
//   the CUDA cores for f32 (no TF32). It is the first version of this
//   kernel, kept for the cases the fast paths do not take.
//
// K segments (both fast paths): a row's result must not depend on how many
// rows share the call, nor on which path `plan` picks for that M. So K is cut
// into `segments` contiguous runs of K tiles, a count that depends on N and K
// only; each run is summed from a fresh fp32 accumulator and the runs' sums
// are then added in order, starting from 0. mma.sync m16n8k16 (stream) and
// wgmma m64nNk16 (wgmma) give the same fp32 sum over the same run of K tiles
// on the H100 (the row-invariance check of chip_smoke.py's phase 3), so both
// paths give a row the same bits at any M. `stream` gives each segment a CTA
// of its own ("spread"); `wgmma` either does the same or, where the tiles
// alone fill the card, walks a tile's segments in one CTA, adding each
// segment's accumulator into a running total ("walk"; the 128x256 tile has no
// registers for the total, so it walks only a single segment). Spread
// segments write their fp32 partial tiles to a workspace the wrapper
// allocates (segments x M x N); the CTA that finishes a tile last, found
// through an int32 counter per tile that it then resets to 0, sums the
// partials in segment order and runs the epilogue. There are no float
// atomics, so the result is also bit-identical from run to run.
//
// Plain C entry point (loaded with ctypes); returns a cudaError_t after the
// launch. Launches on the caller's stream, allocates nothing.

#include <cuda.h>
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
  int b_nk;          // fast paths: B stored (N, K), K-contiguous (sbk == 1)
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
cudaError_t launch_general(const GemmArgs& g, int bm, int bn, int bk,
                           cudaStream_t stream) {
  if (bm == 64 && bn == 64 && bk == 32)
    return launch<Tin, Tout, 64, 64, 32>(g, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Pieces shared by the two fast paths (PTX for sm_90a).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Split-K hand-off. Every thread has stored its share of this split's
// partial tile; the tile's counter then counts the split in. Returns true to
// every thread of the CTA that arrives last, which resets the counter to 0
// for the next launch and may then read every split's partial.
__device__ __forceinline__ bool arrive_last(int* counter, int splits,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == splits - 1;
    if (last) atomicExch(counter, 0);
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// The last CTA of a split tile: for each (m, n) of the tile, the sum of the
// splits' partials in split order, then the epilogue. `ws` is (splits, M, N)
// fp32; __ldcg reads through L2, where the other CTAs' stores landed. Each
// thread owns 4 adjacent columns and issues the loads of 8 splits before it
// adds them (in order), so a whole tile's partials stream in at once; where
// N % 4 != 0 the rows are not 16-byte aligned and it reads scalars.
template <typename Tout, int ROWS, int COLS>
__device__ __forceinline__ void reduce_splits(const GemmArgs& g,
                                              const float* ws, int splits,
                                              int64_t m0, int64_t n0) {
  constexpr int V = 4, U = 8;
  const int64_t plane = g.M * g.N;
  const bool vec = g.N % V == 0;
  for (int e = threadIdx.x; e < ROWS * COLS / V; e += blockDim.x) {
    const int64_t m = m0 + e / (COLS / V), n = n0 + (e % (COLS / V)) * V;
    if (m >= g.M || n >= g.N) continue;
    const float* p = ws + m * g.N + n;
    float s[V] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (vec) {  // n % 4 == 0 and N % 4 == 0: all 4 columns exist
      int sp = 0;
      for (; sp + U <= splits; sp += U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[u] = __ldcg(reinterpret_cast<const float4*>(p + (sp + u) * plane));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[0] += v[u].x;
          s[1] += v[u].y;
          s[2] += v[u].z;
          s[3] += v[u].w;
        }
      }
      for (; sp < splits; ++sp) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(p + sp * plane));
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (n + j < g.N)
          for (int sp = 0; sp < splits; ++sp) s[j] += __ldcg(p + sp * plane + j);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (n + j < g.N) store_out<Tout>(g, m, n + j, s[j]);
  }
}

// ---------------------------------------------------------------------------
// stream path: M <= 64, weight-bytes bound.

constexpr int kStreamThreads = 128;  // 4 warps, 16 output columns (n) each
constexpr int kStreamBN = 64, kStreamBK = 64, kStreamStages = 4;

// Dynamic shared memory of a stream CTA whose activation tile has `mp` rows:
// the ring of (BK x BN) weight and (mp x BK) activation tiles, and the
// split-K flag.
constexpr int stream_smem_bytes(int mp) {
  return kStreamStages * (kStreamBK * kStreamBN + mp * kStreamBK) * 2 + 16;
}

// 16-byte global -> shared copy that reads `bytes` (0..16) and zero-fills
// the rest; the source must be a valid address even when bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 sum.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared tiles have 128-byte rows (64 bf16 = 8 chunks of 16 bytes); chunk c
// of row r is stored at chunk c ^ (r % 8), so the 8 rows an ldmatrix reads
// at one chunk index fall in 8 different bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

// One CTA: output columns [n0, n0 + 64) for every row (M <= 8 * MT), over
// the K tiles of split blockIdx.y. Warp w computes the 16 x (8 * MT) block
// Ct[n0 + 16w .. +16, 0 .. 8 * MT). BNK: B is stored (N, K), K-contiguous,
// and its tile is kept as Bs[n][k]; else (K, N) and Bs[k][n].
template <typename Tout, int MT, bool BNK>
__global__ void __launch_bounds__(kStreamThreads)
    gemm_stream_kernel(const GemmArgs g, float* __restrict__ ws,
                       int* __restrict__ counters, int splits) {
  constexpr int MP = 8 * MT, BN = kStreamBN, BK = kStreamBK;
  constexpr int NT = kStreamThreads, S = kStreamStages;
  constexpr int B_ELEMS = BK * BN, STAGE = B_ELEMS + MP * BK;
  static_assert(BN == 64 && BK == 64, "swz assumes 128-byte rows");
  extern __shared__ __align__(128) unsigned char stream_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(stream_smem);
  int* flag = reinterpret_cast<int*>(smem + S * STAGE);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(g.b);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int split = blockIdx.y;
  const int64_t kt = (g.K + BK - 1) / BK;
  const int64_t t0 = kt * split / splits;
  const int nt = static_cast<int>(kt * (split + 1) / splits - t0);

  // K tile t0 + i into ring slot i % S: the weight tile row by row (k, or n
  // for BNK), the activation tile row by row (m), zero past N, K and M.
  const auto load = [&](int i) {
    __nv_bfloat16* Bs = smem + (i % S) * STAGE;
    __nv_bfloat16* As = Bs + B_ELEMS;
    const int64_t k0 = (t0 + i) * BK;
    for (int j = tid; j < (BNK ? BN : BK) * 8; j += NT) {
      const int r = j / 8, c = j % 8;
      if constexpr (BNK) {
        const int64_t gn = n0 + r, gk = k0 + c * 8;
        const int64_t left = gn < g.N ? g.K - gk : 0;
        const int bytes = left <= 0 ? 0 : (left >= 8 ? 16 : 2 * static_cast<int>(left));
        cp_async16(Bs + swz(r, c), bytes ? B + gn * g.sbn + gk : B, bytes);
      } else {
        const int64_t gk = k0 + r, gn = n0 + c * 8;
        const int64_t left = gk < g.K ? g.N - gn : 0;
        const int bytes = left <= 0 ? 0 : (left >= 8 ? 16 : 2 * static_cast<int>(left));
        cp_async16(Bs + swz(r, c), bytes ? B + gk * g.sbk + gn : B, bytes);
      }
    }
    for (int j = tid; j < MP * 8; j += NT) {
      const int r = j / 8, c = j % 8;
      const int64_t gk = k0 + c * 8;
      const int64_t left = r < g.M ? g.K - gk : 0;
      const int bytes = left <= 0 ? 0 : (left >= 8 ? 16 : 2 * static_cast<int>(left));
      cp_async16(As + swz(r, c), bytes ? A + r * g.sam + gk : A, bytes);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  const int mat = lane >> 3, row8 = lane & 7;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<S - 2>();  // tile i has landed
    __syncthreads();         // and every warp is done with tile i - 1's slot
    if (i + S - 1 < nt) load(i + S - 1);
    cp_async_commit();
    const __nv_bfloat16* Bs = smem + (i % S) * STAGE;
    const __nv_bfloat16* As = Bs + B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // 16 x 16 operand Bt[n, k]: matrices (n lo, k lo), (n hi, k lo),
      // (n lo, k hi), (n hi, k hi), read transposed from Bs[k][n], or as
      // they lie from Bs[n][k]
      uint32_t af[4];
      if constexpr (BNK) {
        const int n = 16 * warp + ((mat & 1) << 3) + row8;
        ldsm_x4(af, Bs + swz(n, (kk >> 3) + (mat >> 1)));
      } else {
        const int k = kk + row8 + ((mat >> 1) << 3);
        ldsm_x4_trans(af, Bs + swz(k, 2 * warp + (mat & 1)));
      }
      if constexpr (MT == 1) {
        uint32_t bf[2];
        ldsm_x2(bf, As + swz(row8, (kk >> 3) + (mat & 1)));
        mma_16816(acc[0], af, bf[0], bf[1]);
      } else {
#pragma unroll
        for (int j = 0; j < MT; j += 2) {
          // (8 x 16) At operands of row tiles j and j + 1: matrices
          // (j, k lo), (j, k hi), (j + 1, k lo), (j + 1, k hi)
          uint32_t bf[4];
          ldsm_x4(bf, As + swz(8 * (j + (mat >> 1)) + row8, (kk >> 3) + (mat & 1)));
          mma_16816(acc[j], af, bf[0], bf[1]);
          mma_16816(acc[j + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[j][e] is Ct[n, m] at n = n0 + 16 warp + lane / 4 (+ 8 for e >= 2),
  // m = 8 j + 2 (lane % 4) + (e % 2)
  const int64_t nb = n0 + 16 * warp + lane / 4;
  const int mb = 2 * (lane % 4);
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out<Tout>(g, 8 * j + mb + (e & 1), nb + 8 * (e >> 1), acc[j][e]);
    return;
  }
  float* part = ws + split * g.M * g.N;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t m = 8 * j + mb + (e & 1), n = nb + 8 * (e >> 1);
      if (m < g.M && n < g.N) part[m * g.N + n] = acc[j][e];
    }
  if (arrive_last(counters + blockIdx.x, splits, flag))
    reduce_splits<Tout, MP, BN>(g, ws, splits, 0, n0);
}

// ---------------------------------------------------------------------------
// wgmma path: M > 64, tensor-core bound for large M.

constexpr int kWgBM = 128, kWgBK = 64, kWgStages = 4;
constexpr int kWgThreads = 2 * 128 + 32;  // two consumer warpgroups, one producer warp

// Dynamic shared memory of a wgmma CTA: 1024 bytes to align the ring to the
// 128-byte swizzle's 1024-byte period, the ring of (128 x 64) A and
// (64 x BN) B tiles, a full and an empty mbarrier per stage, the split flag.
constexpr int wgmma_smem_bytes(int bn) {
  return 1024 + kWgStages * (kWgBM * kWgBK + kWgBK * bn) * 2 + 16 * kWgStages +
         16;
}

// Raise a barrier wait that cannot finish into a launch error after ~10 s
// rather than hang the card.
constexpr long long kHangCycles = 20000000000LL;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the completion of the barrier's phase of parity `parity` (its
// first completion has parity 0, the next 1, ...).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kHangCycles) __trap();
}

// TMA: the box at element coordinates (c0 innermost, c1) of `map` into
// shared memory, counted against `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128-byte swizzle. K-major A: rows of 64 k at 128 bytes, 8-row groups at
// SBO = 1024. MN-major B: 64 n per 128-byte row, one row per k, 8-k groups
// at SBO = 1024 and the next 64 n (the next TMA box) at LBO.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N fp32, the warpgroup's accumulator fragment) += A * B, A K-major
// and B MN-major (the final 0, 1 immediates), both scales 1, accumulate.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, da, db);
  else if constexpr (BN == 128)
    wgmma_m64n128k16(d, da, db);
  else
    wgmma_m64n64k16(d, da, db);
}

// One CTA: output tile [m0, m0 + 128) x [n0, n0 + BN) over the K tiles of
// split blockIdx.z. Warps 0-7 are two consumer warpgroups (rows 0-63 and
// 64-127 of the tile); lane 0 of warp 8 is the TMA producer. With
// splits == 1 and segments > 1 the CTA walks all `segments` K segments,
// summing each from zero and adding it into a running total (not compiled
// for BN = 256); otherwise splits == segments and the CTA owns one.
template <typename Tout, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const GemmArgs g, float* __restrict__ ws,
                      int* __restrict__ counters, int splits, int segments) {
  constexpr int BM = kWgBM, BK = kWgBK, S = kWgStages;
  constexpr int A_BYTES = BM * BK * 2, BOX_BYTES = BK * 64 * 2;
  constexpr int STAGE = A_BYTES + BK * BN * 2;
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma tile width");
  extern __shared__ __align__(128) unsigned char wgmma_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wgmma_smem) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  int* flag = reinterpret_cast<int*>(empty + S);
  const int tid = threadIdx.x, wg = tid / 128;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int split = blockIdx.z;
  const int64_t kt = (g.K + BK - 1) / BK;
  const int64_t t0 = kt * split / splits;
  const int nt = static_cast<int>(kt * (split + 1) / splits - t0);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);      // the producer's expect_tx arrival
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  if (wg == 2) {
    if (tid == 256) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);
        unsigned char* st = ring + s * STAGE;
        const int k0 = static_cast<int>((t0 + i) * BK);
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(st, &tma_a, k0, static_cast<int>(m0), &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(st + A_BYTES + j * BOX_BYTES, &tma_b,
                      static_cast<int>(n0) + 64 * j, k0, &full[s]);
      }
    }
  } else {
    // walk: the running total of the segments before the current one, and
    // the K tile where the next segment starts
    constexpr bool kCanWalk = BN != 256;
    float total[kCanWalk ? BN / 2 : 1];
    int seg = 1;
    int64_t next = kt * seg / segments;
    if constexpr (kCanWalk) {
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) total[r] = 0.0f;
    }
    for (int i = 0; i < nt; ++i) {
      const int s = i % S;
      if constexpr (kCanWalk) {
        if (splits == 1 && i == next) {  // segment seg - 1 ends: bank it
          wgmma_wait<0>();
          fence_acc(acc);
#pragma unroll
          for (int r = 0; r < BN / 2; ++r) {
            total[r] += acc[r];
            acc[r] = 0.0f;
          }
          next = kt * ++seg / segments;
        }
      }
      mbar_wait(&full[s], (i / S) & 1);
      const unsigned char* st = ring + s * STAGE;
      const uint64_t da = make_desc(st + wg * 64 * 128, 16, 1024);
      const uint64_t db = make_desc(st + A_BYTES, BOX_BYTES, 1024);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 k: 32 bytes along A's rows,
        wgmma_tile<BN>(acc, da + 2 * kk,    // 16 rows (2048 bytes) of B
                       db + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done with its slot
      fence_acc(acc);
      if (i > 0) mbar_arrive(&empty[(i - 1) % S]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (kCanWalk) {
      if (splits == 1 && segments > 1) {  // the last segment, then the total
#pragma unroll
        for (int r = 0; r < BN / 2; ++r) acc[r] = total[r] + acc[r];
      }
    }
  }

  // acc[4 i + e] of consumer thread t is the tile's (row, col) =
  // (64 wg + 16 (t % 128 / 32) + (t % 32) / 4 + 8 (e / 2),
  //  8 i + 2 (t % 4) + e % 2)
  const int64_t mb = m0 + 64 * wg + 16 * ((tid % 128) / 32) + (tid % 32) / 4;
  const int64_t nb = n0 + 2 * (tid % 4);
  if (splits == 1) {
    if (wg < 2) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store_out<Tout>(g, mb + 8 * (e >> 1), nb + 8 * i + (e & 1),
                          acc[4 * i + e]);
    }
    return;
  }
  if (wg < 2) {
    float* part = ws + split * g.M * g.N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t m = mb + 8 * (e >> 1), n = nb + 8 * i + (e & 1);
        if (m < g.M && n < g.N) part[m * g.N + n] = acc[4 * i + e];
      }
  }
  if (arrive_last(counters + blockIdx.y * gridDim.x + blockIdx.x, splits, flag))
    reduce_splits<Tout, BM, BN>(g, ws, splits, m0, n0);
}

// ---------------------------------------------------------------------------
// Host side of the fast paths.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor map of a row-major bf16 (rows, cols) matrix with row stride `ld`
// elements, boxes of (box_rows, box_cols = 64: one 128-byte swizzle row),
// zero fill outside the matrix.
bool bf16_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
              int64_t ld, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into `bytes` of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

template <typename Tout, int MT, bool BNK>
cudaError_t launch_stream(const GemmArgs& g, int splits, float* ws,
                          int* counters, cudaStream_t stream) {
  constexpr int smem = stream_smem_bytes(8 * MT);
  static unsigned done = 0;
  const auto kernel = gemm_stream_kernel<Tout, MT, BNK>;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((g.N + kStreamBN - 1) / kStreamBN),
                  static_cast<unsigned>(splits));
  kernel<<<grid, kStreamThreads, smem, stream>>>(g, ws, counters, splits);
  return cudaGetLastError();
}

template <typename Tout, int BN>
cudaError_t launch_wgmma(const GemmArgs& g, int splits, int segments,
                         float* ws, int* counters, cudaStream_t stream) {
  if (splits != 1 && splits != segments) return cudaErrorInvalidValue;
  if (BN == 256 && splits == 1 && segments > 1) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!bf16_map(&ma, g.a, g.M, g.K, g.sam, kWgBM) ||
      !bf16_map(&mb, g.b, g.K, g.N, g.sbk, kWgBK))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem_bytes(BN);
  static unsigned done = 0;
  const auto kernel = gemm_wgmma_kernel<Tout, BN>;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((g.N + BN - 1) / BN),
                  static_cast<unsigned>((g.M + kWgBM - 1) / kWgBM),
                  static_cast<unsigned>(splits));
  kernel<<<grid, kWgThreads, smem, stream>>>(ma, mb, g, ws, counters, splits,
                                             segments);
  return cudaGetLastError();
}

template <typename Tout, bool BNK>
cudaError_t launch_stream_tile(const GemmArgs& g, int bm, int splits, float* ws,
                               int* counters, cudaStream_t stream) {
  if (bm == 8) return launch_stream<Tout, 1, BNK>(g, splits, ws, counters, stream);
  if (bm == 16) return launch_stream<Tout, 2, BNK>(g, splits, ws, counters, stream);
  if (bm == 32) return launch_stream<Tout, 4, BNK>(g, splits, ws, counters, stream);
  if (bm == 64) return launch_stream<Tout, 8, BNK>(g, splits, ws, counters, stream);
  return cudaErrorInvalidValue;
}

// The fast paths take bf16 with op(A) rows contiguous and B rows contiguous,
// (K, N) N-contiguous or, on stream only, (N, K) K-contiguous (b_nk; checked
// here again; `plan` checks alignment too). Tiles: stream (8 MT, 64, 64)
// with M <= 8 MT, one CTA per segment (splits == segments); wgmma (128, 64 |
// 128 | 256, 64), spread (splits == segments) or walking (splits == 1).
template <typename Tout>
cudaError_t launch_fast(const GemmArgs& g, int path, int bm, int bn, int bk,
                        int splits, int segments, float* ws, int* counters,
                        cudaStream_t stream) {
  const int64_t kt = (g.K + 63) / 64;
  if (g.sak != 1 || (g.b_nk ? g.sbk : g.sbn) != 1 || g.K < 1 || splits < 1 ||
      segments < 1 || segments > kt ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (path == 1 && splits != segments) return cudaErrorInvalidValue;
  if (path == 1 && bn == kStreamBN && bk == kStreamBK && g.M <= bm)
    return g.b_nk ? launch_stream_tile<Tout, true>(g, bm, splits, ws, counters, stream)
                  : launch_stream_tile<Tout, false>(g, bm, splits, ws, counters, stream);
  if (g.b_nk) return cudaErrorInvalidValue;
  if (path == 2 && bm == kWgBM && bk == kWgBK) {
    if (bn == 256)
      return launch_wgmma<Tout, 256>(g, splits, segments, ws, counters, stream);
    if (bn == 128)
      return launch_wgmma<Tout, 128>(g, splits, segments, ws, counters, stream);
    if (bn == 64)
      return launch_wgmma<Tout, 64>(g, splits, segments, ws, counters, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename Kernel>
int smem_of(Kernel kernel, int dynamic_bytes) {
  cudaFuncAttributes attr{};
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return static_cast<int>(attr.sharedSizeBytes) + dynamic_bytes;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. path: 0 = general, 1 = stream,
// 2 = wgmma. b_nk: op(B) is an (N, K) K-contiguous matrix read through its
// strides (sbk = 1), taken by stream (and general, which reads any strides).
// Tile (bm, bn, bk) must be one the path instantiates: general
// (64, 64, 32); stream (8 | 16 | 32 | 64, 64, 64); wgmma (128, 64 | 128 |
// 256, 64).
// `segments` K segments (fast paths; see above), spread over `splits` CTAs
// per output tile (splits == segments) or walked by one (splits == 1, wgmma
// only). splits > 1 needs a (splits, M, N) fp32 workspace and one zeroed
// int32 counter per output tile; the kernel leaves them zeroed.
extern "C" int repro_tiled_matmul(const void* a, const void* b,
                                  const void* c_in, void* out, int64_t M,
                                  int64_t N, int64_t K, int64_t sam,
                                  int64_t sak, int64_t sbk, int64_t sbn,
                                  int64_t scm, int64_t scn, float alpha,
                                  float beta, int in_dtype, int out_dtype,
                                  int path, int bm, int bn, int bk, int splits,
                                  int segments, int b_nk, void* workspace,
                                  void* counters, void* stream) {
  const GemmArgs g{a,   b,   c_in, out,   M,    N,   K,   sam,
                   sak, sbk, sbn,  scm, scn, alpha, beta, b_nk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (path == 0) {
    if (in_dtype == 0 && out_dtype == 0)
      return launch_general<float, float>(g, bm, bn, bk, s);
    if (in_dtype == 0 && out_dtype == 1)
      return launch_general<float, __nv_bfloat16>(g, bm, bn, bk, s);
    if (in_dtype == 1 && out_dtype == 0)
      return launch_general<__nv_bfloat16, float>(g, bm, bn, bk, s);
    if (in_dtype == 1 && out_dtype == 1)
      return launch_general<__nv_bfloat16, __nv_bfloat16>(g, bm, bn, bk, s);
    return cudaErrorInvalidValue;
  }
  if (in_dtype != 1) return cudaErrorInvalidValue;
  if (out_dtype == 0)
    return launch_fast<float>(g, path, bm, bn, bk, splits, segments, ws, cnt,
                              s);
  if (out_dtype == 1)
    return launch_fast<__nv_bfloat16>(g, path, bm, bn, bk, splits, segments,
                                      ws, cnt, s);
  return cudaErrorInvalidValue;
}

// Shared memory one block of the tile uses, static plus dynamic, as the
// runtime reports it for the compiled kernel; -1 for a tile that is not
// compiled. `BlockConfig.smem_bytes` must give the same number.
extern "C" int repro_tiled_matmul_smem(int path, int in_dtype, int bm, int bn,
                                       int bk) {
  if (path == 0 && bm == 64 && bn == 64 && bk == 32)
    return in_dtype == 0
               ? smem_of(gemm_f32_kernel<float, 64, 64, 32>, 0)
               : smem_of(gemm_bf16_kernel<float, 64, 64, 32, true>, 0);
  if (in_dtype != 1 || bk != 64) return -1;
  if (path == 1 && bn == kStreamBN) {
    if (bm == 8) return smem_of(gemm_stream_kernel<float, 1, false>, stream_smem_bytes(8));
    if (bm == 16) return smem_of(gemm_stream_kernel<float, 2, false>, stream_smem_bytes(16));
    if (bm == 32) return smem_of(gemm_stream_kernel<float, 4, false>, stream_smem_bytes(32));
    if (bm == 64) return smem_of(gemm_stream_kernel<float, 8, false>, stream_smem_bytes(64));
  }
  if (path == 2 && bm == kWgBM) {
    if (bn == 256) return smem_of(gemm_wgmma_kernel<float, 256>, wgmma_smem_bytes(256));
    if (bn == 128) return smem_of(gemm_wgmma_kernel<float, 128>, wgmma_smem_bytes(128));
    if (bn == 64) return smem_of(gemm_wgmma_kernel<float, 64>, wgmma_smem_bytes(64));
  }
  return -1;
}
