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
// dtype, layout, alignment and M; each is one launch per GEMM (the split
// pair below: two).
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
// * wgmma (bf16, M > 64, or any M for a transposed A): the prefill chunks
//   and every training GEMM, bound by tensor-core FLOPs (989 TFLOP/s bf16)
//   from M ~ 300 up, and below that by the operand bytes. A 128 x BN x 64
//   tile, BN = 256, 128 or 64 (`plan` takes the widest whose tiles fill the
//   132 SMs: the wide tiles move fewer operand bytes per FLOP, the narrow
//   one needs fewer K-splits where N is small): one producer thread keeps
//   TMA loads of both operands in flight into a 4-stage ring of
//   128-byte-swizzled shared memory guarded by mbarriers, and two consumer
//   warpgroups each issue wgmma.m64nBNk16 from shared memory into fp32
//   registers. All four layouts of the TPU kernel run here (nn, nt, tn,
//   tt): op(A) is read K-major ((M, K) rows) or, transposed, MN-major ((K, M)
//   rows: the weight gradient's activations), op(B) MN-major ((K, N) rows)
//   or K-major ((N, K) rows: the input gradient's weight, a tied head's
//   table). wgmma transposes 16-bit operands as it reads them, so a layout
//   is a tensor map, a descriptor and an immediate, never a copy; every
//   layout moves the same bytes per stage. TMA zero-fills the boxes past
//   M, N and K, so only the epilogue masks.
// * split pair (one f32 operand, the other bf16, on wgmma): the backward of
//   an f32-out product of bf16 operands (the LM head, the MoE router),
//   whose cotangent is f32. `split3_kernel` writes the f32 operand's three
//   bf16 terms (hi, mid, lo: its whole significand), and the wgmma kernel
//   walks the three against each tile of the bf16 operand into one fp32
//   accumulator: three passes at the bf16 rate, with the f32 product's
//   accuracy (each term's product with a bf16 value is exact in fp32), not
//   TF32's. Bound by the same 2MNK at the bf16 rate, or by its bytes.
// * general (every other case: f32 x f32, unaligned or broadcast views,
//   K = 0): one 256-thread block per 64x64 output tile with the K loop
//   inside, masked strided loads prefetched into registers a K step ahead,
//   16-byte vector tiles where rows allow, WMMA 16x16x16 for bf16 and fp32
//   FMA on the CUDA cores for f32 (no TF32). It is the first version of
//   this kernel, kept for the cases the fast paths do not take.
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
// Plain C entry points (loaded with ctypes); each returns a cudaError_t
// after its launch. They launch on the caller's stream and allocate nothing.
//
// Sources: this file (the entry points, the general and stream paths, the
// split kernel and wgmma's nn instantiations); tiled_matmul.cuh (what the
// paths share, and the wgmma kernel); tiled_matmul_{nt,tn,tt}.cu (wgmma's
// transposed layouts) and tiled_matmul_split_{nn,nt,tn,tt}.cu (the split
// pair's kernels on each layout), each compiled in parallel with this file.
// The wgmma kernel's ring entries per K tile are a template parameter: one
// for the plain layouts, whose loop is the nn kernel's own, three for the
// split pair.

#include <mma.h>

#include <type_traits>

#include "tiled_matmul.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps per block, every tile shape

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
// The split of an f32 operand into three bf16 terms, for the split pair.

constexpr int kSplitThreads = 256, kSplitPerThread = 8;

// out[t][r][c] (planes of `plane` elements, rows of `ld`) for t = 0, 1, 2:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
// nearest even, with x = src[r * sr + c * sc]. Both differences are exact in
// f32, and for a normal x whose magnitude is at least 2^-102 the three terms
// hold its whole 24-bit significand: hi + mid + lo == x. Elementwise, bound
// by its bytes (4 read, 6 written per element); each thread takes 8 columns
// of one row at a stride of 256, so a warp's loads and stores coalesce.
__global__ void __launch_bounds__(kSplitThreads)
    split3_kernel(const float* __restrict__ src, int64_t R, int64_t C,
                  int64_t sr, int64_t sc, __nv_bfloat16* __restrict__ out,
                  int64_t ld, int64_t plane) {
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y) {
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kSplitThreads *
                           kSplitPerThread + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kSplitPerThread; ++j) {
      const int64_t c = c0 + j * kSplitThreads;
      if (c >= C) break;
      const float x = src[r * sr + c * sc];
      const __nv_bfloat16 hi = __float2bfloat16(x);
      const float r1 = x - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16(r1);
      const __nv_bfloat16 lo = __float2bfloat16(r1 - __bfloat162float(mid));
      __nv_bfloat16* o = out + r * ld + c;
      o[0] = hi;
      o[plane] = mid;
      o[2 * plane] = lo;
    }
  }
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

template <typename Tout, bool BNK>
cudaError_t launch_stream_tile(const GemmArgs& g, int bm, int splits, float* ws,
                               int* counters, cudaStream_t stream) {
  if (bm == 8) return launch_stream<Tout, 1, BNK>(g, splits, ws, counters, stream);
  if (bm == 16) return launch_stream<Tout, 2, BNK>(g, splits, ws, counters, stream);
  if (bm == 32) return launch_stream<Tout, 4, BNK>(g, splits, ws, counters, stream);
  if (bm == 64) return launch_stream<Tout, 8, BNK>(g, splits, ws, counters, stream);
  return cudaErrorInvalidValue;
}

// The fast paths take bf16 whose op(A) and op(B) are each contiguous along
// one of their dimensions (checked here again; `plan` checks alignment
// too): op(A) K-contiguous, or on wgmma only M-contiguous (a_mn); op(B)
// N-contiguous, or K-contiguous (b_nk). Tiles: stream (8 MT, 64, 64) with
// M <= 8 MT, one CTA per segment (splits == segments), K-contiguous op(A)
// and no split operand; wgmma (128, 64 | 128 | 256, 64), spread (splits ==
// segments) or walking (splits == 1), any of the four layouts, with or
// without a split operand (split_of).
template <typename Tout>
cudaError_t launch_fast(const GemmArgs& g, int path, int bm, int bn, int bk,
                        int splits, int segments, float* ws, int* counters,
                        int split_of, int64_t s_plane, cudaStream_t stream) {
  const int64_t kt = (g.K + 63) / 64;
  if ((g.a_mn ? g.sam : g.sak) != 1 || (g.b_nk ? g.sbk : g.sbn) != 1 ||
      g.K < 1 || splits < 1 || segments < 1 || segments > kt ||
      split_of < 0 || split_of > 2 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (path == 1 && (splits != segments || g.a_mn || split_of))
    return cudaErrorInvalidValue;
  if (path == 1 && bn == kStreamBN && bk == kStreamBK && g.M <= bm)
    return g.b_nk ? launch_stream_tile<Tout, true>(g, bm, splits, ws, counters, stream)
                  : launch_stream_tile<Tout, false>(g, bm, splits, ws, counters, stream);
  if (path == 2 && bm == kWgBM && bk == kWgBK) {
    if (!g.a_mn && !g.b_nk && !split_of)
      return launch_wgmma_tile<Tout, false, false, 1>(
          g, bn, splits, segments, ws, counters, split_of, s_plane, stream);
    const int out = std::is_same<Tout, float>::value ? 0 : 1;
    const auto layout =
        split_of ? (g.a_mn ? (g.b_nk ? repro_wgmma_split_tt : repro_wgmma_split_tn)
                           : (g.b_nk ? repro_wgmma_split_nt : repro_wgmma_split_nn))
                 : (g.a_mn ? (g.b_nk ? repro_wgmma_tt : repro_wgmma_tn)
                           : repro_wgmma_nt);
    return layout(g, out, bn, splits, segments, ws, counters, split_of,
                  s_plane, stream);
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
// strides (sbk = 1), taken by stream and wgmma (and general, which reads
// any strides); a_mn: op(A) is a (K, M) M-contiguous matrix (sam = 1), taken
// by wgmma. Tile (bm, bn, bk) must be one the path instantiates: general
// (64, 64, 32); stream (8 | 16 | 32 | 64, 64, 64); wgmma (128, 64 | 128 |
// 256, 64).
// `segments` K segments (fast paths; see above), spread over `splits` CTAs
// per output tile (splits == segments) or walked by one (splits == 1, wgmma
// only). splits > 1 needs a (splits, M, N) fp32 workspace and one zeroed
// int32 counter per output tile; the kernel leaves them zeroed.
// split_of (wgmma): 1 or 2 when A or B is the three bf16 terms of an f32
// matrix (`repro_split3`), stored as planes `s_plane` elements apart, each
// plane with the operand's strides; 0 otherwise.
extern "C" int repro_tiled_matmul(const void* a, const void* b,
                                  const void* c_in, void* out, int64_t M,
                                  int64_t N, int64_t K, int64_t sam,
                                  int64_t sak, int64_t sbk, int64_t sbn,
                                  int64_t scm, int64_t scn, float alpha,
                                  float beta, int in_dtype, int out_dtype,
                                  int path, int bm, int bn, int bk, int splits,
                                  int segments, int b_nk, int a_mn,
                                  int split_of, int64_t s_plane,
                                  void* workspace, void* counters,
                                  void* stream) {
  const GemmArgs g{a,   b,   c_in, out,   M,    N,    K,   sam,
                   sak, sbk, sbn,  scm, scn, alpha, beta, b_nk, a_mn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (path == 0) {
    if (split_of) return cudaErrorInvalidValue;
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
                              split_of, s_plane, s);
  if (out_dtype == 1)
    return launch_fast<__nv_bfloat16>(g, path, bm, bn, bk, splits, segments,
                                      ws, cnt, split_of, s_plane, s);
  return cudaErrorInvalidValue;
}

// The split pair's first launch: the f32 (R, C) matrix src[r * sr + c * sc]
// into its three bf16 terms, out[t * plane + r * ld + c] (`split3_kernel`).
// ld >= C; the columns past C are not written.
extern "C" int repro_split3(const void* src, int64_t R, int64_t C, int64_t sr,
                            int64_t sc, void* out, int64_t ld, int64_t plane,
                            void* stream) {
  if (R < 1 || C < 1 || ld < C || plane < R * ld) return cudaErrorInvalidValue;
  const int64_t per_block = kSplitThreads * kSplitPerThread;
  const dim3 grid(static_cast<unsigned>((C + per_block - 1) / per_block),
                  static_cast<unsigned>(R < 65535 ? R : 65535));
  split3_kernel<<<grid, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), R, C, sr, sc,
      static_cast<__nv_bfloat16*>(out), ld, plane);
  return cudaGetLastError();
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
    if (bn == 256) return smem_of(gemm_wgmma_kernel<float, 256, false, false, 1>, wgmma_smem_bytes(256));
    if (bn == 128) return smem_of(gemm_wgmma_kernel<float, 128, false, false, 1>, wgmma_smem_bytes(128));
    if (bn == 64) return smem_of(gemm_wgmma_kernel<float, 64, false, false, 1>, wgmma_smem_bytes(64));
  }
  return -1;
}
