// What the GEMM's paths share, and the wgmma path: included by
// tiled_matmul.cu (the entry points, the general and stream paths, the
// split kernel and wgmma's nn instantiations) and by the units
// of wgmma's transposed layouts, tiled_matmul_{nt,tn,tt}.cu, which nvcc
// compiles beside it in parallel (`kernels/_build.py`). tiled_matmul.cu's
// header says what each path does and what bounds it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// The GEMM's arguments, one definition for every unit.
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
  int a_mn;          // wgmma: A stored (K, M), M-contiguous (sam == 1)
};

namespace {

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

// The same from a 3-D map (c2: the plane), for the three bf16 terms of a
// split f32 operand, stored as planes of one (3, rows, cols) array.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A box of an operand of a kernel with TERMS ring entries per K tile: with
// one, always of a 2-D map (the plain layouts compile to tma_load_2d alone);
// with three, of a 2-D map (plane < 0, the bf16 operand) or of plane `plane`
// of a 3-D map (the split operand's terms).
template <int TERMS>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int plane,
                                         uint64_t* bar) {
  if constexpr (TERMS == 1)
    tma_load_2d(dst, map, c0, c1, bar);
  else if (plane < 0)
    tma_load_2d(dst, map, c0, c1, bar);
  else
    tma_load_3d(dst, map, c0, c1, plane, bar);
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128-byte swizzle. K-major: rows of 64 k at 128 bytes (one row per m or
// n), 8-row groups at SBO = 1024, LBO unused. MN-major: 64 m or n per
// 128-byte row, one row per k, 8-k groups at SBO = 1024 and the next 64 m
// or n (the next TMA box) at LBO.
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

// d (64 x N fp32, the warpgroup's accumulator fragment) += A * B, both
// scales 1, accumulate. TA and TB are the transpose immediates: 0 reads the
// operand K-major, 1 MN-major (the hardware transposes 16-bit operands as it
// reads them, at no cost).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
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
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16<TA, TB>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_m64n128k16<TA, TB>(d, da, db);
  else
    wgmma_m64n64k16<TA, TB>(d, da, db);
}

// One CTA: output tile [m0, m0 + 128) x [n0, n0 + BN) over the K tiles of
// split blockIdx.z. Warps 0-7 are two consumer warpgroups (rows 0-63 and
// 64-127 of the tile); lane 0 of warp 8 is the TMA producer. With
// splits == 1 and segments > 1 the CTA walks all `segments` K segments,
// summing each from zero and adding it into a running total (not compiled
// for BN = 256); otherwise splits == segments and the CTA owns one.
//
// A_MN: op(A) is stored (K, M), M-contiguous (a transposed A), and its
// stage holds two MN-major 64 x 64 boxes, one per consumer warpgroup; else
// one K-major 128 x 64 box. B_K: op(B) is stored (N, K), K-contiguous, and
// its stage holds one K-major BN x 64 box; else BN / 64 MN-major 64 x 64
// boxes. Either way a stage is the same bytes and the same wgmma sequence;
// only the descriptors and the transpose immediates differ.
//
// TERMS = 3 (the split pair): operand split_of (1: A, 2: B) is the three
// bf16 terms of an f32 matrix (hi, mid, lo: `split3_kernel`), the planes of
// a 3-D map. Every K tile then fills three ring entries, one per term,
// against the same tile of the other operand, and the three products go
// into the same fp32 accumulator: each term times a bf16 value is exact in
// fp32, so the sum is the f32 product's up to the order of the additions.
// TERMS = 1: one entry per K tile, split_of is 0 and unread, and the loop
// is the plain layouts' own.
template <typename Tout, int BN, bool A_MN, bool B_K, int TERMS>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const GemmArgs g, float* __restrict__ ws,
                      int* __restrict__ counters, int splits, int segments,
                      int split_of) {
  constexpr int BM = kWgBM, BK = kWgBK, S = kWgStages;
  constexpr int A_BYTES = BM * BK * 2, BOX_BYTES = BK * 64 * 2;
  constexpr int STAGE = A_BYTES + BK * BN * 2;
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma tile width");
  static_assert(TERMS == 1 || TERMS == 3, "ring entries per K tile");
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
  // ring entries of this CTA: TERMS per K tile
  const int nt = TERMS * static_cast<int>(kt * (split + 1) / splits - t0);

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
        const int k0 = static_cast<int>((t0 + i / TERMS) * BK);
        const int term = i % TERMS;
        const int pa = split_of == 1 ? term : -1, pb = split_of == 2 ? term : -1;
        mbar_expect_tx(&full[s], STAGE);
        if constexpr (A_MN) {
#pragma unroll
          for (int j = 0; j < BM / 64; ++j)
            tma_load<TERMS>(st + j * BOX_BYTES, &tma_a,
                            static_cast<int>(m0) + 64 * j, k0, pa, &full[s]);
        } else {
          tma_load<TERMS>(st, &tma_a, k0, static_cast<int>(m0), pa, &full[s]);
        }
        if constexpr (B_K) {
          tma_load<TERMS>(st + A_BYTES, &tma_b, k0, static_cast<int>(n0), pb,
                          &full[s]);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load<TERMS>(st + A_BYTES + j * BOX_BYTES, &tma_b,
                            static_cast<int>(n0) + 64 * j, k0, pb, &full[s]);
        }
      }
    }
  } else {
    // walk: the running total of the segments before the current one, and
    // the ring entry where the next segment starts
    constexpr bool kCanWalk = BN != 256;
    float total[kCanWalk ? BN / 2 : 1];
    int seg = 1;
    int64_t next = TERMS * (kt * seg / segments);
    if constexpr (kCanWalk) {
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) total[r] = 0.0f;
    }
    // 16 k per wgmma: 32 bytes along a K-major operand's rows, 16 rows
    // (2048 bytes) of an MN-major one
    constexpr int A_STEP = A_MN ? 128 : 2, B_STEP = B_K ? 2 : 128;
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
          next = TERMS * (kt * ++seg / segments);
        }
      }
      mbar_wait(&full[s], (i / S) & 1);
      const unsigned char* st = ring + s * STAGE;
      const uint64_t da = A_MN ? make_desc(st + wg * BOX_BYTES, BOX_BYTES, 1024)
                               : make_desc(st + wg * 64 * 128, 16, 1024);
      const uint64_t db = B_K ? make_desc(st + A_BYTES, 16, 1024)
                              : make_desc(st + A_BYTES, BOX_BYTES, 1024);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN, A_MN ? 1 : 0, B_K ? 0 : 1>(acc, da + A_STEP * kk,
                                                  db + B_STEP * kk);
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
// zero fill outside the matrix. With planes = 3, of a split operand's
// (3, rows, cols) terms, planes `plane` elements apart, boxes one plane
// deep.
bool bf16_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
              int64_t ld, uint32_t box_rows, int planes, int64_t plane) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(plane) * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, planes > 1 ? 3 : 2,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The driver encodes a tensor map only on a host thread with a current
// context, and the runtime binds the device's primary context to a thread
// at the first call that needs one: a thread whose first call into this
// library is a wgmma launch (autograd runs the backward on a thread of its
// own) would encode its maps before any. So the launch binds it first, once
// per thread.
inline cudaError_t bind_context() {
  static thread_local bool bound = false;
  if (bound) return cudaSuccess;
  const cudaError_t err = cudaFree(nullptr);
  bound = err == cudaSuccess;
  return err;
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

// The maps follow each operand's majorness: a K-major A is (M, K) in boxes
// of 128 rows, an MN-major A (K, M) in boxes of 64 k rows (two per stage);
// a K-major B is (N, K) in boxes of BN rows, an MN-major B (K, N) in boxes
// of 64 k rows (BN / 64 per stage). The split operand's map is 3-D
// (TERMS = 3, split_of 1 or 2); with TERMS = 1 split_of must be 0.
template <typename Tout, int BN, bool A_MN, bool B_K, int TERMS>
cudaError_t launch_wgmma(const GemmArgs& g, int splits, int segments,
                         float* ws, int* counters, int split_of,
                         int64_t s_plane, cudaStream_t stream) {
  if (splits != 1 && splits != segments) return cudaErrorInvalidValue;
  if (BN == 256 && splits == 1 && segments > 1) return cudaErrorInvalidValue;
  if ((TERMS == 1) != (split_of == 0)) return cudaErrorInvalidValue;
  const int pa = split_of == 1 ? 3 : 1, pb = split_of == 2 ? 3 : 1;
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  CUtensorMap ma, mb;
  const bool ok_a =
      A_MN ? bf16_map(&ma, g.a, g.K, g.M, g.sak, kWgBK, pa, s_plane)
           : bf16_map(&ma, g.a, g.M, g.K, g.sam, kWgBM, pa, s_plane);
  const bool ok_b =
      B_K ? bf16_map(&mb, g.b, g.N, g.K, g.sbn, BN, pb, s_plane)
          : bf16_map(&mb, g.b, g.K, g.N, g.sbk, kWgBK, pb, s_plane);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem_bytes(BN);
  static unsigned done = 0;
  const auto kernel = gemm_wgmma_kernel<Tout, BN, A_MN, B_K, TERMS>;
  err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((g.N + BN - 1) / BN),
                  static_cast<unsigned>((g.M + kWgBM - 1) / kWgBM),
                  static_cast<unsigned>(splits));
  kernel<<<grid, kWgThreads, smem, stream>>>(ma, mb, g, ws, counters, splits,
                                             segments, split_of);
  return cudaGetLastError();
}

template <typename Tout, bool A_MN, bool B_K, int TERMS>
cudaError_t launch_wgmma_tile(const GemmArgs& g, int bn, int splits,
                              int segments, float* ws, int* counters,
                              int split_of, int64_t s_plane,
                              cudaStream_t stream) {
  if (bn == 256)
    return launch_wgmma<Tout, 256, A_MN, B_K, TERMS>(
        g, splits, segments, ws, counters, split_of, s_plane, stream);
  if (bn == 128)
    return launch_wgmma<Tout, 128, A_MN, B_K, TERMS>(
        g, splits, segments, ws, counters, split_of, s_plane, stream);
  if (bn == 64)
    return launch_wgmma<Tout, 64, A_MN, B_K, TERMS>(
        g, splits, segments, ws, counters, split_of, s_plane, stream);
  return cudaErrorInvalidValue;
}

// One layout's wgmma launch at output dtype code `out_dtype` (0 f32, 1 bf16)
// and tile width `bn`, with TERMS ring entries per K tile.
template <bool A_MN, bool B_K, int TERMS>
cudaError_t launch_wgmma_layout(const GemmArgs& g, int out_dtype, int bn,
                                int splits, int segments, float* ws,
                                int* counters, int split_of, int64_t s_plane,
                                cudaStream_t stream) {
  if (out_dtype == 0)
    return launch_wgmma_tile<float, A_MN, B_K, TERMS>(
        g, bn, splits, segments, ws, counters, split_of, s_plane, stream);
  if (out_dtype == 1)
    return launch_wgmma_tile<__nv_bfloat16, A_MN, B_K, TERMS>(
        g, bn, splits, segments, ws, counters, split_of, s_plane, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// wgmma's transposed layouts, each defined in its own unit
// (tiled_matmul_nt.cu: op(B) stored (N, K); _tn.cu: op(A) stored (K, M);
// _tt.cu: both), and the split pair's kernels of each of the four layouts
// (tiled_matmul_split_{nn,nt,tn,tt}.cu), with `launch_wgmma_layout`'s
// arguments.
#define REPRO_WGMMA_LAYOUT(name)                                              \
  cudaError_t name(const GemmArgs& g, int out_dtype, int bn, int splits,      \
                   int segments, float* ws, int* counters, int split_of,     \
                   int64_t s_plane, cudaStream_t stream)
REPRO_WGMMA_LAYOUT(repro_wgmma_nt);
REPRO_WGMMA_LAYOUT(repro_wgmma_tn);
REPRO_WGMMA_LAYOUT(repro_wgmma_tt);
REPRO_WGMMA_LAYOUT(repro_wgmma_split_nn);
REPRO_WGMMA_LAYOUT(repro_wgmma_split_nt);
REPRO_WGMMA_LAYOUT(repro_wgmma_split_tn);
REPRO_WGMMA_LAYOUT(repro_wgmma_split_tt);
