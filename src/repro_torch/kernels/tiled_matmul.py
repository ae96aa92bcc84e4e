"""Host wrapper of the hand-written Hopper GEMM (``csrc/tiled_matmul.cu``).

The counterpart of the JAX package's Pallas ``tiled_matmul``: the same
BLAS-3 surface, ``C = alpha * op(A) @ op(B) + beta * C`` with fp32
accumulation. Where the TPU wrapper zero-pads operands to block multiples,
this one hands the kernel strides and shapes; the kernel masks the ragged
edge itself, and the transposed layouts are strides, not copies.

The kernel has three paths, and `plan` picks one per call from dtype,
layout, alignment and shape: ``stream`` (split-K weight streaming for
M <= 64, the decode GEMMs, with B stored (K, N) or, for a tied LM head,
(N, K)), ``wgmma`` (TMA and warpgroup MMA for M > 64, the prefill chunks)
and ``general`` (everything else: f32, transposed A, a transposed B at
M > 64, unaligned views). On both fast paths a row's bits do not depend on
M: K is cut into segments by (N, K) alone (`k_segments`), which both paths
sum in the same order.

A CPU tensor is computed by the plain version (`ref.matmul_ref`); a CUDA
tensor launches the kernel or raises. ``tiled_matmul.launches`` counts the
kernel launches, ``tiled_matmul.launches_by_path`` the launches per path.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ref import matmul_ref

GENERAL, STREAM, WGMMA = "general", "stream", "wgmma"
_PATH_CODE = {GENERAL: 0, STREAM: 1, WGMMA: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# every compiled tile, (block_m, block_n, block_k), and the path it belongs
# to; a stream tile's block_m is the activation rows it pads M up to
TILE_PATHS = {
    (64, 64, 32): GENERAL,
    (8, 64, 64): STREAM, (16, 64, 64): STREAM, (32, 64, 64): STREAM,
    (64, 64, 64): STREAM,
    (128, 256, 64): WGMMA, (128, 128, 64): WGMMA, (128, 64, 64): WGMMA,
}
TILE_SHAPES = tuple(TILE_PATHS)
FAST_STAGES = 4      # shared-memory ring depth of both fast paths
STREAM_MAX_M = 64    # the stream path takes M <= 64, wgmma M > 64
WAVE_CTAS = 132      # the H100's SMs: tiles x splits should cover them
STREAM_WAVES = 4
# H100 SXM dense bf16 tensor-core rate and HBM rate (NVIDIA data sheet): a
# GEMM whose FLOPs take longer than its bytes is bound by operations
PEAK_BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
MIN_SPLIT_K_TILES = 2
FAST_BLOCK_K = 64    # the K step of every fast-path tile
# K segments are sized for the decode GEMMs: the 8-row stream tile
SEGMENT_ROWS = 8
# wgmma spreads a shape's segments over CTAs (one each) only where its tiles
# cover less than half a wave and tiles x segments stay within 4 waves;
# elsewhere one CTA walks all of a tile's segments
SPREAD_MAX_CTAS = STREAM_WAVES * WAVE_CTAS
_MAX_GRID_Y = 65535


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One thread block's output tile and K step — the Hopper analogue of
    the TPU's VMEM block config. Only the shapes in `TILE_SHAPES` are
    compiled into the kernel; each belongs to one path."""

    block_m: int = 64
    block_n: int = 64
    block_k: int = 32

    @property
    def path(self) -> str | None:
        """The kernel path that compiles this tile (None: not compiled)."""
        return TILE_PATHS.get(self.as_tuple())

    def smem_bytes(self, in_bytes: int = 2) -> int:
        """Shared memory of one block, static plus dynamic.

        general: the padded A and B tiles (static), plus (bf16) the eight
        warps' 16x16 fp32 epilogue staging tiles. stream: a ring of
        `FAST_STAGES` (block_k x block_n) weight and (block_m x block_k)
        activation tiles plus a 16-byte split flag. wgmma: 1024 bytes of
        alignment slack, the ring of (block_m x block_k) A and
        (block_k x block_n) B tiles, two 8-byte mbarriers per stage and the
        flag. The fast paths' memory is dynamic and above 48 KB, so the
        kernel opts into it once per instantiation."""
        bm, bn, bk = self.as_tuple()
        if self.path == STREAM:
            return FAST_STAGES * (bk * bn + bm * bk) * 2 + 16
        if self.path == WGMMA:
            return (1024 + FAST_STAGES * (bm * bk + bk * bn) * 2
                    + 16 * FAST_STAGES + 16)
        if in_bytes == 4:   # f32 path: A tile padded by one column
            return 4 * (bm * (bk + 1) + bk * bn)
        return in_bytes * (bm * (bk + 8) + bk * (bn + 8)) + 8 * 16 * 16 * 4

    def as_tuple(self) -> tuple[int, int, int]:
        """(block_m, block_n, block_k)."""
        return (self.block_m, self.block_n, self.block_k)


DEFAULT_CONFIG = BlockConfig(64, 64, 32)   # the general path's tile
_STREAM_TILES = [BlockConfig(*t) for t, p in TILE_PATHS.items() if p == STREAM]
_WGMMA_TILES = [BlockConfig(*t) for t, p in TILE_PATHS.items() if p == WGMMA]


def candidate_tiles(m: int) -> list[BlockConfig]:
    """Every compiled fast-path tile that can take an M-row GEMM of the fast
    layout: for M <= 64 the narrowest stream tile that holds M, then every
    wgmma tile (which takes any M)."""
    stream = [t for t in _STREAM_TILES if t.block_m >= m][:1]
    return stream + _WGMMA_TILES


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which path a GEMM takes, with which tile, its K segments and the
    CTAs each output tile's segments are spread over (`splits`: one CTA
    per segment, or 1 where a CTA walks them all)."""

    path: str
    tile: BlockConfig
    splits: int
    segments: int = 1
    b_nk: bool = False     # stream reads B stored (N, K), K-contiguous

    def tiles(self, m: int, n: int) -> int:
        """Output tiles of an (m, n) product: the grid without splits."""
        return -(-m // self.tile.block_m) * -(-n // self.tile.block_n)


def _require_compiled(config: BlockConfig | None) -> None:
    if config is not None and config.path is None:
        raise ValueError(f"block config {config.as_tuple()} is not compiled; "
                         f"choose one of {TILE_SHAPES}")


def _fast_a(k, a_strides, a_ptr_mod16, in_dtype) -> bool:
    return (in_dtype == torch.bfloat16 and k >= 1 and a_strides[1] == 1
            and a_strides[0] % 8 == 0 and a_strides[0] >= k
            and a_ptr_mod16 == 0)


def _fast_layout(n, k, a_strides, b_strides, a_ptr_mod16, b_ptr_mod16,
                 in_dtype) -> bool:
    """Both fast paths' layout: B rows N-contiguous, op(B) strides
    (ldb, 1)."""
    return (_fast_a(k, a_strides, a_ptr_mod16, in_dtype)
            and b_strides[1] == 1 and b_strides[0] % 8 == 0
            and b_strides[0] >= n and b_ptr_mod16 == 0)


def _nk_layout(n, k, a_strides, b_strides, a_ptr_mod16, b_ptr_mod16,
               in_dtype) -> bool:
    """``stream``'s second layout: B stored (N, K) with K-contiguous rows,
    op(B) strides (1, ldb) (a tied LM head's embedding table)."""
    return (_fast_a(k, a_strides, a_ptr_mod16, in_dtype)
            and b_strides[0] == 1 and b_strides[1] % 8 == 0
            and b_strides[1] >= k and b_ptr_mod16 == 0)


def k_segments(n: int, k: int) -> int:
    """The K segments of an (N, K) fast-path product: a function of N and K
    alone, so every M sums a row in the same order. Sized for the decode
    GEMMs on the 8-row stream tile, one CTA per segment: enough that the
    N / 64 column tiles x segments cover a wave of 132 CTAs, and up to 4
    waves to keep more weight bytes in flight while the fp32 partials (8
    bytes per output per segment, written and read back) stay under a
    quarter of the weight bytes (segments <= K / 128); never so many that a
    segment gets fewer than 2 K tiles of 64."""
    tiles = -(-n // 64)
    one_wave = -(-WAVE_CTAS // tiles)
    want = max(one_wave, min(-(-STREAM_WAVES * WAVE_CTAS // tiles),
                             k // (16 * SEGMENT_ROWS)))
    return max(1, min(want, -(-k // FAST_BLOCK_K) // MIN_SPLIT_K_TILES))


def _wgmma_splits(tile: BlockConfig, tiles: int, segments: int) -> int:
    """1 (one CTA walks a tile's segments) or `segments` (one CTA each)."""
    if segments > 1 and tile.block_n == 256:
        return segments            # no registers for a walk's running total
    if tiles >= WAVE_CTAS // 2 or tiles * segments > SPREAD_MAX_CTAS:
        return 1
    return segments


def _wgmma_tile(m: int, n: int, k: int, out_dtype,
                segments: int) -> BlockConfig:
    out_bytes = 4 if out_dtype == torch.float32 else 2
    ops_bound = (2 * m * n * k / PEAK_BF16_FLOPS
                 > (2 * (m * k + k * n) + out_bytes * m * n) / HBM_BYTES_PER_S)
    tiles = [t for t in _WGMMA_TILES if not (ops_bound and t.block_n == 64)]
    choice = tiles[-1]
    for need in (WAVE_CTAS, WAVE_CTAS // 2):     # widest first
        fits = [t for t in tiles if Plan(WGMMA, t, 1).tiles(m, n) >= need]
        if fits:
            choice = fits[0]
            break
    if choice.block_n == 256 and segments > 1:   # it cannot walk segments
        choice = BlockConfig(128, 128, 64)
    return choice


def plan(m: int, n: int, k: int, a_strides, b_strides, a_ptr_mod16: int,
         b_ptr_mod16: int, in_dtype: torch.dtype, out_dtype: torch.dtype,
         config: BlockConfig | None = None) -> Plan:
    """Choose the kernel path, tile, K segments and CTA splits of
    C = op(A) @ op(B).

    `a_strides` are op(A)'s (m, k) strides and `b_strides` op(B)'s (k, n)
    strides, in elements; the `*_ptr_mod16` are the base addresses modulo
    16. The rule:

    - The fast paths take bf16 inputs (f32 or bf16 out) whose op(A) rows
      are K-contiguous and whose B rows are N-contiguous (every projection
      of the serving path), with row strides that are multiples of 8
      elements and no shorter than the row, 16-byte aligned bases and
      K >= 1. ``stream`` also takes B stored (N, K) with K-contiguous rows
      under the same tests (op(B) strides (1, ldb): a tied LM head's
      embedding table, `ops.matmul(..., transpose_b=True)`) where M <= 64;
      that layout at M > 64 (training) takes ``general``, as does
      everything else, with `DEFAULT_CONFIG`.
    - Among the fast paths, M <= 64 takes ``stream`` with the narrowest
      activation tile that holds M (8, 16, 32 or 64 rows); M > 64 takes
      ``wgmma`` with the widest tile (128 x 256, 128 or 64) whose output
      tiles alone cover a wave of 132 CTAs, else the widest whose tiles
      cover half a wave, else the narrowest. A GEMM bound by operations
      (2MNK at 989 TFLOP/s longer than its bytes at 3.35 TB/s) skips the
      64-wide tile, which moves 1.5x the operand bytes per FLOP of the
      128-wide one; a shape of more than one K segment takes 128 x 128
      where the rule picks 128 x 256, whose CTA has no registers to walk
      segments.
    - K segments: `k_segments(N, K)`, whatever M and the path. ``stream``
      gives each segment a CTA (splits = segments). ``wgmma`` does the same
      where its tiles cover less than half a wave and tiles x segments stay
      within 4 waves (528 CTAs), and otherwise walks a tile's segments in
      one CTA (splits = 1).

    So a row's result is the same at every M and on both fast paths: the
    segments are summed from zero in order on both, and the H100's
    mma.sync and wgmma give the same fp32 sum over a segment (the
    row-invariance check of ``chip_smoke.py``'s phase 3 and
    ``tests/test_torch_cuda.py``). The (N, K) layout on ``stream`` issues
    the same mma.sync sequence on the same values as the (K, N) one, so a
    tied head's row has the same bits at every M <= 64 (serving never
    unembeds more than 2 x max_batch rows in one call). ``general`` is
    exempt: it serves no serving launch (``chip_smoke.py`` checks 0 on it
    in every serving run), only f32, transposed and unaligned operands.

    A `config` forces its tile (and so its path); it raises ValueError if
    the tile is not compiled or its path cannot take this GEMM. A forced
    128 x 256 tile spreads its segments."""
    _require_compiled(config)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    fast = _fast_layout(n, k, a_strides, b_strides, a_ptr_mod16, b_ptr_mod16,
                        in_dtype)
    nk = not fast and _nk_layout(n, k, a_strides, b_strides, a_ptr_mod16,
                                 b_ptr_mod16, in_dtype)
    if config is not None and config.path == GENERAL:
        return Plan(GENERAL, config, 1)
    if config is None and not (fast or (nk and m <= STREAM_MAX_M)):
        return Plan(GENERAL, DEFAULT_CONFIG, 1)
    if not (fast or (nk and (config is None or config.path == STREAM))):
        raise ValueError(
            f"the {config.path} tile {config.as_tuple()} takes bf16 inputs "
            "with K-contiguous op(A) rows and N-contiguous B rows (stream "
            "also K-contiguous (N, K) B), 16-byte aligned; this GEMM takes "
            "the general path")
    segments = k_segments(n, k)
    if config is None:
        if m <= STREAM_MAX_M:
            config = next(t for t in _STREAM_TILES if t.block_m >= m)
        else:
            config = _wgmma_tile(m, n, k, out_dtype, segments)
    if config.path == STREAM and m > config.block_m:
        raise ValueError(f"the stream tile {config.as_tuple()} holds at most "
                         f"{config.block_m} rows, not {m}")
    if config.path == STREAM:
        return Plan(STREAM, config, segments, segments, b_nk=nk)
    tiles = Plan(WGMMA, config, 1).tiles(m, n)
    return Plan(WGMMA, config, _wgmma_splits(config, tiles, segments),
                segments)


# one int32 counter per output tile for the split-K hand-off, per device;
# every launch leaves them at zero
_COUNTERS: dict[int, torch.Tensor] = {}


def _tile_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


def _launch(a, b, c_in, out, m, n, k, sa, sb, sc, alpha, beta, p: Plan):
    from repro_torch.kernels._build import load_library

    ws = counters = None
    if p.splits > 1:
        ws = torch.empty(p.splits * m * n, dtype=torch.float32,
                         device=a.device)
        counters = _tile_counters(a.device, p.tiles(m, n))
    lib = load_library()
    err = lib.repro_tiled_matmul(
        a.data_ptr(), b.data_ptr(),
        c_in.data_ptr() if c_in is not None else None, out.data_ptr(),
        m, n, k, sa[0], sa[1], sb[0], sb[1], sc[0], sc[1],
        float(alpha), float(beta),
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out.dtype], _PATH_CODE[p.path],
        *p.tile.as_tuple(), p.splits, p.segments, int(p.b_nk),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul launch failed ({p}): cudaError "
                           f"{err}")


def tiled_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor | None = None,
    *,
    config: BlockConfig | None = None,
    transpose_a: bool = False,
    transpose_b: bool = False,
    alpha: float = 1.0,
    beta: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C  (the paper's GEMM surface).

    a: (M, K), or (K, M) if transpose_a; b: (K, N), or (N, K) if
    transpose_b. Inputs float32 or bfloat16 (both the same), output float32
    or bfloat16 (default ``a.dtype``). `c` (M, N) is rounded to `out_dtype`
    before the beta term, as the TPU kernel does. `config` forces a
    compiled tile (see `plan`); by default `plan` chooses."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("tiled_matmul expects rank-2 operands")
    m, ka = (a.shape[1], a.shape[0]) if transpose_a else a.shape
    n, kb = (b.shape[0], b.shape[1]) if transpose_b else b.shape[::-1]
    if ka != kb:
        raise ValueError(f"contraction mismatch: {ka} vs {kb}")
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")
    if c is not None and tuple(c.shape) != (m, n):
        raise ValueError(f"c has shape {tuple(c.shape)}, expected {(m, n)}")
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"inputs must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    _require_compiled(config)
    c_in = c.to(out_dtype) if c is not None and beta != 0.0 else None
    devices = {t.device for t in (a, b, c_in) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if a.device.type == "cpu":
        return matmul_ref(a, b, c_in, transpose_a=transpose_a,
                          transpose_b=transpose_b, alpha=alpha, beta=beta,
                          out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul runs on cuda or cpu, not {a.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    sa = a.stride()[::-1] if transpose_a else a.stride()      # (m, k)
    sb = b.stride()[::-1] if transpose_b else b.stride()      # (k, n)
    sc = c_in.stride() if c_in is not None else (0, 0)
    p = plan(m, n, ka, sa, sb, a.data_ptr() % 16, b.data_ptr() % 16,
             a.dtype, out_dtype, config=config)
    if p.path != STREAM and -(-m // p.tile.block_m) > _MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the grid's row-block limit")
    _launch(a, b, c_in, out, m, n, ka, sa, sb, sc, alpha, beta, p)
    tiled_matmul.launches += 1
    tiled_matmul.launches_by_path[p.path] += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.launches_by_path = {STREAM: 0, WGMMA: 0, GENERAL: 0}
