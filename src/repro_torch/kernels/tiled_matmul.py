"""Host wrapper of the hand-written Hopper GEMM (``csrc/tiled_matmul.cu``).

The counterpart of the JAX package's Pallas ``tiled_matmul``: the same
BLAS-3 surface, ``C = alpha * op(A) @ op(B) + beta * C`` with fp32
accumulation. Where the TPU wrapper zero-pads operands to block multiples,
this one hands the kernel strides and shapes; the kernel masks the ragged
edge itself, and the transposed layouts are strides, not copies.

The kernel has three paths, and `plan` picks one per call from dtype,
layout, alignment and shape: ``stream`` (split-K weight streaming for
M <= 64, the decode GEMMs, with B stored (K, N) or, for a tied LM head,
(N, K)), ``wgmma`` (TMA and warpgroup MMA for M > 64, the prefill chunks
and training, on all four layouts: A stored (M, K) or transposed, (K, M);
B stored (K, N) or (N, K)) and ``general`` (f32 x f32, unaligned or
broadcast views, K = 0). A fourth entry, ``split``, is the wgmma kernel on
the split pair: one f32 operand, split into three bf16 terms (`split3`),
times a bf16 one, at the f32 product's accuracy (the backward of an f32-out
product: the LM head, the MoE router). On both fast paths a row's bits do
not depend on M: K is cut into segments by (N, K) alone (`k_segments`),
which both paths sum in the same order.

A CPU tensor is computed by the plain version (`ref.matmul_ref`,
`ref.split3_ref`); a CUDA tensor launches the kernel or raises.
``tiled_matmul.launches`` counts the GEMM launches,
``tiled_matmul.launches_by_path`` the launches per path, and
``split3.launches`` the split kernel's launches.

A ``meta`` tensor (the dry-run, `core.opanalyze`) takes the shape-only
path: both wrappers choose what the card would launch for those shapes and
strides (`plan`'s path, tile, layouts and K segments; the split pair's
`split3`), return an empty meta result of the right shape and dtype, and
hand a `MetaLaunch` record of it to every `record_meta` block open. Nothing
is computed and no counter moves: a meta call is not a launch.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels.ref import matmul_ref, split3_ref

GENERAL, STREAM, WGMMA, SPLIT = "general", "stream", "wgmma", "split"
# the split pair launches the wgmma kernel on its operands' terms
_PATH_CODE = {GENERAL: 0, STREAM: 1, WGMMA: 2, SPLIT: 2}
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


@dataclasses.dataclass(frozen=True)
class MetaLaunch:
    """What the card would launch for one meta call, unpriced (the dry-run
    prices it, `core.opanalyze.launch_cost`): the GEMM's path ("stream",
    "wgmma", "split", "general"), or "split3" for the split kernel; its
    `Plan` (None for split3); the product's (m, n, k) (split3: the f32
    matrix's rows and columns, k 0); the dtypes of the operands the kernel
    reads (the split pair: its f32 operand's, which it reads as the three
    bf16 planes; general casts a mixed pair to f32 first) and of its
    output; whether it reads C."""

    path: str
    plan: Plan | None
    m: int
    n: int
    k: int
    a_dtype: torch.dtype
    b_dtype: torch.dtype
    out_dtype: torch.dtype
    c: bool = False


_META_SINKS: list[list] = []


@contextlib.contextmanager
def record_meta():
    """Within the block, every meta call of `tiled_matmul` and `split3`
    appends its `MetaLaunch` to the list this yields (blocks nest: each
    open one gets every record)."""
    log: list[MetaLaunch] = []
    _META_SINKS.append(log)
    try:
        yield log
    finally:
        _META_SINKS.remove(log)


def _record(rec: MetaLaunch) -> None:
    for log in _META_SINKS:
        log.append(rec)


def _mod16(t: torch.Tensor) -> int:
    """`t`'s base address modulo 16; for a meta tensor, its offset into
    its storage, whose base the caching allocator aligns on the card."""
    if t.device.type == "meta":
        return t.storage_offset() * t.element_size() % 16
    return t.data_ptr() % 16


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
    b_nk: bool = False     # op(B) is read from B stored (N, K), K-contiguous
    a_mn: bool = False     # op(A) is read from A stored (K, M), M-contiguous
    split: str = ""        # the split pair: "a" or "b", the operand of terms

    def tiles(self, m: int, n: int) -> int:
        """Output tiles of an (m, n) product: the grid without splits."""
        return -(-m // self.tile.block_m) * -(-n // self.tile.block_n)


def _require_compiled(config: BlockConfig | None) -> None:
    if config is not None and config.path is None:
        raise ValueError(f"block config {config.as_tuple()} is not compiled; "
                         f"choose one of {TILE_SHAPES}")


def _rows(ld: int, width: int, mod16: int) -> bool:
    """Rows that TMA and 16-byte copies read: a row stride that is a
    multiple of 8 elements and no shorter than the row, a 16-byte base."""
    return ld % 8 == 0 and ld >= width and mod16 == 0


def _a_layout(m, k, a_strides, a_ptr_mod16) -> str | None:
    """op(A)'s fast layout: "k" (A stored (M, K), K-contiguous rows,
    op(A) strides (lda, 1)), "m" (stored (K, M), M-contiguous rows, op(A)
    strides (1, lda): a transposed A) or None."""
    if k < 1:
        return None
    if a_strides[1] == 1 and _rows(a_strides[0], k, a_ptr_mod16):
        return "k"
    if a_strides[0] == 1 and _rows(a_strides[1], m, a_ptr_mod16):
        return "m"
    return None


def _b_layout(n, k, b_strides, b_ptr_mod16) -> str | None:
    """op(B)'s fast layout: "n" (B stored (K, N), N-contiguous rows, op(B)
    strides (ldb, 1)), "k" (stored (N, K), K-contiguous rows, op(B) strides
    (1, ldb): a weight read transposed, a tied head's table) or None."""
    if b_strides[1] == 1 and _rows(b_strides[0], n, b_ptr_mod16):
        return "n"
    if b_strides[0] == 1 and _rows(b_strides[1], k, b_ptr_mod16):
        return "k"
    return None


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
         config: BlockConfig | None = None, *, split: str = "",
         segments_n: int | None = None) -> Plan:
    """Choose the kernel path, tile, K segments and CTA splits of
    C = op(A) @ op(B).

    `a_strides` are op(A)'s (m, k) strides and `b_strides` op(B)'s (k, n)
    strides, in elements; the `*_ptr_mod16` are the base addresses modulo
    16. `split` is "a" or "b" for the split pair: that operand is the
    three bf16 terms of an f32 matrix (`split3`; the strides are a term's),
    and `in_dtype` is the other's. The rule:

    - The fast paths take bf16 inputs (f32 or bf16 out) whose op(A) is
      K-contiguous (A stored (M, K)) or M-contiguous (stored (K, M): the
      weight gradient's activations) and whose op(B) is N-contiguous (B
      stored (K, N)) or K-contiguous (stored (N, K): the input gradient's
      weight, a tied LM head's table), with row strides that are multiples
      of 8 elements and no shorter than the row, 16-byte aligned bases and
      K >= 1. Everything else (f32 x f32, unaligned or broadcast views,
      K = 0) takes ``general`` with `DEFAULT_CONFIG`.
    - M <= 64 with a K-contiguous op(A) takes ``stream`` (either B layout)
      with the narrowest activation tile that holds M (8, 16, 32 or 64
      rows). M > 64, and a transposed A at any M (``stream`` reads only
      K-contiguous activations), take ``wgmma``: any of the four layouts,
      with the widest tile (128 x 256, 128 or 64) whose output tiles alone
      cover a wave of 132 CTAs, else the widest whose tiles cover half a
      wave, else the narrowest. A GEMM bound by operations (2MNK at 989
      TFLOP/s longer than its bytes at 3.35 TB/s) skips the 64-wide tile,
      which moves 1.5x the operand bytes per FLOP of the 128-wide one; a
      shape of more than one K segment takes 128 x 128 where the rule picks
      128 x 256, whose CTA has no registers to walk segments.
    - The split pair takes ``split``: the wgmma kernel and its tile rule,
      at any M, three passes over K (one per term). Bound, like any
      wgmma GEMM, by 2MNK at the bf16 rate (each pass is a third of it) or
      by its bytes. Its terms are always laid out for the fast paths, so
      only the bf16 operand's layout can send it to ``general`` (which then
      multiplies the f32 matrix by the bf16 operand cast to f32).
    - K segments: `k_segments(N, K)`, whatever M, the layout and the path,
      where N is `segments_n` when given: the width of the whole product
      of which this call computes some columns (a tensor-parallel shard,
      or a chunk of one, `distributed.tp`), so its columns sum K in the
      order of the whole product's. ``stream`` gives each segment a CTA
      (splits = segments). ``wgmma`` and ``split`` do the same where the
      tiles cover less than half a wave and tiles x segments stay within
      4 waves (528 CTAs), and otherwise walk a tile's segments in one CTA
      (splits = 1).

    So a row's result is the same at every M and on both fast paths: the
    segments are summed from zero in order on both, and the H100's
    mma.sync and wgmma give the same fp32 sum over a segment (the
    row-invariance check of ``chip_smoke.py``'s phase 3 and
    ``tests/test_torch_cuda.py``). The (N, K) layout on ``stream`` issues
    the same mma.sync sequence on the same values as the (K, N) one, so a
    tied head's row has the same bits at every M <= 64 (serving never
    unembeds more than 2 x max_batch rows in one call). ``general`` is
    exempt: no serving or training launch takes it (``chip_smoke.py``
    checks 0 on it in every serving run and training step).

    A `config` forces its tile (and so its path); it raises ValueError if
    the tile is not compiled or its path cannot take this GEMM. A forced
    128 x 256 tile spreads its segments."""
    _require_compiled(config)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if split not in ("", "a", "b"):
        raise ValueError(f"split must be 'a', 'b' or '', not {split!r}")
    bf16 = in_dtype == torch.bfloat16
    la = _a_layout(m, k, a_strides, a_ptr_mod16) if bf16 else None
    lb = _b_layout(n, k, b_strides, b_ptr_mod16) if bf16 else None
    fast = la is not None and lb is not None
    streams = fast and la == "k" and not split
    if config is not None and config.path == GENERAL:
        return Plan(GENERAL, config, 1)
    if config is None and not fast:
        return Plan(GENERAL, DEFAULT_CONFIG, 1)
    if config is not None and not (streams if config.path == STREAM
                                   else fast):
        raise ValueError(
            f"the {config.path} tile {config.as_tuple()} takes bf16 inputs "
            "with K- or M-contiguous op(A) rows (stream: K only) and N- or "
            "K-contiguous op(B) rows, 16-byte aligned (stream: no split "
            "operand); this GEMM takes the general path")
    segments = k_segments(segments_n or n, k)
    if config is None:
        if streams and m <= STREAM_MAX_M:
            config = next(t for t in _STREAM_TILES if t.block_m >= m)
        else:
            config = _wgmma_tile(m, n, k, out_dtype, segments)
    if config.path == STREAM and m > config.block_m:
        raise ValueError(f"the stream tile {config.as_tuple()} holds at most "
                         f"{config.block_m} rows, not {m}")
    layout = dict(b_nk=lb == "k", a_mn=la == "m")
    if config.path == STREAM:
        return Plan(STREAM, config, segments, segments, **layout)
    tiles = Plan(WGMMA, config, 1).tiles(m, n)
    return Plan(SPLIT if split else WGMMA, config,
                _wgmma_splits(config, tiles, segments), segments,
                split=split, **layout)


# one int32 counter per output tile for the split-K hand-off, per device;
# every launch leaves them at zero
_COUNTERS: dict[int, torch.Tensor] = {}


def _tile_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


def _launch(a, b, c_in, out, m, n, k, sa, sb, sc, alpha, beta, p: Plan,
            s_plane: int = 0):
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
        *p.tile.as_tuple(), p.splits, p.segments, int(p.b_nk), int(p.a_mn),
        {"": 0, "a": 1, "b": 2}[p.split], s_plane,
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul launch failed ({p}): cudaError "
                           f"{err}")


@dataclasses.dataclass(frozen=True, eq=False)
class Split3:
    """An f32 matrix `x` and its three bf16 terms, `terms` = (hi, mid, lo)
    stacked as (3, *x.shape): hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), each rounded to nearest even. For a normal x of
    magnitude at least 2^-102 they hold its whole 24-bit significand
    (hi + mid + lo == x), so their products with a bf16 operand, each exact
    in fp32, sum to the f32 product. As an operand of `tiled_matmul` it
    multiplies as `x`; made once by `split3`, it feeds several products
    (an f32 cotangent's two gradients). On the card each plane's rows are
    padded to a multiple of 8 elements (16 bytes), as TMA reads them."""

    x: torch.Tensor
    terms: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.x.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def dim(self) -> int:
        return self.x.dim()


def split3(x: torch.Tensor) -> Split3:
    """The three bf16 terms of the f32 matrix `x` (see `Split3`). A CPU
    tensor is split by the plain version (`ref.split3_ref`); a CUDA tensor
    launches the kernel (``split3_kernel``, counted in
    ``split3.launches``) into a bf16 scratch of 6 bytes an element of `x`,
    which the result holds. A meta tensor gets that scratch's shape, and
    the launch is recorded (`record_meta`), not made."""
    if isinstance(x, Split3):
        return x
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"split3 takes an f32 matrix, not a {x.dtype} "
                        f"tensor of rank {x.dim()}")
    if x.device.type == "cpu":
        return Split3(x, split3_ref(x))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"split3 runs on cuda, cpu or meta, not {x.device}")
    r, c = x.shape
    ld = -(-c // 8) * 8
    buf = torch.empty((3, r, ld), dtype=torch.bfloat16, device=x.device)
    if x.device.type == "meta":
        if r and c:
            _record(MetaLaunch("split3", None, r, c, 0, x.dtype,
                               torch.bfloat16, torch.bfloat16))
        return Split3(x, buf[:, :, :c])
    from repro_torch.kernels._build import load_library

    if r and c:
        err = load_library().repro_split3(
            x.data_ptr(), r, c, x.stride(0), x.stride(1), buf.data_ptr(), ld,
            r * ld, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"split3 launch failed: cudaError {err}")
        split3.launches += 1
    return Split3(x, buf[:, :, :c])


split3.launches = 0


def _matrix(x) -> torch.Tensor:
    return x.x if isinstance(x, Split3) else x


def _planes(x) -> tuple[tuple[int, int], int]:
    """(row and column strides, base address mod 16) of the bf16 planes
    the kernel reads for the f32 operand `x`: a `Split3`'s terms, or those
    `split3` would write (rows padded to a multiple of 8)."""
    if isinstance(x, Split3):
        return tuple(x.terms.stride()[1:]), _mod16(x.terms)
    return (-(-x.shape[1] // 8) * 8, 1), 0


def tiled_matmul(
    a: torch.Tensor | Split3,
    b: torch.Tensor | Split3,
    c: torch.Tensor | None = None,
    *,
    config: BlockConfig | None = None,
    transpose_a: bool = False,
    transpose_b: bool = False,
    alpha: float = 1.0,
    beta: float = 0.0,
    out_dtype: torch.dtype | None = None,
    segments_n: int | None = None,
) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C  (the paper's GEMM surface).

    a: (M, K), or (K, M) if transpose_a; b: (K, N), or (N, K) if
    transpose_b. Inputs float32 or bfloat16, both the same or one of each
    (the split pair: the f32 operand is split into its three bf16 terms,
    or given already split as a `Split3`, and the product keeps f32
    accuracy); output float32 or bfloat16 (default ``a.dtype``). `c` (M, N)
    is rounded to `out_dtype` before the beta term, as the TPU kernel does.
    `config` forces a compiled tile (see `plan`); by default `plan`
    chooses. `segments_n` is the N that `plan` reckons the K segments from
    (default N): a column shard of a wider product passes the whole
    product's, so each column has that product's bits. Meta operands take
    the shape-only path (the module docstring)."""
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
    if a.dtype not in _DTYPE_CODE or b.dtype not in _DTYPE_CODE:
        raise TypeError(f"inputs must be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    _require_compiled(config)
    c_in = c.to(out_dtype) if c is not None and beta != 0.0 else None
    devices = {t.device for t in (a, b, c_in) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if a.device.type == "cpu":
        return matmul_ref(_matrix(a), _matrix(b), c_in,
                          transpose_a=transpose_a, transpose_b=transpose_b,
                          alpha=alpha, beta=beta, out_dtype=out_dtype)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"tiled_matmul runs on cuda, cpu or meta, not "
                         f"{a.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    # the split pair: one f32 operand, read as its bf16 terms
    side = "" if a.dtype == b.dtype else (
        "a" if a.dtype == torch.float32 else "b")
    ta, tb = _matrix(a), _matrix(b)
    sa = (_planes(a) if side == "a" else (ta.stride(), _mod16(ta)))
    sb = (_planes(b) if side == "b" else (tb.stride(), _mod16(tb)))
    sa = (sa[0][::-1] if transpose_a else sa[0], sa[1])      # (m, k)
    sb = (sb[0][::-1] if transpose_b else sb[0], sb[1])      # (k, n)
    p = plan(m, n, ka, sa[0], sb[0], sa[1], sb[1],
             torch.bfloat16 if side else a.dtype, out_dtype, config=config,
             split=side, segments_n=segments_n)
    if p.path != STREAM and -(-m // p.tile.block_m) > _MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the grid's row-block limit")
    s_plane = 0
    if p.path == SPLIT:
        terms = split3(a if side == "a" else b).terms
        s_plane = terms.stride(0)
        ta, tb = (terms, tb) if side == "a" else (ta, terms)
    elif side:      # general: the f32 matrix times the bf16 operand in f32
        ta, tb = ta.float(), tb.float()
    sa = ta.stride()[-2:][::-1] if transpose_a else ta.stride()[-2:]
    sb = tb.stride()[-2:][::-1] if transpose_b else tb.stride()[-2:]
    if a.device.type == "meta":
        read = (a, b) if p.path == SPLIT else (ta, tb)
        _record(MetaLaunch(p.path, p, m, n, ka, read[0].dtype, read[1].dtype,
                           out_dtype, c_in is not None))
        return out
    sc = c_in.stride() if c_in is not None else (0, 0)
    _launch(ta, tb, c_in, out, m, n, ka, sa, sb, sc, alpha, beta, p, s_plane)
    tiled_matmul.launches += 1
    tiled_matmul.launches_by_path[p.path] += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.launches_by_path = {STREAM: 0, WGMMA: 0, SPLIT: 0, GENERAL: 0}
