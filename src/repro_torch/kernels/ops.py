"""Public GEMM ops — the port's single entry point for matmuls.

Every projection of the model calls `matmul` (or `linear`), which reaches
the hand-written Hopper GEMM through `tiled_matmul`. Dispatch follows the
tensor's device: a CUDA tensor launches the kernel, a CPU tensor (the tests)
runs its plain version. On the card, `tiled_matmul.plan` picks the path,
tile and K-splits of each call from its dtype, layout, alignment and shape
(the bf16 projections of the serving path take ``stream`` for M <= 64 and
``wgmma`` above); a caller that passes ``config=`` gets that compiled tile
or a ValueError.

The paper's autotuner feeds this layer as in the reference:
`warm_gemm_cache` tunes a fleet of shapes (`serving_gemm_fleet`) with the
active chip's tuner and installs the winners, and `matmul` then launches
each tuned shape at its winner (see `_tuned_config`).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.kernels.tiled_matmul import BlockConfig, tiled_matmul

_CHIP: str = "h100"
# the active chip's installed winners: (m, n, k, torch dtype, objective) ->
# tile, and the tuner they came from
_TUNED: dict[tuple, BlockConfig] = {}
_TUNED_BY = None
# the objective whose installed winners `matmul` launches by default
_OBJECTIVE = "runtime"


def force_chip(chip: str) -> None:
    """Select the chip registry entry whose winners `matmul` launches (the
    port's default is "h100", the card it runs on). Installed winners
    belong to the previous chip and are dropped."""
    global _CHIP, _TUNED_BY
    from repro_torch.core.chips import get_chip

    name = get_chip(chip).name
    if name != _CHIP:
        _TUNED.clear()
        _TUNED_BY = None
    _CHIP = name


def _tuned_config(m: int, n: int, k: int, dtype: torch.dtype,
                  objective: str = "runtime") -> BlockConfig | None:
    """The installed winner of an (m, n, k) GEMM in `dtype` for
    `objective` on the active chip, or None (then `plan`'s rule, which
    was measured on the card, picks the tile).

    One deliberate difference from the reference: its `_tuned_config`
    builds a tuner on first use (training on the simulator) and swallows
    every error. Here the lookup only reads the winners that
    `warm_gemm_cache` installed from the active chip's tuner (the one
    `autotuner.set_tuner` installed, or `get_tuner` built). It sits on the
    decode step's host-bound path — every projection of every forward
    calls it — so it is one dictionary hit: no feature building and no
    tuner call.
    """
    return _TUNED.get((m, n, k, dtype, objective))


def warm_gemm_cache(shapes, *, dtype: str = "bfloat16",
                    objective: str = "runtime",
                    chip: str | None = None,
                    rank_mode: str = "auto",
                    strict: bool = False) -> dict[tuple, BlockConfig]:
    """Pre-tune a fleet of (m, n, k) GEMM shapes in one batched
    `tune_many` pass and install the winners, so `matmul` launches each
    tuned shape at its tuned tile.

    `dtype` is a config's spelling ("bfloat16"; the tuner canonicalizes).
    `matmul` consults the *active* chip only (`force_chip`), so pass
    `chip=None` to warm the chip the port runs on; warming an explicit
    other chip fills that chip's tuner caches and returns its winners but
    installs nothing. Winners of a different tuner than the last one
    installed replace the whole table. `rank_mode` selects the
    candidate-ranking path ("auto" ranks on the tuner's device when that
    is the card — see `GemmAutotuner.rank_in_graph` — and at trace time
    on the CPU; "graph" / "trace" force one). Returns {shape:
    BlockConfig}; on any tuner failure (e.g. no artifact and no
    substrate) returns {} and `matmul` keeps `plan`'s rule, as the
    reference degrades to its untuned default.

    ``strict=True`` re-raises tuner failures instead of degrading
    silently, for callers that must see a corrupt predictor artifact
    (`core.predictor.ArtifactError`) or a failed measurement.
    """
    global _TUNED_BY
    from repro_torch.core.chips import canon_dtype

    shapes = [tuple(int(x) for x in s) for s in shapes]
    # validate eagerly: a rank_mode typo must stay loud, not vanish into
    # the tuner-failure fallback below
    if rank_mode not in ("auto", "graph", "trace"):
        raise ValueError(f"unknown rank_mode {rank_mode!r}")
    try:
        from repro_torch.core.autotuner import get_tuner
        from repro_torch.core.chips import get_chip

        chip_name = get_chip(chip).name if chip else _CHIP
        tuner = get_tuner(chip=chip_name)
        best = tuner.tune_many(shapes, dtype=dtype, objective=objective,
                               rank_mode=rank_mode)
    except Exception:
        if strict:
            raise
        return {}
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}.get(
        canon_dtype(dtype))
    if chip_name == _CHIP and tdt is not None:
        if _TUNED_BY is not tuner:
            _TUNED.clear()
            _TUNED_BY = tuner
        for (m, n, k), cfg in zip(shapes, best):
            _TUNED[(m, n, k, tdt, objective)] = cfg
    return dict(zip(shapes, best))

@contextlib.contextmanager
def launch_objective(objective: str):
    """Within the block, `matmul` launches the installed winners of
    `objective` ("runtime", "energy", "power", "edp") where its caller
    names none: how a serving engine pretuned for an objective runs the
    tiles it priced. The JAX package's engine has no such switch and
    launches runtime winners whatever it was tuned for."""
    global _OBJECTIVE
    before, _OBJECTIVE = _OBJECTIVE, objective
    try:
        yield
    finally:
        _OBJECTIVE = before


SSM_SERVE_GRAIN = 8  # min prefill bucket == SSM serve-scan block


@functools.lru_cache(maxsize=None)
def prefill_buckets(max_len: int, min_bucket: int = SSM_SERVE_GRAIN
                    ) -> tuple[int, ...]:
    """Power-of-two row buckets the serving engine pads prefill chunks to,
    up to and including `max_len`. Memoized per (max_len, min_bucket): the
    engine's per-admission bucket lookup bisects this tuple."""
    buckets, b = [], min_bucket
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def chunk_buckets(max_len: int, chunk_tokens: int,
                  grain: int = SSM_SERVE_GRAIN) -> tuple[int, ...]:
    """The chunk sizes chunked admission may issue: the prefill buckets
    capped at `chunk_tokens` (a longer prompt is fed `chunk_tokens` tokens
    per engine step). `grain` sets the bucket floor."""
    caps = [b for b in prefill_buckets(max_len, grain) if b <= chunk_tokens]
    return tuple(caps) if caps else prefill_buckets(max_len, grain)[:1]


def serving_gemm_fleet(cfg, *, max_batch: int, max_len: int,
                       chunk_tokens: int,
                       lane_width: int | None = None,
                       include_slot_prefill: bool = True
                       ) -> list[tuple[int, int, int]]:
    """Every GEMM shape the continuous serving engine will trace: the
    batched prefill (max_batch * max_len rows, LM head over max_batch last
    positions), the lockstep decode step (max_batch rows), and the
    chunked-admission prefill grid: each (admission-width, chunk-bucket)
    pair the chunk scheduler can issue (pow2 widths up to the lane width x
    the chunk buckets up to `chunk_tokens`, LM head over the admission
    rows), plus width-1 rows at the prefill buckets past the chunk cap.
    Feed to `warm_gemm_cache` so every shape the engine issues has its
    tuned tile before the first request.

    The reference's fleet for the dense engine the port serves (its
    tensor-parallel shards, paged-KV rows and encoder-decoder / vision
    admission grids come with the slices that port those features).
    """
    from repro_torch.models.config import gemm_shape_counts

    fleet = set(gemm_shape_counts(cfg, max_batch * max_len,
                                  head_tokens=max_batch))
    fleet |= set(gemm_shape_counts(cfg, max_batch))
    if include_slot_prefill:
        # chunked admission rounds the lane up to the next pow2, so
        # pre-tune the full pow2 ladder through the lane cap
        cap = lane_width if lane_width is not None else max_batch
        widths = {1}
        a = 1
        while a < cap:
            a *= 2
            widths.add(a)
        chunks = chunk_buckets(max_len, chunk_tokens)
        for b in set(chunks) | set(prefill_buckets(max_len)):
            # buckets past the chunk cap only ever run at width 1
            for w in (sorted(widths) if b in chunks else [1]):
                fleet |= set(gemm_shape_counts(cfg, w * b, head_tokens=w))
    return sorted(fleet)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    config: BlockConfig | None = None,
    objective: str | None = None,
    transpose_b: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """out = a @ op(b) over the last axis of `a`; leading dims are batch.
    fp32 accumulation; the output dtype defaults to ``a.dtype``. Without
    `config`, a shape with an installed winner for `objective` (default:
    the one `launch_objective` set, else "runtime") takes it
    (`_tuned_config`; winners are tuned on the "nn" layout, so only for
    ``transpose_b=False``), any other `plan`'s rule."""
    *lead, k = a.shape
    n, kb = b.shape if transpose_b else b.shape[::-1]
    if kb != k:
        raise ValueError(f"contraction mismatch {k} vs {kb}")
    a2 = a.reshape(-1, k)
    if config is None and not transpose_b:
        config = _tuned_config(a2.shape[0], n, k, a.dtype,
                               objective or _OBJECTIVE)
    out = tiled_matmul(a2, b, config=config,
                       transpose_b=transpose_b,
                       out_dtype=out_dtype or a.dtype)
    return out.reshape(*lead, n)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           **kw) -> torch.Tensor:
    """y = x @ w (+ b). w: (K, N)."""
    y = matmul(x, w, **kw)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def gemm(a, b, c=None, *, alpha=1.0, beta=0.0, transpose_a=False,
         transpose_b=False, config: BlockConfig | None = None,
         out_dtype=None) -> torch.Tensor:
    """Full BLAS-3 surface (rank-2 only) — used by benchmarks and tests."""
    return tiled_matmul(a, b, c, config=config,
                        transpose_a=transpose_a, transpose_b=transpose_b,
                        alpha=alpha, beta=beta, out_dtype=out_dtype)
