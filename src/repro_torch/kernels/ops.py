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

from repro_torch.kernels.tiled_matmul import BlockConfig, split3, tiled_matmul

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


def warm_fleet_gemm_cache(specs, *, objective: str = "runtime",
                          rank_mode: str = "auto"
                          ) -> list[dict[tuple, BlockConfig]]:
    """Warm a fleet of serving engines in one batched tuning pass per
    chip, as the reference does.

    `specs` is one dict per engine: a ``cfg`` plus `serving_gemm_fleet`'s
    keyword arguments (``max_batch``, ``max_len``, ``chunk_tokens``,
    ``lane_width``, ``grain``, ...) and optionally ``chip`` (None: the
    active chip) and ``dtype``. Engines sharing a (chip, dtype) are unioned
    into one shape fleet and tuned together. Returns one {shape:
    BlockConfig} per spec (its own shapes only), for
    `ServingEngine.pretuned`; a tuner failure gives {} for its group, as in
    `warm_gemm_cache`. Only the active chip's winners are installed
    (`warm_gemm_cache`'s rule): a member priced on another chip gets its
    winners back and launches none of them."""
    from repro_torch.core.chips import get_chip

    fleets: list[list[tuple[int, int, int]]] = []
    keys: list[tuple[str, str]] = []
    groups: dict[tuple[str, str], set] = {}
    for sp in specs:
        kw = {k: v for k, v in sp.items() if k not in ("cfg", "chip", "dtype")}
        fleet = serving_gemm_fleet(sp["cfg"], **kw)
        chip = sp.get("chip")
        key = (get_chip(chip).name if chip else _CHIP,
               sp.get("dtype", "bfloat16"))
        fleets.append(fleet)
        keys.append(key)
        groups.setdefault(key, set()).update(fleet)
    tuned = {(chip, dtype): warm_gemm_cache(
                 sorted(shapes), dtype=dtype, objective=objective, chip=chip,
                 rank_mode=rank_mode)
             for (chip, dtype), shapes in groups.items()}
    return [{s: tuned[key][s] for s in fleet if s in tuned[key]}
            for fleet, key in zip(fleets, keys)]


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
                       include_slot_prefill: bool = True,
                       chunk_tokens: int | None = None,
                       lane_width: int | None = None,
                       kv_cap: int | None = None,
                       tp: int = 1,
                       grain: int = SSM_SERVE_GRAIN
                       ) -> list[tuple[int, int, int]]:
    """Every GEMM shape a serving engine will trace: the batched prefill
    (max_batch * max_len rows, LM head over max_batch last positions), the
    lockstep decode step (max_batch rows), and — for continuous batching
    (`include_slot_prefill`) — the admission prefills: with `chunk_tokens`
    (chunked admission) each (admission-width, chunk-bucket) pair the chunk
    scheduler can issue (pow2 widths up to `lane_width`, default
    `max_batch`, x the chunk buckets up to `chunk_tokens`, LM head over the
    admission rows), plus width-1 rows at the prefill buckets past the
    chunk cap; without it (``admission="serial"``) the width-1 single-shot
    slot prefills at every prefill bucket. Feed to `warm_gemm_cache` so
    every shape the engine issues has its tuned tile before the first
    request.

    `kv_cap` is the per-row cached-token capacity that sizes MLA's
    whole-cache ``w_uk``/``w_uv`` decompression rows (default `max_len`;
    the paged engine's gathered view spans n_row_pages x page_size).
    `grain` is the engine's SSM serve-scan block (the prefill-bucket
    floor).

    For the admit families (encdec, vlm) it adds the prefill-once
    admission grid: the encoder and cross-KV (encdec) or the patch prefix
    through the decoder (vlm, no LM head) over every prefill bucket (an
    admission is not capped at `chunk_tokens`) at pow2 widths through the
    lane cap and the full batch (the wave admits a whole batch at once).

    With `tp > 1` the fleet is the per-shard extents (`gemm_shape_counts`
    at `tp`), as in the reference. Like the reference's, it comes from
    `gemm_shape_counts`, so
    for the MoE families it holds the routed-expert shapes that `matmul`
    never launches (the experts are einsums) and lacks the router that it
    does, and for mamba1 it lacks x_proj and dt_proj (ROADMAP queue C).
    """
    from repro_torch.models.config import gemm_shape_counts

    cap_len = kv_cap if kv_cap is not None else max_len
    fleet = set(gemm_shape_counts(cfg, max_batch * max_len,
                                  head_tokens=max_batch,
                                  kv_rows=max_batch * cap_len, tp=tp))
    fleet |= set(gemm_shape_counts(cfg, max_batch,
                                   kv_rows=max_batch * cap_len, tp=tp))
    if include_slot_prefill:
        if chunk_tokens is None:
            # serial admission: single-shot slot prefills only ever run at
            # width 1
            widths = {1}
            chunks = prefill_buckets(max_len, grain)
        else:
            # chunked admission rounds the lane up to the next pow2, so
            # pre-tune the full pow2 ladder through the lane cap
            cap = lane_width if lane_width is not None else max_batch
            widths = {1}
            a = 1
            while a < cap:
                a *= 2
                widths.add(a)
            chunks = chunk_buckets(max_len, chunk_tokens, grain)
        for b in set(chunks) | set(prefill_buckets(max_len, grain)):
            # buckets past the chunk cap only ever run at width 1
            for w in (sorted(widths) if b in chunks else [1]):
                fleet |= set(gemm_shape_counts(cfg, w * b, head_tokens=w,
                                               kv_rows=w * cap_len, tp=tp))
    if cfg.kind in ("encdec", "vlm"):
        cap = lane_width if lane_width is not None else max_batch
        widths = {1, max_batch}
        a = 1
        while a < cap:
            a *= 2
            widths.add(a)
        for b in prefill_buckets(max_len, grain):
            for w in sorted(widths):
                if cfg.kind == "encdec":
                    fleet |= set(gemm_shape_counts(
                        cfg, 0, head_tokens=0, src_tokens=w * b, tp=tp))
                else:
                    fleet |= set(gemm_shape_counts(cfg, w * b,
                                                   head_tokens=0, tp=tp))
    return sorted(fleet)


def _segments(segments_n: int | None) -> dict:
    """`tiled_matmul`'s ``segments_n`` keyword where one is set (a
    stand-in for the wrapper that takes no such keyword still serves
    every unsharded product)."""
    return {"segments_n": segments_n} if segments_n else {}


class _MatMul(torch.autograd.Function):
    """``out = a @ op(b)`` through the hand-written GEMM, with a backward of
    two more launches of it: ``da = dout @ op(b)^T`` and ``db = a^T @
    dout`` (``dout^T @ a`` for a B stored (N, K)), the transposes passed as
    strides (``wgmma`` reads all four layouts). The JAX package's gradient
    is autodiff's transpose of its ``dot_general``: the cotangent as it
    arrives times the other operand, summed in f32 and rounded once to the
    operand's dtype. So a bf16-out product's backward launches in bf16, and
    an f32-out product of bf16 operands (the LM head, the MoE router) takes
    its f32 cotangent against the bf16 operands as they are: the split pair,
    the cotangent split once into its three bf16 terms (`split3`) for both
    gradients, on the tensor cores at f32 accuracy. `tiled_matmul` and
    `split3` are read from this module at call time, so a caller that swaps
    them (``chip_smoke.py``'s plain runs and recorders) swaps both
    directions."""

    @staticmethod
    def forward(ctx, a2, b, config, transpose_b, out_dtype, segments_n):
        ctx.save_for_backward(a2, b)
        ctx.transpose_b = transpose_b
        return tiled_matmul(a2, b, config=config, transpose_b=transpose_b,
                            out_dtype=out_dtype, **_segments(segments_n))

    @staticmethod
    def backward(ctx, dout):
        a, b = ctx.saved_tensors
        # autograd may hand over a broadcast (stride 0) or permuted
        # cotangent: the kernel reads row-major rows
        dout = dout.contiguous()
        if dout.dtype == torch.float32 and a.dtype != dout.dtype:
            dout = split3(dout)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = tiled_matmul(dout, b, transpose_b=not ctx.transpose_b,
                              out_dtype=a.dtype)
        if ctx.needs_input_grad[1]:
            if ctx.transpose_b:
                db = tiled_matmul(dout, a, transpose_a=True,
                                  out_dtype=b.dtype)
            else:
                db = tiled_matmul(a, dout, transpose_a=True,
                                  out_dtype=b.dtype)
        return da, db, None, None, None, None


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    config: BlockConfig | None = None,
    objective: str | None = None,
    transpose_b: bool = False,
    out_dtype: torch.dtype | None = None,
    segments_n: int | None = None,
) -> torch.Tensor:
    """out = a @ op(b) over the last axis of `a`; leading dims are batch.
    fp32 accumulation; the output dtype defaults to ``a.dtype``. Without
    `config`, a shape with an installed winner for `objective` (default:
    the one `launch_objective` set, else "runtime") takes it
    (`_tuned_config`; winners are tuned on the "nn" layout, so only for
    ``transpose_b=False``), any other `plan`'s rule. Where autograd
    records, the product is differentiable (`_MatMul`: each gradient is one
    more launch of the kernel); serving, under ``no_grad``, calls the
    kernel directly. `segments_n` is the width of the whole product whose
    columns this call computes (`tiled_matmul`): a tensor-parallel shard
    passes its projection's unsharded N."""
    *lead, k = a.shape
    n, kb = b.shape if transpose_b else b.shape[::-1]
    if kb != k:
        raise ValueError(f"contraction mismatch {k} vs {kb}")
    a2 = a.reshape(-1, k)
    if config is None and not transpose_b:
        config = _tuned_config(a2.shape[0], n, k, a.dtype,
                               objective or _OBJECTIVE)
    out_dtype = out_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        out = _MatMul.apply(a2, b, config, transpose_b, out_dtype,
                            segments_n)
    else:
        out = tiled_matmul(a2, b, config=config, transpose_b=transpose_b,
                           out_dtype=out_dtype, **_segments(segments_n))
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
