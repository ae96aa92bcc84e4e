"""Continuous-batching serving engine with chunked admission prefill.

The counterpart of the JAX package's `repro.serving.engine.ServingEngine`
for every family (`SERVED_KINDS`; at tp > 1 the ones of `_TP_LATER`
excepted), with its serving loops:

- continuous mode, ``admission="chunked"`` (the default): the engine keeps
  one batched decode state of ``max_batch`` fixed slots. Every engine step
  runs one bucketed chunk call over the *admission lane* — a compact
  pow2-width batch of the in-flight admissions, up to ``2 * max_batch``
  rows — and then one lockstep decode step over the resident slots, so a
  long prompt never stops the world. A finished admission samples its
  first token when its last chunk lands, parks in the lane, and is spliced
  into a free decode slot (FIFO). `serve_step` advances it one step;
- continuous mode, ``admission="serial"``: each request prefills alone in
  one single-shot call at a pow2 bucket and is spliced into a free slot
  (the baseline chunked admission is measured against);
- continuous mode on the paged KV layout (``kv_layout="paged"``): every row
  addresses one shared device page pool through a host-built page table
  (`serving.paging.PageAllocator`), a request reserves its full capacity at
  admission, and with ``prefix_cache`` a prompt that starts with a
  registered prefix maps its pages copy-on-write and skips those chunks;
- the wave loop (``mode="wave"``): one batched prefill of up to
  ``max_batch`` requests, then lockstep decode until all of them finish.

The encoder-decoder and vision families are *admit families*: their
modality inputs (``Request.extras``: source embeddings, or a patch prefix
and its grid) run through one prefill-once admission call
(`ModelApi.admit`) whose outputs are leaves of the decode state (encdec's
cross-KV and ``src_len``, vlm's patch KV rows and ``pos_off``); the text
prompt then chunks like any other. Chunked admission packs a step's fresh
admissions into one call at a pow2 width and the largest bucket among
them; serial admission runs admit plus one full-prompt chunk, and the wave
admits its whole batch in one call and then runs one chunk: the path of
chunked admission, so the streams agree. On the paged layout only the
decoder's self-attention KV pages; the other admission leaves stay dense
per request, and admit families opt out of prefix reuse (their KV depends
on the modality input, not the tokens alone).

The SSM and hybrid families carry their conv and scan state across chunk
boundaries bit-exactly: chunk boundaries and prefill buckets stay multiples
of the serve-scan grain (`ssm_serve_grain`, default `ops.SSM_SERVE_GRAIN`),
the only unaligned bucket (a max_len that is not a multiple) is dropped for
a non-final chunk, and an attention-free row has no length bound, so its
prompt may be longer than ``max_len`` (it scans through in chunks, and the
bucket ladder doubles past max_len for a serial prefill). Their state is
O(1) per row, so they are served on the dense layout only, as in the JAX
engine.

Streams match the JAX engine's token for token in every mode: the same
admission order, buckets, splice order, page allocation and host numpy
sampler with per-(seed, uid) Gumbel streams. Inside the port the layouts
and admissions agree as in the JAX package: paged equals dense, serial
equals chunked, prefix reuse changes no stream, on the CPU and on the card
(where a row's GEMM bits do not depend on M, `kernels.tiled_matmul.plan`).
For the MoE families a prefix hit
changes the chunk lengths that size a row's expert capacity, so under a
binding capacity factor prefix reuse may change a stream, in the JAX
package too.
`pretune` tunes the engine's GEMM fleet with the paper's autotuner, as the
JAX engine's does.

Energy and the model clock follow the JAX engine: every prefill, chunk
call and decode step is priced by the analytical GEMM fleet model
(`core.energy.gemm_fleet_energy`, at the engine's pretuned tiles); its
predicted step time advances the model clock (`model_clock_s`,
`Result.ttft_model_s`) and its energy is shared out per lane row and per
decode slot (`Result.energy_j`), the shares of pad rows and dead slots
going to `idle_energy_j`. These are a model's numbers, never the card's:
the card's own joules are read by `core.nvml`. Two deliberate differences
from the JAX engine:

- ``chip=None`` prices on the card the port runs on (`ops._CHIP`, "h100"),
  not on the TPU v5e;
- a failure of the energy model raises, where the JAX engine warns and
  reads its telemetry as zeros.

And one where the JAX engine is at fault (ROADMAP queue C): an engine
pretuned for another objective than "runtime" launches that objective's
winners (`ops.launch_objective`), so it runs the tiles it prices.

The hooks of the fleet scheduler and fault recovery
(`serving.scheduler`, `serving.faults`) are the JAX engine's: a
`chunk_policy` consulted by the chunk stage, the `lane_view` and
`backlog_tokens` routing reads, replay requests (`Request.replay`, chunked
dense serving only), `checkpoint_inflight` and `adopt` (a decode-state
row moved between engines that share one params object,
`state_compatible`), `charge_lost_energy`, `retune` and page pressure
(`inject_page_pressure`, `release_page_pressure`). A checkpointed row is
a clone: the port's decode state is updated in place, so a view of a
failed member's cache would change under it. A degraded `retune` prices at
`autotuner.baseline_configs` and installs no winner, so it launches what
it launched before.

``tp > 1`` serves tensor-parallel in gather mode, as the JAX engine does:
one engine per rank process of a `launch.mesh.Mesh` (a `torch.distributed`
group of `tp` ranks), each rank cutting its shard of the whole params
(`distributed.sharding.shard_params`: attention and MLA heads, FFN
columns, vocab, experts, and the SSM channels or SSD heads, each part of a
concatenated projection cut apart) and holding its heads' or channels'
decode state (the MLA latent cache whole); the row-parallel projections
gather their columns (`distributed.tp`), so every rank sees the whole
logits and the host loop runs identically on every rank, its inputs being
identical. Greedy streams equal tp=1's token for token, for every family.

Where the JAX engine donates the decode state to its jitted calls, this
engine updates the KV tensors and the page pool in place.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


# the families the engine serves, in every mode: dense, OLMoE-style MoE,
# DeepSeek-V2 MLA-MoE, Mamba1, Mamba2, the Zamba2 hybrid, and the admit
# families: the Seamless-M4T encoder-decoder and the Qwen2-VL vision LM
SERVED_KINDS = ("dense", "moe", "mla_moe", "mamba1", "mamba2", "hybrid",
                "encdec", "vlm")
# the families whose cache the paged layout supports: per-token KV (or MLA
# latent) rows that page cleanly (encdec: its decoder's self-attention KV);
# SSM/hybrid state is O(1) per row (or mixed) and stays dense
PAGED_KINDS = ("dense", "moe", "mla_moe", "encdec", "vlm")


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a budget, an optional EOS id."""

    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    submit_s: float = 0.0       # stamped by ServingEngine.submit
    submit_model_s: float = 0.0  # engine model-clock at submission
    sla: str | None = None      # SLA-class name (FleetScheduler telemetry)
    # tokens a failed attempt already emitted (fault recovery): the request
    # prefills over prompt + replay[:-1] and decodes from the last emitted
    # token, so the client-visible stream stays an append-only continuation
    # and the final Result carries the whole stream once. Chunked dense
    # serving only.
    replay: list[int] | None = None
    # modality inputs of the admit families' prefill-once admission:
    # encdec {"src_embeds": (T, d)}, vlm {"patch_embeds": (P, d),
    # "grid_hw": (gh, gw)}; None for a text-only request
    extras: dict | None = None


@dataclasses.dataclass
class Result:
    """A finished request's tokens plus latency telemetry (host clock and
    model clock) and its attributed energy (the energy model's)."""

    uid: int
    tokens: np.ndarray          # generated ids (includes EOS if emitted)
    prompt_len: int
    steps: int                  # decode iterations the request was resident
    n_tokens: int = 0           # generated-token count
    queue_s: float = 0.0        # submit -> prefill start
    ttft_s: float = 0.0         # submit -> first token
    ttft_model_s: float = 0.0   # submit -> first token, model clock
    decode_s: float = 0.0       # first token -> last token
    tokens_per_s: float = 0.0
    energy_j: float = 0.0       # attributed prefill + resident-step energy
    energy_per_token_j: float = 0.0
    prefill_energy_j: float = 0.0  # the chunk calls' share of energy_j


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: list[int]
    prefill_energy_j: float
    t_start: float              # prefill start (wall)
    t_first: float              # first-token time (wall)
    t_first_model: float = 0.0  # first-token time (model clock)
    steps: int = 0              # resident decode iterations so far
    rng: np.random.Generator | None = None   # per-request sampling stream
    pages: list[int] | None = None  # paged layout: owned/shared page ids
    index: int = 0              # paged layout: host-tracked cache position
    # paged admit families: the request's dense admission leaves (encdec
    # cross-KV and src_len, vlm pos_off), batch 1, joined into each call
    extra_top: dict | None = None
    extra_kv: dict | None = None


@dataclasses.dataclass
class _Admission:
    """A request mid-chunked-prefill: `row` in the admission-lane state,
    `base` prompt tokens written. Once its last chunk lands and its first
    token is sampled it parks in the lane (`ready`/`first_tok`) until a
    decode slot frees."""

    req: Request
    row: int = -1
    base: int = 0
    chunk_energy_j: float = 0.0
    t_start: float = 0.0        # first chunk dispatch (wall)
    rng: np.random.Generator | None = None
    ready: _Slot | None = None  # prefilled + first token sampled
    first_tok: int = 0
    pages: list[int] | None = None  # paged layout: reserved page ids
    prefix: int = 0             # paged layout: admission-prefix cache rows
    extra_top: dict | None = None   # paged admit families (see _Slot)
    extra_kv: dict | None = None
    # the tokens the chunks prefill: the prompt, extended by a replayed
    # request's emitted tokens but the last (which is decoded, not
    # prefilled)
    eff: np.ndarray | None = None


class _LiveState:
    """The stepper's state across yields: slot table, decode state, lane.
    Held on the engine (`_live`) so `checkpoint_inflight` can take rows out
    of it when the fleet scheduler declares this member failed."""

    __slots__ = ("slots", "batch_state", "token_buf", "adm", "adm_state",
                 "adm_w", "lane_free", "lane_dirty", "zero_src")

    def __init__(self, max_batch: int):
        self.slots: list[_Slot | None] = [None] * max_batch
        self.batch_state = None
        self.token_buf = np.zeros(max_batch, np.int32)
        self.adm: list[_Admission] = []
        self.adm_state = None
        self.adm_w = 0
        self.lane_free: list[int] = []
        self.lane_dirty: set[int] = set()
        self.zero_src = None


class ServingEngine:
    """Continuous-batching serving engine (see the module docstring).
    `model` is the family's `ModelApi`, `params` its weights (a
    `TransformerLM` on `device`)."""

    def __init__(self, model, params, cfg: ModelConfig, *,
                 max_batch: int = 8, max_len: int = 512,
                 greedy: bool = True, seed: int = 0,
                 mode: str = "auto",
                 admission: str = "chunked", chunk_tokens: int = 64,
                 kv_layout: str = "dense", page_size: int = 64,
                 num_pages: int | None = None, prefix_cache: bool = True,
                 pretune: bool = False, tune_objective: str = "runtime",
                 tune_rank_mode: str = "auto",
                 chip: str | None = None,
                 tp: int = 1, mesh=None, tp_overlap_chunks: int = 4,
                 ssm_serve_grain: int | None = None,
                 device: str | torch.device = "cuda"):
        """`mode` picks the serving loop: "continuous" (slot table with
        mid-decode retire and refill), "wave" (batch of waves) or "auto"
        (continuous, which every served family supports).

        `admission` picks how continuous mode prefills: "chunked" (prompts
        feed through the decode loop `chunk_tokens` tokens per engine
        step, queued admissions batched into one bucketed call) or
        "serial" (each request prefills alone in one single-shot call,
        stalling the loop for the whole prompt). `chunk_tokens` must be a
        multiple of the SSM serve grain or at least `max_len`, as in the
        JAX engine.

        `ssm_serve_grain` widens the SSM serve-scan block (default
        `ops.SSM_SERVE_GRAIN`): a power-of-two multiple of it. Chunk
        boundaries and prefill buckets align to the grain, so long SSM
        prompts scan in fewer, larger blocks per call; the engine's config
        carries it (``cfg.ssm_serve_grain``).

        `kv_layout` picks the KV-cache layout: "dense" (one max_len buffer
        per decode slot and lane row) or "paged" (a shared pool of
        `page_size`-token pages with per-row page tables, the host-side
        allocator of `serving.paging`, and — with `prefix_cache` —
        shared-prefix page reuse across requests). `num_pages` sizes the
        pool (default: full capacity for every slot and lane row plus the
        null page). Paged serving requires continuous chunked admission, a
        `PAGED_KINDS` family and `page_size` dividing `max_len`.

        `device` holds the decode state and must be where `params` live.

        `tp > 1` serves tensor-parallel over `mesh` (default:
        `launch.mesh.make_serving_mesh(tp)` over the initialised default
        process group), one engine per rank: the config is flipped to
        explicit gather-mode collectives (``tp_reduce="gather"``, streams
        bit-identical to tp=1), `params` (the whole model, or this rank's
        shard of it from an earlier engine) are cut to this rank's shard in
        place, the decode caches hold this rank's heads, the row-parallel
        outputs are gathered in `tp_overlap_chunks` column chunks
        overlapping the next chunk's GEMM, and the energy model prices the
        per-rank fleet plus the ring traffic on `tp` chips. Whole heads
        only: `tp` must divide what the family shards (`sharding.check_tp`,
        the rule training shares), or the engine raises ValueError.

        `pretune=True` batch-tunes the engine's GEMM fleet up front, as the
        JAX engine does: every shape the batched prefill, the decode step
        and each (admission-width x chunk-bucket) chunk call issues
        (`ops.serving_gemm_fleet`) goes through one `ops.warm_gemm_cache`
        pass (predictor-ranked, verified on the chip's substrate, cached
        per chip and artifact), and `self.pretuned` holds the winners.
        `tune_objective` picks the paper's objective ("runtime", "energy",
        "power", "edp"), `tune_rank_mode` the candidate-ranking path, and
        `chip` the chip to tune for and to price energy on (default: the
        active chip of `ops.force_chip`, whose winners the projections then
        launch). The engine's projections launch `tune_objective`'s
        winners."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params on {params.device}, engine on "
                             f"{self.device}")
        if cfg.kind not in SERVED_KINDS:
            raise NotImplementedError(
                f"the port serves kind in {SERVED_KINDS}, not {cfg.kind!r}")
        grain = int(ssm_serve_grain) if ssm_serve_grain else 0
        if grain and (grain < ops.SSM_SERVE_GRAIN
                      or grain % ops.SSM_SERVE_GRAIN
                      or grain & (grain - 1)):
            raise ValueError(
                f"ssm_serve_grain={grain} must be a power-of-two "
                f"multiple of {ops.SSM_SERVE_GRAIN}")
        self.ssm_grain = grain or ops.SSM_SERVE_GRAIN
        if grain:
            cfg = dataclasses.replace(cfg, ssm_serve_grain=grain)
        self._tp = max(int(tp), 1)
        self.mesh = None
        if self._tp > 1:
            cfg = self._shard(model, params, cfg, mesh,
                              max(int(tp_overlap_chunks), 1))
        self.model = model
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.greedy = greedy
        self.seed = seed
        if mode not in ("auto", "continuous", "wave"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if admission not in ("chunked", "serial"):
            raise ValueError(f"unknown admission mode {admission!r}")
        self.mode = mode
        self.admission = admission
        if (admission == "chunked" and chunk_tokens < max_len
                and chunk_tokens % self.ssm_grain):
            # chunk boundaries must stay multiples of the SSM serve-scan
            # block or chunked prefill loses bit parity for SSM families
            raise ValueError(
                f"chunk_tokens={chunk_tokens} must be a multiple of "
                f"{self.ssm_grain} (or >= max_len)")
        if (admission == "chunked" and cfg.sub_quadratic
                and cfg.attention_free and max_len < self.ssm_grain):
            # attention-free prompts may exceed max_len (multi-chunk), and
            # non-final chunk boundaries then need a grain-aligned bucket,
            # which a sub-grain bucket ladder cannot provide
            raise ValueError(
                f"max_len={max_len} < {self.ssm_grain} cannot serve "
                f"chunked SSM prefill; raise max_len or use wave mode")
        self.chunk_tokens = chunk_tokens
        # admission-lane capacity: prefill and first-token sampling for up
        # to this many in-flight requests, decoupled from free slots
        self.lane_width = 2 * max_batch
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.kv_layout = kv_layout
        self.page_size = page_size
        self._allocator = None
        self._pool = None           # device page pool, built on first run
        if kv_layout == "paged":
            from repro_torch.serving.paging import PageAllocator

            if cfg.kind not in PAGED_KINDS:
                raise ValueError(
                    f"kv_layout='paged' unsupported for kind="
                    f"{cfg.kind!r} (SSM/hybrid state is O(1) per row, "
                    f"not per token); use dense")
            if mode == "wave" or admission != "chunked":
                raise ValueError(
                    "kv_layout='paged' requires continuous serving with "
                    "admission='chunked'")
            if max_len % page_size:
                raise ValueError(
                    f"page_size={page_size} must divide "
                    f"max_len={max_len} (page tables span max_len)")
            self._n_row_pages = max_len // page_size
            if num_pages is None:
                # full capacity for every slot and lane row + the null page
                num_pages = ((max_batch + self.lane_width)
                             * self._n_row_pages + 1)
            self._allocator = PageAllocator(num_pages, page_size,
                                            prefix_cache=prefix_cache)
        if chip is not None:
            # validate eagerly: a chip typo must raise here
            from repro_torch.core.chips import get_chip

            chip = get_chip(chip).name
        self.chip = chip
        self.tune_objective = tune_objective
        self.pretuned: dict[tuple, object] = {}
        if pretune:
            chunked = admission == "chunked"
            fleet = ops.serving_gemm_fleet(
                cfg, max_batch=max_batch, max_len=max_len,
                include_slot_prefill=self._continuous_supported(),
                chunk_tokens=chunk_tokens if chunked else None,
                lane_width=self.lane_width if chunked else None,
                tp=self._tp, grain=self.ssm_grain)
            self.pretuned = ops.warm_gemm_cache(
                fleet, dtype=cfg.activation_dtype,
                objective=tune_objective, chip=chip,
                rank_mode=tune_rank_mode)
        self.queue: deque[Request] = deque()
        self._stepper = None
        self._step_energy_cache: dict[tuple, object] = {}
        # the model clock: predicted seconds of every dispatched call; the
        # fleet scheduler also moves it forward over idle gaps and stalls
        self._clock = 0.0
        # scheduler hooks: `chunk_policy` is an optional callable (engine,
        # pending) -> int | None consulted by the chunk stage, `pending`
        # the (Request, remaining tokens) of the rows still prefilling; a
        # returned token count snaps up the chunk-bucket ladder, None keeps
        # the shortest-remainder default. `_live` holds the stepper's state
        # and `_lane_view` the admission snapshot routing reads, refreshed
        # after every step
        self.chunk_policy = None
        self._live: _LiveState | None = None
        self._lane_view = {"pending": 0, "pending_tokens": 0, "parked": 0,
                           "resident": 0, "in_flight": 0}
        # fault recovery: decode-state rows checkpointed off a failed fleet
        # member, waiting here for a free slot (`adopt`); the flag `retune`
        # sets when it degrades
        self._adopted: deque[dict] = deque()
        self.tuning_degraded = False
        self._degraded_reason: str | None = None
        self._state_axes = L.state_batch_axes(
            model.init_state(cfg, 1, max_len, device="meta"),
            model.init_state(cfg, 2, max_len, device="meta"))
        self._stats = {
            "decode_steps": 0, "chunk_steps": 0,
            "resident_slot_steps": 0, "slot_steps": 0,
            "generated_tokens": 0, "requests": 0, "wall_s": 0.0,
            "lane_rebuilds": 0, "energy_j": 0.0, "idle_energy_j": 0.0,
            # prefill-once admission calls (admit families)
            "admit_calls": 0,
            # predicted seconds of dispatched engine calls (the energy
            # model's step_s), advanced per chunk call and decode step, and
            # the collective wire time on the links with the share of it
            # hidden behind GEMMs (zero at tp=1)
            "model_s": 0.0, "wire_s": 0.0, "hidden_wire_s": 0.0,
            # fault recovery: the spend of failed attempts that had to be
            # replayed (charged here, to the failed member, never to a
            # request) and rows adopted from a failed member
            "lost_energy_j": 0.0, "adopted_in": 0,
        }

    # ------------------------------------------------------------------
    # mesh and model clock
    # ------------------------------------------------------------------
    def _shard(self, model, params, cfg: ModelConfig, mesh,
               chunks: int) -> ModelConfig:
        """Set up tensor parallelism at ``self._tp``: check that tp
        divides what the family shards, install the mesh, cut this rank's
        shard of `params` in place and return the config flipped to
        gather-mode explicit collectives (the JAX engine's flip)."""
        from repro_torch.distributed import sharding
        from repro_torch.launch.mesh import make_serving_mesh

        tp = self._tp
        sharding.check_tp(cfg, tp)
        self.mesh = mesh if mesh is not None else make_serving_mesh(tp)
        if self.mesh.shape["model"] != tp:
            raise ValueError(f"mesh {self.mesh.shape} must carry a 'model' "
                             f"axis of size tp={tp}")
        sharding.shard_params(params, self.mesh,
                              whole=model.init(cfg, None, device="meta"),
                              cfg=cfg)
        return dataclasses.replace(cfg, tp_collectives="explicit",
                                   tp_reduce="gather",
                                   tp_overlap_chunks=chunks)

    def _activate(self) -> None:
        """Install this engine's mesh on the thread (clearing it for a
        tp=1 engine) before it dispatches: the model code reads the current
        mesh, and engines of different tp may take turns in one
        process."""
        from repro_torch.distributed.sharding import set_mesh

        set_mesh(self.mesh)

    def _tick(self, step_s: float, est=None) -> None:
        """Advance the model clock by one dispatched call's predicted time
        and fold its collective wire telemetry into the counters."""
        self._clock += step_s
        self._stats["model_s"] += step_s
        if est is not None and est.collective_s > 0.0:
            self._stats["wire_s"] += est.collective_s
            self._stats["hidden_wire_s"] += (est.overlap_factor
                                             * est.collective_s)

    @property
    def model_clock_s(self) -> float:
        """Current model-clock reading: predicted seconds of every call
        this engine has dispatched (plus the idle gaps and stall dilation
        a fleet scheduler adds), monotone across runs and `reset_stats`.
        The fleet scheduler orders engine steps by it."""
        return self._clock

    @property
    def tp(self) -> int:
        """Chips (rank processes) per engine: the tensor-parallel
        degree."""
        return self._tp

    @property
    def chip_spec(self):
        """The `ChipSpec` this engine prices energy on: `chip`, else the
        card the port runs on (`ops._CHIP`)."""
        from repro_torch.core.chips import get_chip

        return get_chip(self.chip or ops._CHIP)

    @property
    def idle_power_w(self) -> float:
        """Idle-floor power of the engine's chips (the priced chip's
        `ChipSpec.idle_power_w` x tp)."""
        return self.chip_spec.idle_power_w * self._tp

    # ------------------------------------------------------------------
    # queue
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        """True while requests are queued or in flight (adopted rows
        included). May stay True for one extra `serve_step()` after the
        last retirement."""
        return (bool(self.queue) or bool(self._adopted)
                or self._stepper is not None)

    @property
    def lane_view(self) -> dict:
        """The admission lane as of the last `serve_step`: rows still
        prefilling (`pending`, `pending_tokens`), parked rows waiting for
        a decode slot, resident decode slots, and in-flight admissions."""
        return dict(self._lane_view)

    @property
    def backlog_tokens(self) -> int:
        """Prompt tokens still to prefill: queued prompts plus the
        unwritten rest of in-flight admissions (the fleet scheduler's TTFT
        prediction divides it by chunk throughput)."""
        return (sum(len(r.prompt) for r in self.queue)
                + int(self._lane_view["pending_tokens"]))

    def _row_capacity(self) -> int | None:
        """Per-row cache capacity in tokens, or None when unbounded: the
        one length bound `submit` and `_budget` apply. Attention KV caches
        hold `max_len` rows; attention-free SSM state is O(1) per row, so
        its capacity is unbounded (long prompts scan through in chunks)."""
        return None if self.cfg.attention_free else self.max_len

    def _admit_dims(self, req: Request) -> tuple[int, int]:
        """(cache-prefix rows, side source rows) the request's admission
        consumes ahead of its prompt: (0, 0) for a family without admission
        hooks. Raises on extras the family cannot admit (an encdec request
        without source embeddings)."""
        if self.model.admit_dims is None:
            return (0, 0)
        return self.model.admit_dims(self.cfg, req.extras)

    def submit(self, req: Request) -> None:
        """Queue a request (stamps its submit time). One per-row bound for
        every family: the admission prefix and the prompt must leave at
        least one decode position in a row's `max_len` cache, and an encdec
        source must fit the row's cross-KV capacity (`max_len` rows); an
        attention-free row is unbounded."""
        prefix, src = self._admit_dims(req)
        cap = self._row_capacity()
        if cap is not None:
            if prefix + len(req.prompt) >= cap:
                raise ValueError(
                    f"admission prefix {prefix} + prompt of "
                    f"{len(req.prompt)} tokens does not fit max_len={cap} "
                    f"(need >= 1 decode position)")
            if src > cap:
                raise ValueError(
                    f"source of {src} rows does not fit the per-row "
                    f"cross-KV capacity max_len={cap}")
        if req.submit_s == 0.0:
            req.submit_s = time.perf_counter()
        req.submit_model_s = self.model_clock_s
        self.queue.append(req)

    def _budget(self, req: Request) -> int:
        """Effective token budget: >= 1, bounded by the row's remaining
        cache room (its capacity minus its admission prefix and its own
        prompt; unbounded for attention-free rows)."""
        cap = self._row_capacity()
        if cap is None:
            return max(1, req.max_new_tokens)
        prefix, _ = self._admit_dims(req)
        return max(1, min(req.max_new_tokens,
                          cap - prefix - len(req.prompt)))

    def _bucket(self, n: int) -> int:
        """Smallest prefill bucket holding `n` prompt tokens (a serial
        slot prefill's rows): a bisect over `ops.prefill_buckets` at the
        SSM grain, the ladder `serving_gemm_fleet` pre-tunes.
        Attention-free prompts may exceed max_len; the ladder keeps
        doubling past it."""
        buckets = ops.prefill_buckets(self.max_len, self.ssm_grain)
        i = bisect.bisect_left(buckets, n)
        if i < len(buckets):
            return buckets[i]
        b = buckets[-1]
        while b < n:
            b *= 2
        return b

    def _chunk_bucket(self, n: int) -> int:
        """Smallest chunk bucket holding `n` remaining prompt tokens,
        capped at `chunk_tokens`."""
        buckets = ops.chunk_buckets(self.max_len, self.chunk_tokens,
                                    self.ssm_grain)
        i = bisect.bisect_left(buckets, n)
        return buckets[min(i, len(buckets) - 1)]

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _req_rng(self, uid: int) -> np.random.Generator:
        """Each request samples from its own (engine seed, uid) stream, so
        its tokens never depend on its neighbours in the batch."""
        return np.random.default_rng((self.seed, uid))

    def _sample(self, logits: np.ndarray,
                rngs: list[np.random.Generator | None] | None = None
                ) -> np.ndarray:
        """Next token per row: argmax when greedy, else a per-request
        Gumbel-max (`rngs[b] is None` marks a dead row, which draws
        nothing)."""
        if self.greedy:
            return logits.argmax(-1).astype(np.int32)
        out = np.zeros(logits.shape[0], np.int32)
        for b, rng in enumerate(rngs or []):
            if rng is None:
                continue
            z = logits[b]
            out[b] = np.int32((z + rng.gumbel(size=z.shape)).argmax())
        return out

    # ------------------------------------------------------------------
    # energy model
    # ------------------------------------------------------------------
    def _kv_gather_bytes(self, batch_rows: int) -> float:
        """Non-GEMM KV-cache HBM traffic one call issues: attention reads
        each row's cached keys and values once under the dense layout; the
        paged layout first materialises the gathered per-row view through
        the page table and then reads it — 2x the cache bytes. An encdec
        call also reads each row's dense cross-KV (`max_len` source
        rows). A tensor-parallel rank reads its heads' 1/tp of the cache
        (MLA's latent cache would be replicated, whole)."""
        from repro_torch.models.config import kv_cache_bytes

        scale = 2.0 if self.kv_layout == "paged" else 1.0
        if self.cfg.kind == "encdec":
            scale += 1.0
        shard = 1 if self.cfg.kind == "mla_moe" else self._tp
        return (scale * kv_cache_bytes(self.cfg, batch_rows * self.max_len)
                / shard)

    def _step_energy(self, key, n_rows: int, head_rows: int | None = None,
                     batch_rows: int | None = None,
                     src_rows: int | None = None):
        """Predicted `StepEnergyEstimate` for a step over `n_rows` GEMM
        rows (decode: max_batch; chunk: padded token count, with the LM
        head sized to the rows actually unembedded and MLA's cache-wide
        K/V decompression sized to batch_rows * max_len; an encdec
        admission's encoder and cross-KV over `src_rows`), with the KV reads
        of `batch_rows` rows as extra HBM bytes, cached per key. Raises
        when the energy model fails."""
        hit = self._step_energy_cache.get(key)
        if hit is not None:
            return hit
        from repro_torch.core.energy import gemm_fleet_energy
        from repro_torch.models.config import (collective_wire_bytes,
                                               gemm_shape_counts)

        kv_rows = (batch_rows * self.max_len
                   if batch_rows is not None else None)
        wire_b, n_coll = collective_wire_bytes(
            self.cfg, n_rows, self._tp, head_tokens=head_rows,
            src_tokens=src_rows)
        est = gemm_fleet_energy(
            gemm_shape_counts(self.cfg, n_rows, head_tokens=head_rows,
                              kv_rows=kv_rows, tp=self._tp,
                              src_tokens=src_rows),
            chip=self.chip_spec, dtype=self.cfg.activation_dtype,
            configs=self.pretuned or None,
            extra_hbm_bytes=self._kv_gather_bytes(batch_rows or 0),
            tp=self._tp, collective_bytes=wire_b, n_collectives=n_coll,
            overlap_chunks=self.cfg.tp_overlap_chunks,
            name=f"{self.cfg.name}:{key}")
        self._step_energy_cache[key] = est
        return est

    @staticmethod
    def _cost(est) -> tuple[float, float, object]:
        """(energy_j, step_s, estimate) of a priced step."""
        return (est.energy_j, est.step_s, est)

    def _decode_cost(self) -> tuple[float, float, object]:
        """(energy_j, predicted step_s, est) of one lockstep decode
        step."""
        return self._cost(self._step_energy(
            ("decode", self.max_batch), self.max_batch,
            batch_rows=self.max_batch))

    def _prefill_cost(self, n_tokens: int, head_rows: int
                      ) -> tuple[float, float, object]:
        """(energy_j, step_s, est) of one prefill over `n_tokens` padded
        rows unembedding `head_rows` last positions (1 for a serial slot
        prefill, B for a wave)."""
        return self._cost(self._step_energy(
            ("prefill", int(n_tokens), int(head_rows)),
            int(n_tokens), int(head_rows), batch_rows=int(head_rows)))

    def _chunk_cost(self, width: int, chunk: int
                    ) -> tuple[float, float, object]:
        """(energy_j, step_s, est) of one admission chunk call: `width`
        lane rows of `chunk` tokens, LM head over last-valid positions."""
        return self._cost(self._step_energy(
            ("chunk", int(width), int(chunk)),
            int(width * chunk), int(width), batch_rows=int(width)))

    def _admit_cost(self, width: int, bucket: int
                    ) -> tuple[float, float, object]:
        """(energy_j, step_s, est) of one prefill-once admission call:
        encdec prices the encoder and every decoder layer's cross-KV over
        `width * bucket` source rows (no decoder rows); vlm the patch prefix
        through the decoder. Neither runs the LM head."""
        if self.cfg.kind == "encdec":
            return self._cost(self._step_energy(
                ("admit", int(width), int(bucket)), 0, 0,
                batch_rows=int(width), src_rows=int(width * bucket)))
        return self._cost(self._step_energy(
            ("admit", int(width), int(bucket)), int(width * bucket), 0,
            batch_rows=int(width)))

    def decode_step_estimate(self):
        """Predicted `StepEnergyEstimate` of one lockstep decode step over
        the full slot table."""
        return self._decode_cost()[2]

    def fused_step_estimate(self, width: int, chunk: int):
        """Predicted cost of one *fused* engine step — the decode fleet
        (max_batch rows) plus one chunk call's fleet (`width` x `chunk`
        rows) priced through a single duty-cycle power model
        (`core.energy.fused_step_energy`). Cached per (width, chunk)."""
        key = ("fused", int(width), int(chunk))
        hit = self._step_energy_cache.get(key)
        if hit is not None:
            return hit
        from repro_torch.core.energy import fused_step_energy
        from repro_torch.models.config import (collective_wire_bytes,
                                               gemm_shape_counts)

        tp = self._tp
        decode = gemm_shape_counts(self.cfg, self.max_batch,
                                   kv_rows=self.max_batch * self.max_len,
                                   tp=tp)
        ch = gemm_shape_counts(self.cfg, width * chunk, head_tokens=width,
                               kv_rows=width * self.max_len, tp=tp)
        wb_d, nc_d = collective_wire_bytes(self.cfg, self.max_batch, tp)
        wb_c, nc_c = collective_wire_bytes(self.cfg, width * chunk, tp,
                                           head_tokens=width)
        est = fused_step_energy(
            decode, ch, chip=self.chip_spec,
            dtype=self.cfg.activation_dtype,
            configs=self.pretuned or None,
            extra_hbm_bytes=(self._kv_gather_bytes(self.max_batch)
                             + self._kv_gather_bytes(width)),
            tp=tp, collective_bytes=wb_d + wb_c, n_collectives=nc_d + nc_c,
            overlap_chunks=self.cfg.tp_overlap_chunks,
            name=f"{self.cfg.name}:fused:{width}x{chunk}")
        self._step_energy_cache[key] = est
        return est

    # ------------------------------------------------------------------
    # device calls
    # ------------------------------------------------------------------
    def _continuous_supported(self) -> bool:
        """Whether the family has what continuous serving in the engine's
        layout and admission needs (the JAX engine's test): admit families
        run serial admission through admit + one full-prompt chunk, the
        path of chunked admission."""
        if (self.model.admit_dims is not None
                and (self.model.admit is None
                     or self.model.pack_admit is None)):
            return False
        if self.kv_layout == "paged":
            return (self.model.prefill_chunk is not None
                    and self.model.init_page_pool is not None)
        if self.admission == "chunked" or self.model.admit is not None:
            return (self.model.prefill_chunk is not None
                    and self.model.init_state is not None)
        return (self.model.init_cache is not None
                and self.model.init_state is not None)

    def _init_state(self, batch: int) -> dict:
        return self.model.init_state(self.cfg, batch, self.max_len,
                                     device=self.device)

    def _splice(self, dst: dict, src: dict, i: int, j: int) -> dict:
        """Copy row `i` of state `src` into row `j` of state `dst`."""
        axes = self._state_axes
        return L.insert_slot_state(dst, L.take_slot_state(src, axes, i),
                                   axes, j)

    def _logits(self, logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()

    def _admit_rows(self, reqs: list[Request], width: int
                    ) -> tuple[dict, float]:
        """Prefill-once admission of `reqs` into a fresh `width`-row zero
        state, in one call at the bucket of the largest prefix or source
        among them (the wave admits its whole batch; chunked admission packs
        a step's fresh admissions). Returns (admitted state, the call's
        energy)."""
        dims = [self._admit_dims(r) for r in reqs]
        bucket = self._bucket(max(max(p, s) for p, s in dims) or 1)
        packed = self.model.pack_admit(
            self.cfg, [r.extras for r in reqs], width, bucket,
            device=self.device)
        with ops.launch_objective(self.tune_objective):
            state = self.model.admit(self.params, packed,
                                     self._init_state(width), self.cfg)
        adm_j, adm_s, adm_est = self._admit_cost(width, bucket)
        self._tick(adm_s, adm_est)
        self._stats["admit_calls"] += 1
        return state, adm_j

    def _prefill_slot(self, req: Request, rng) -> tuple[int, dict, float]:
        """Single-shot slot prefill (``admission="serial"``): one request
        alone, right-padded to a pow2 bucket; samples its first token. Admit
        families run their admission call plus one full-prompt chunk, the
        path of chunked admission. Returns (first token, batch-1 slot state,
        prefill energy)."""
        if req.replay:
            raise ValueError(
                "replay requests require chunked admission (serve_step)")
        n = len(req.prompt)
        bucket = self._bucket(n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = req.prompt
        if self.model.admit is not None:
            state, adm_j = self._admit_rows([req], 1)
            with ops.launch_objective(self.tune_objective):
                logits, state = self.model.prefill_chunk(
                    self.params, torch.as_tensor(toks, device=self.device),
                    torch.as_tensor([n], device=self.device), state,
                    self.cfg)
            pre_j, pre_s, pre_est = self._chunk_cost(1, bucket)
            self._tick(pre_s, pre_est)
            tok = int(self._sample(self._logits(logits), [rng])[0])
            return tok, state, adm_j + pre_j
        with ops.launch_objective(self.tune_objective):
            logits, state = self.model.prefill(
                self.params,
                {"tokens": torch.as_tensor(toks, device=self.device),
                 "lengths": torch.as_tensor([n], device=self.device)},
                self.cfg, max_len=self.max_len)
        tok = int(self._sample(self._logits(logits), [rng])[0])
        pre_j, pre_s, pre_est = self._prefill_cost(bucket, head_rows=1)
        self._tick(pre_s, pre_est)
        return tok, state, pre_j

    def _finish(self, slot: _Slot, now: float, decode_energy_j: float,
                results: list[Result]) -> None:
        req = slot.req
        n_tok = len(slot.tokens)
        decode_s = max(now - slot.t_first, 0.0)
        energy = (slot.prefill_energy_j
                  + slot.steps * decode_energy_j / self.max_batch)
        self._stats["generated_tokens"] += n_tok
        self._stats["energy_j"] += energy
        self._stats["requests"] += 1
        results.append(Result(
            uid=req.uid, tokens=np.array(slot.tokens, np.int32),
            prompt_len=len(req.prompt), steps=slot.steps, n_tokens=n_tok,
            queue_s=max(slot.t_start - req.submit_s, 0.0),
            ttft_s=max(slot.t_first - req.submit_s, 0.0),
            ttft_model_s=max(slot.t_first_model - req.submit_model_s, 0.0),
            decode_s=decode_s,
            tokens_per_s=(n_tok / decode_s if decode_s > 0 else 0.0),
            energy_j=energy, energy_per_token_j=energy / max(n_tok, 1),
            prefill_energy_j=slot.prefill_energy_j))

    def _decode_step(self, slots, batch_state, token_buf, decode_cost,
                     results):
        """One lockstep decode step over the slot table; retires finished
        slots in place. Returns the new batch state."""
        decode_energy_j, decode_step_s, decode_est = decode_cost
        B = self.max_batch
        active = np.array([s is not None for s in slots])
        if not active.any():
            return batch_state
        self._tick(decode_step_s, decode_est)
        with ops.launch_objective(self.tune_objective):
            logits, batch_state = self.model.decode_step(
                self.params, torch.as_tensor(token_buf, device=self.device),
                batch_state, self.cfg)
        cur = self._sample(self._logits(logits),
                           [s.rng if s is not None else None for s in slots])
        now = time.perf_counter()
        n_active = int(active.sum())
        self._stats["decode_steps"] += 1
        self._stats["slot_steps"] += B
        self._stats["resident_slot_steps"] += n_active
        # dead slots still execute: their share of the step's energy is
        # charged to the engine (idle), not to any request
        self._stats["idle_energy_j"] += (
            (B - n_active) * decode_energy_j / B)
        for b in range(B):
            slot = slots[b]
            if slot is None:
                continue
            tok = int(cur[b])
            slot.tokens.append(tok)
            slot.steps += 1
            token_buf[b] = tok
            req = slot.req
            if (req.eos_id is not None and tok == req.eos_id) or (
                    len(slot.tokens) >= self._budget(req)):
                self._finish(slot, now, decode_energy_j, results)
                slots[b] = None      # retired mid-decode; refilled
                token_buf[b] = 0     # next loop iteration
        return batch_state

    # ------------------------------------------------------------------
    # the serving loops
    # ------------------------------------------------------------------
    def run_until_empty(self) -> list[Result]:
        """Serve every queued request to completion in the engine's mode
        (``mode="auto"`` picks continuous batching when the family
        supports it, else the wave loop)."""
        self._activate()
        mode = self.mode
        if mode == "auto":
            mode = ("continuous" if self._continuous_supported()
                    else "wave")
        if mode == "continuous":
            return self.run_continuous()
        results: list[Result] = []
        while self.queue:
            results.extend(self.run_wave())
        return results

    def run_continuous(self) -> list[Result]:
        """Drain the queue with continuous batching (retire finished slots
        mid-decode and refill them at once), in the engine's layout and
        admission."""
        if not self._continuous_supported():
            raise ValueError(
                f"continuous batching unsupported for kind="
                f"{self.cfg.kind!r} (needs the per-row decode-state "
                f"contract); use wave mode")
        self._activate()
        if self.kv_layout == "paged":
            return self._run_paged()
        if self.admission == "serial":
            return self._run_serial()
        out: list[Result] = []
        while self.has_work:
            out.extend(self.serve_step())
        return out

    def serve_step(self) -> list[Result]:
        """Advance chunked continuous serving by one engine step — admit
        from the queue, one bucketed chunk call over the admission lane, one
        lockstep decode step over the residents — and return the requests
        that finished during it. Requires continuous mode with
        ``admission="chunked"`` and the dense KV layout: the paged, serial
        and wave loops are not steppable. Returns ``[]`` on the final call
        that observes the drained loop; poll `has_work` to drive to
        exhaustion."""
        self._activate()
        if self._stepper is None:
            if not self.queue and not self._adopted:
                return []
            if (self.mode == "wave" or self.admission != "chunked"
                    or self.kv_layout != "dense"
                    or not self._continuous_supported()):
                raise ValueError(
                    f"serve_step requires chunked continuous serving on "
                    f"the dense KV layout (kind={self.cfg.kind!r}, "
                    f"mode={self.mode!r}, admission={self.admission!r}, "
                    f"kv_layout={self.kv_layout!r})")
            self._stepper = self._chunked_stepper()
        try:
            return next(self._stepper)
        except StopIteration:
            self._stepper = None
            self._live = None
            self._lane_view = dict.fromkeys(self._lane_view, 0)
            return []

    def _chunked_stepper(self):
        """Generator behind `serve_step`: owns the admission lane, slot
        table and decode state across yields. Vacated lane rows (spliced
        out, or finished on their first token) go to a free list and are
        reused in place; the lane state is reallocated only when its pow2
        width must grow. A reused row still holds its old occupant's cache
        and index, so it is zeroed by a one-row splice first."""
        B = self.max_batch
        results: list[Result] = []
        lv = self._live = _LiveState(B)
        decode_cost = self._decode_cost()
        decode_energy_j = decode_cost[0]

        def zero_lane_row(r: int) -> None:
            if lv.zero_src is None:
                lv.zero_src = self._init_state(1)
            self._splice(lv.adm_state, lv.zero_src, 0, r)

        def adopt_ready() -> None:
            """Splice adopted decode-state rows (checkpointed off a failed
            fleet member) into free decode slots. The row's spend so far
            rides in as its prefill energy, so the final Result covers both
            attempts; a row already at its end retires at once."""
            free = [b for b in range(B) if lv.slots[b] is None]
            now = time.perf_counter()
            while self._adopted and free:
                rec = self._adopted.popleft()
                b = free.pop(0)
                if lv.batch_state is None:
                    lv.batch_state = self._init_state(B)
                self._splice(lv.batch_state, rec["state"], 0, b)
                req = rec["req"]
                slot = _Slot(req=req, tokens=[int(t) for t in rec["tokens"]],
                             prefill_energy_j=float(rec["energy_j"]),
                             t_start=now, t_first=now,
                             t_first_model=self.model_clock_s,
                             rng=rec.get("rng"))
                self._stats["adopted_in"] += 1
                tok = slot.tokens[-1]
                if (req.eos_id is not None and tok == req.eos_id) or (
                        len(slot.tokens) >= self._budget(req)):
                    self._finish(slot, now, decode_energy_j, results)
                    continue
                lv.slots[b] = slot
                lv.token_buf[b] = tok

        def splice_ready() -> None:
            """Move parked admissions into free decode slots, FIFO by
            first-token time; their lane rows return to the free list."""
            free = [b for b in range(B) if lv.slots[b] is None]
            if not free:
                return
            keep: list[_Admission] = []
            for a in lv.adm:
                if a.ready is None or not free:
                    keep.append(a)
                    continue
                b = free.pop(0)
                if lv.batch_state is None:
                    lv.batch_state = self._init_state(B)
                self._splice(lv.batch_state, lv.adm_state, a.row, b)
                lv.lane_free.append(a.row)
                lv.lane_dirty.add(a.row)
                lv.slots[b] = a.ready
                lv.token_buf[b] = a.first_tok
            lv.adm = keep

        def chunk_stage() -> bool:
            """One chunk call over the rows still prefilling (parked and
            vacant rows ride along with length 0). Samples first tokens for
            rows whose last chunk landed. Returns True when a request
            finished outright on its first token (a lane row freed)."""
            W = lv.adm_w or 1
            while W < len(lv.adm):
                W *= 2
            if lv.adm_state is None or W > lv.adm_w:
                # width growth (or first build): reallocate, carrying every
                # in-progress row across at its own index (sticky rows)
                new_state = self._init_state(W)
                held = set()
                for a in lv.adm:
                    if a.row >= 0:
                        held.add(a.row)
                        if a.base > 0:
                            self._splice(new_state, lv.adm_state, a.row,
                                         a.row)
                lv.adm_state, lv.adm_w = new_state, W
                lv.lane_free = [r for r in range(W) if r not in held]
                lv.lane_dirty.clear()
                self._stats["lane_rebuilds"] += 1
            lv.lane_free.sort()
            fresh: list[_Admission] = []
            for a in lv.adm:
                if a.row < 0:
                    a.row = lv.lane_free.pop(0)
                    if self.model.admit is not None:
                        # the admission splice below overwrites the whole
                        # row: no zeroing needed
                        lv.lane_dirty.discard(a.row)
                        fresh.append(a)
                    elif a.row in lv.lane_dirty:
                        lv.lane_dirty.discard(a.row)
                        zero_lane_row(a.row)
            if fresh:
                # prefill-once admission: one packed call over this step's
                # fresh admissions, each row spliced into its lane row
                Wb = 1
                while Wb < len(fresh):
                    Wb *= 2
                t_adm = time.perf_counter()
                src_state, adm_j = self._admit_rows(
                    [a.req for a in fresh], Wb)
                for i, a in enumerate(fresh):
                    self._splice(lv.adm_state, src_state, i, a.row)
                    a.chunk_energy_j += adm_j / Wb
                    if a.t_start == 0.0:
                        a.t_start = t_adm
                del src_state
            pending = [a for a in lv.adm if a.ready is None]
            # shortest-remainder-first bucket: short admissions finish in
            # cheap narrow calls; long prompts still progress min(C, rem)
            # tokens per step
            rem = [len(a.eff) - a.base for a in pending]
            C = self._chunk_bucket(min(rem))
            if self.chunk_policy is not None:
                # the scheduler's override; every ladder bucket is valid
                # (chunk boundaries stay bucket and grain aligned)
                want = self.chunk_policy(
                    self, [(a.req, len(a.eff) - a.base) for a in pending])
                if want:
                    C = self._chunk_bucket(int(want))
            if self.cfg.sub_quadratic and any(r > C for r in rem):
                # a non-final chunk boundary must stay a multiple of the SSM
                # serve-scan block or the carried state loses bit parity
                # with the unchunked prefill; the only unaligned bucket is a
                # non-multiple max_len, so drop to the widest aligned one
                # (validated to exist at construction)
                while C % self.ssm_grain:
                    C = self._chunk_bucket(C // 2)
            toks = np.zeros((W, C), np.int32)
            lens = np.zeros(W, np.int64)
            t_disp = time.perf_counter()
            for a in pending:
                n = min(C, len(a.eff) - a.base)
                toks[a.row, :n] = a.eff[a.base:a.base + n]
                lens[a.row] = n
                if a.t_start == 0.0:
                    a.t_start = t_disp
            with ops.launch_objective(self.tune_objective):
                logits, lv.adm_state = self.model.prefill_chunk(
                    self.params, torch.as_tensor(toks, device=self.device),
                    torch.as_tensor(lens, device=self.device), lv.adm_state,
                    self.cfg)
            logits = self._logits(logits)
            now = time.perf_counter()
            est_j, est_s, est = self._chunk_cost(W, C)
            self._tick(est_s, est)
            self._stats["chunk_steps"] += 1
            # lane pad and parked rows are executed spend with no owner
            self._stats["idle_energy_j"] += (W - len(pending)) * est_j / W
            keep: list[_Admission] = []
            freed = False
            for a in lv.adm:
                if a.ready is not None:
                    keep.append(a)
                    continue
                a.base += int(lens[a.row])
                a.chunk_energy_j += est_j / W
                if a.base < len(a.eff):
                    keep.append(a)
                    continue
                replay = a.req.replay
                if replay:
                    # fault replay: the emitted tokens are forced, not
                    # resampled, so the stream continues append-only; a
                    # sampled row burns the failed attempt's Gumbel draws
                    # so its later tokens keep their bits
                    if a.rng is not None:
                        for _ in replay:
                            a.rng.gumbel(size=logits.shape[-1])
                    tok = int(replay[-1])
                    toks0 = [int(t) for t in replay]
                else:
                    tok = int(self._sample(logits[a.row:a.row + 1],
                                           [a.rng])[0])
                    toks0 = [tok]
                srec = _Slot(req=a.req, tokens=toks0,
                             prefill_energy_j=a.chunk_energy_j,
                             t_start=a.t_start, t_first=now,
                             t_first_model=self.model_clock_s, rng=a.rng)
                # EOS or a spent budget on the first (or last replayed)
                # token: finished before occupying a decode slot
                if (a.req.eos_id is not None and tok == a.req.eos_id) or (
                        len(toks0) >= self._budget(a.req)):
                    self._finish(srec, now, decode_energy_j, results)
                    lv.lane_free.append(a.row)
                    lv.lane_dirty.add(a.row)
                    freed = True
                    continue
                a.ready = srec
                a.first_tok = tok
                keep.append(a)
            lv.adm = keep
            if not lv.adm:
                lv.adm_state, lv.adm_w = None, 0
                lv.lane_free = []
                lv.lane_dirty.clear()
            return freed

        emitted = 0
        while (self.queue or self._adopted or lv.adm
               or any(s is not None for s in lv.slots)):
            t_it0 = time.perf_counter()
            # adopt + admit + chunk: splice adopted rows, fill free lane
            # rows from the queue and run one chunk call; a request
            # finishing on its first token frees its row again, so keep
            # admitting while the queue has work
            adopt_ready()
            splice_ready()
            while True:
                while self.queue and len(lv.adm) < self.lane_width:
                    req = self.queue.popleft()
                    rng = None if self.greedy else self._req_rng(req.uid)
                    eff = np.asarray(req.prompt, np.int32)
                    if req.replay and len(req.replay) > 1:
                        eff = np.concatenate(
                            [eff, np.asarray(req.replay[:-1], np.int32)])
                    lv.adm.append(_Admission(req=req, rng=rng, eff=eff))
                if not any(a.ready is None for a in lv.adm):
                    break
                freed = chunk_stage()
                if not (freed and self.queue):
                    break
            adopt_ready()
            splice_ready()
            # one lockstep decode step over the residents
            lv.batch_state = self._decode_step(
                lv.slots, lv.batch_state, lv.token_buf, decode_cost,
                results)
            self._stats["wall_s"] += time.perf_counter() - t_it0
            pending_n = sum(a.ready is None for a in lv.adm)
            self._lane_view = {
                "pending": pending_n,
                "pending_tokens": sum(len(a.eff) - a.base for a in lv.adm
                                      if a.ready is None),
                "parked": len(lv.adm) - pending_n,
                "resident": sum(s is not None for s in lv.slots),
                "in_flight": len(lv.adm),
            }
            new, emitted = results[emitted:], len(results)
            yield new
        self._live = None

    def _run_serial(self) -> list[Result]:
        """Serial admission: each request prefills alone (one single-shot
        bucketed call) and is spliced into a free slot; the loop stalls for
        the whole prompt, which is what chunked admission removes."""
        t_run0 = time.perf_counter()
        B = self.max_batch
        results: list[Result] = []
        slots: list[_Slot | None] = [None] * B
        batch_state = None
        token_buf = np.zeros(B, np.int32)
        decode_cost = self._decode_cost()
        decode_energy_j = decode_cost[0]

        while self.queue or any(s is not None for s in slots):
            # refill free slots from the queue; a request finishing on its
            # first token frees the slot again, so keep admitting until the
            # slot holds a live request or the queue drains
            for b in range(B):
                while slots[b] is None and self.queue:
                    req = self.queue.popleft()
                    rng = None if self.greedy else self._req_rng(req.uid)
                    t0 = time.perf_counter()
                    tok, slot_state, pre_j = self._prefill_slot(req, rng)
                    t1 = time.perf_counter()
                    slot = _Slot(req=req, tokens=[tok],
                                 prefill_energy_j=pre_j, t_start=t0,
                                 t_first=t1,
                                 t_first_model=self.model_clock_s, rng=rng)
                    # EOS or a budget of one on the first token: finished
                    # before occupying a decode slot
                    if (req.eos_id is not None and tok == req.eos_id) or (
                            self._budget(req) <= 1):
                        self._finish(slot, t1, decode_energy_j, results)
                        continue
                    if batch_state is None:
                        batch_state = self._init_state(B)
                    self._splice(batch_state, slot_state, 0, b)
                    slots[b] = slot
                    token_buf[b] = tok
            if not any(s is not None for s in slots):
                break                  # queue drained, no live slots
            batch_state = self._decode_step(
                slots, batch_state, token_buf, decode_cost, results)
        self._stats["wall_s"] += time.perf_counter() - t_run0
        return results

    def run_wave(self) -> list[Result]:
        """Serve one wave: take up to max_batch queued requests, prefill
        them in one batched call right-padded to the longest prompt (not
        bucketed), decode until all finish. Finished rows stay resident to
        the end of the wave (counted in `steps`, so the energy attribution
        shows the waste)."""
        if not self.queue:
            return []
        if any(r.replay for r in self.queue):
            raise ValueError(
                "replay requests require chunked admission (serve_step)")
        self._activate()
        t_run0 = time.perf_counter()
        batch_reqs = [self.queue.popleft()
                      for _ in range(min(self.max_batch, len(self.queue)))]
        B = len(batch_reqs)
        lens = np.array([len(r.prompt) for r in batch_reqs], np.int32)
        S = int(lens.max())
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(batch_reqs):
            toks[i, :lens[i]] = r.prompt           # right-pad + lengths
        t0 = time.perf_counter()
        if self.model.admit is not None:
            # admit families: one batched admission of all B rows, then one
            # full-width chunk over the right-padded prompts (the path of
            # chunked admission)
            state, adm_j = self._admit_rows(batch_reqs, B)
            Sb = self._bucket(S)
            wt = np.zeros((B, Sb), np.int32)
            wt[:, :S] = toks
            with ops.launch_objective(self.tune_objective):
                logits, state = self.model.prefill_chunk(
                    self.params, torch.as_tensor(wt, device=self.device),
                    torch.as_tensor(lens, device=self.device), state,
                    self.cfg)
            logits = self._logits(logits)
            t_first = time.perf_counter()
            prefill_j, prefill_s, pre_est = self._chunk_cost(B, Sb)
            prefill_j += adm_j
        else:
            with ops.launch_objective(self.tune_objective):
                logits, state = self.model.prefill(
                    self.params,
                    {"tokens": torch.as_tensor(toks, device=self.device),
                     "lengths": torch.as_tensor(lens, device=self.device)},
                    self.cfg, max_len=self.max_len)
            logits = self._logits(logits)
            t_first = time.perf_counter()
            prefill_j, prefill_s, pre_est = self._prefill_cost(
                B * S, head_rows=B)
        self._tick(prefill_s, pre_est)
        t_first_model = self.model_clock_s
        decode_energy_j, decode_step_s, decode_est = self._cost(
            self._step_energy(("decode", B), B, batch_rows=B))

        # per-row budgets: each row clamps by its own prompt, never by the
        # wave's padded length
        budgets = np.array([self._budget(r) for r in batch_reqs])
        out: list[list[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        steps = 0
        rngs = [None if self.greedy else self._req_rng(r.uid)
                for r in batch_reqs]
        cur = self._sample(logits, rngs)
        for i, r in enumerate(batch_reqs):
            tok = int(cur[i])
            out[i].append(tok)
            # EOS or a budget of one on the first sampled token
            if (r.eos_id is not None and tok == r.eos_id) or (
                    budgets[i] <= 1):
                done[i] = True
        while not done.all():
            self._tick(decode_step_s, decode_est)
            with ops.launch_objective(self.tune_objective):
                logits, state = self.model.decode_step(
                    self.params, torch.as_tensor(cur, device=self.device),
                    state, self.cfg)
            cur = self._sample(
                self._logits(logits),
                [None if done[i] else rngs[i] for i in range(B)])
            steps += 1
            for i, r in enumerate(batch_reqs):
                if done[i]:
                    continue
                tok = int(cur[i])
                out[i].append(tok)
                if (r.eos_id is not None and tok == r.eos_id) or (
                        len(out[i]) >= budgets[i]):
                    done[i] = True
        t_end = time.perf_counter()
        self._stats["decode_steps"] += steps
        self._stats["slot_steps"] += steps * B
        self._stats["resident_slot_steps"] += steps * B
        results = []
        for i, r in enumerate(batch_reqs):
            n_tok = len(out[i])
            # resident until the wave drains
            energy = prefill_j / B + steps * decode_energy_j / B
            decode_s = max(t_end - t_first, 0.0)
            self._stats["generated_tokens"] += n_tok
            self._stats["energy_j"] += energy
            self._stats["requests"] += 1
            results.append(Result(
                uid=r.uid, tokens=np.array(out[i], np.int32),
                prompt_len=len(r.prompt), steps=steps, n_tokens=n_tok,
                queue_s=max(t0 - r.submit_s, 0.0),
                ttft_s=max(t_first - r.submit_s, 0.0),
                ttft_model_s=max(t_first_model - r.submit_model_s, 0.0),
                decode_s=decode_s,
                tokens_per_s=n_tok / decode_s if decode_s > 0 else 0.0,
                energy_j=energy, energy_per_token_j=energy / max(n_tok, 1),
                prefill_energy_j=prefill_j / B))
        self._stats["wall_s"] += time.perf_counter() - t_run0
        return results

    # ------------------------------------------------------------------
    # fault recovery (serving.faults, serving.scheduler)
    # ------------------------------------------------------------------
    def state_compatible(self, other: "ServingEngine") -> bool:
        """True when a decode-state row checkpointed from `other` continues
        here bit for bit: the same model API and params objects, config,
        cache geometry, dense layout and sampling (seed, greedy). The
        scheduler migrates such rows and replays the rest."""
        return (self.model is other.model
                and self.params is other.params
                and self.cfg == other.cfg
                and self.max_len == other.max_len
                and self.tp == other.tp
                and self.kv_layout == "dense"
                and other.kv_layout == "dense"
                and self.seed == other.seed
                and self.greedy == other.greedy)

    def checkpoint_inflight(self, *, state_lost: bool = False
                            ) -> list[dict]:
        """Take every in-flight request out for recovery on another
        member, then clear this engine (a crash: queue, lane and slot
        table are gone afterwards).

        Each record carries the request, its emitted tokens, its
        attributable energy so far, its sampling stream, its
        engine-relative TTFT once its first token was out, and, for rows
        whose device state survives (decode slots and parked admissions,
        unless ``state_lost``), a clone of its batch-1 decode state for
        `adopt` on a compatible member. Mid-prefill admissions and queued
        requests restart from scratch; their partial chunk energy is the
        failed attempt's lost spend (`charge_lost_energy`)."""
        records: list[dict] = []
        lv = self._live
        decode_j = self._decode_cost()[0]

        def rec(req, tokens, state, energy, rng, ttft, lost=0.0):
            records.append({
                "req": req, "tokens": list(tokens), "state": state,
                "energy_j": float(energy), "rng": rng,
                "ttft_model_s": ttft, "lost_energy_j": float(lost)})

        def row(state, i):
            # a clone: the source state is written in place by whatever
            # runs on this engine next
            if state_lost or state is None:
                return None
            return L.tree_map(torch.clone, L.take_slot_state(
                state, self._state_axes, i))

        if lv is not None:
            for b, slot in enumerate(lv.slots):
                if slot is None:
                    continue
                state = row(lv.batch_state, b)
                energy = (slot.prefill_energy_j
                          + slot.steps * decode_j / self.max_batch)
                rec(slot.req, slot.tokens, state, energy, slot.rng,
                    max(slot.t_first_model - slot.req.submit_model_s, 0.0),
                    lost=0.0 if state is not None else energy)
            for a in lv.adm:
                if a.ready is not None:
                    state = row(lv.adm_state, a.row)
                    energy = a.ready.prefill_energy_j
                    rec(a.req, a.ready.tokens, state, energy, a.rng,
                        max(a.ready.t_first_model - a.req.submit_model_s,
                            0.0),
                        lost=0.0 if state is not None else energy)
                else:
                    # mid-prefill: partial chunks cannot move; the spend so
                    # far is lost with the failed attempt
                    rec(a.req, [], None, 0.0, None, None,
                        lost=a.chunk_energy_j)
        for r in self._adopted:
            records.append(dict(r) if not state_lost
                           else {**r, "state": None,
                                 "lost_energy_j": r["energy_j"],
                                 "energy_j": 0.0})
        for req in self.queue:
            rec(req, req.replay or [], None, 0.0, None, None)
        self.queue.clear()
        self._adopted.clear()
        self._stepper = None
        self._live = None
        self._lane_view = dict.fromkeys(self._lane_view, 0)
        return records

    def adopt(self, record: dict) -> None:
        """Take a checkpointed decode-state row from a failed member
        (migration). It waits in the adoption queue until a decode slot
        frees; `has_work` counts it. Raises for a record without state or
        with a state of another structure: the scheduler replays those."""
        if record.get("state") is None:
            raise ValueError(
                "adopt needs a checkpointed state row; replay lost-state "
                "requests instead")
        if self.kv_layout != "dense" or self.admission != "chunked":
            raise ValueError(
                "adoption requires chunked continuous serving on the "
                "dense KV layout")
        spec = self.model.init_state(self.cfg, 1, self.max_len,
                                     device="meta")
        if not L.state_structures_match(record["state"], spec):
            raise ValueError(
                "checkpointed state row is structurally incompatible "
                "with this engine's decode state")
        self._adopted.append(record)

    def charge_lost_energy(self, j: float) -> None:
        """Charge the spend of a failed attempt whose work is replayed:
        real spend with no surviving owner, folded into this engine's idle
        share (so fleet ledgers still sum) and kept in `lost_energy_j`."""
        self._stats["idle_energy_j"] += float(j)
        self._stats["lost_energy_j"] += float(j)

    def retune(self, *, objective: str = "runtime",
               rank_mode: str = "auto", _inject=None) -> bool:
        """Tune the engine's GEMM fleet again mid-run
        (`ops.warm_gemm_cache(strict=True)`); on success the engine
        launches `objective`'s winners. On an `ArtifactError` (a corrupt or
        missing predictor artifact, or the injected fault ``_inject``) it
        degrades instead of raising: pricing falls back to
        `autotuner.baseline_configs`, nothing is installed, so every launch
        keeps its tile, serving continues and `report()` carries
        ``tuning_degraded`` with the reason. Returns True when tuning
        succeeded, False when it degraded."""
        from repro_torch.core.predictor import ArtifactError

        chunked = self.admission == "chunked"
        fleet = ops.serving_gemm_fleet(
            self.cfg, max_batch=self.max_batch, max_len=self.max_len,
            include_slot_prefill=self._continuous_supported(),
            chunk_tokens=self.chunk_tokens if chunked else None,
            lane_width=self.lane_width if chunked else None,
            grain=self.ssm_grain)
        try:
            if _inject is not None:
                raise _inject
            self.pretuned = ops.warm_gemm_cache(
                fleet, dtype=self.cfg.activation_dtype,
                objective=objective, chip=self.chip, rank_mode=rank_mode,
                strict=True)
            self.tune_objective = objective
            self.tuning_degraded = False
            self._degraded_reason = None
        except ArtifactError as e:
            from repro_torch.core.autotuner import baseline_configs

            self.pretuned = baseline_configs(fleet, self.chip_spec,
                                             self.cfg.activation_dtype)
            self.tuning_degraded = True
            self._degraded_reason = str(e)
        # the step estimates were priced at the old tiles
        self._step_energy_cache.clear()
        return not self.tuning_degraded

    def inject_page_pressure(self, pages: int) -> int:
        """Squeeze `pages` pages out of the paged KV pool (an external
        tenant, a chaos fault). Returns how many were taken;
        `release_page_pressure` gives them back."""
        if self._allocator is None:
            raise ValueError("page pressure requires kv_layout='paged'")
        return self._allocator.squeeze(pages)

    def release_page_pressure(self) -> int:
        """Return every squeezed page to the paged KV pool."""
        if self._allocator is None:
            raise ValueError("page pressure requires kv_layout='paged'")
        return self._allocator.unsqueeze()

    # ------------------------------------------------------------------
    # the paged layout
    # ------------------------------------------------------------------
    def _ensure_pool(self) -> None:
        """Build the device page pool on first use (the engine's largest
        allocation: an engine built but never run does not pay it)."""
        if self._pool is None:
            self._pool = self.model.init_page_pool(
                self.cfg, self._allocator.num_pages, self.page_size,
                device=self.device)

    def _run_paged(self) -> list[Result]:
        """Chunked-admission continuous batching over the paged KV layout.

        The structure of the chunked loop, but every row's cache lives in
        one shared device page pool addressed through page tables built on
        the host from `PageAllocator` records, which changes three things:

        * the pool goes through every chunk call and decode step (one
          device state, not a lane state and a slot state), each call's
          page table and cache positions rebuilt from host records — so
          parking a finished admission and moving it into a decode slot
          move a page list on the host and copy nothing on the device;
        * admission reserves a request's full page capacity up front
          (`PageAllocator.admit`) and reuses registered shared-prefix
          pages, skipping their chunks (`base` starts past the matched
          tokens). When the pool cannot cover a reservation the registry is
          shed and, if that frees nothing, the request waits at the head of
          the queue for a retirement — unless nothing is in flight, which
          raises `PageCacheFull`;
        * a prompt whose last chunk landed registers its pages in the
          prefix registry (plus a frozen snapshot of a partial last page)
          for later requests to map copy-on-write.

        Admit families run their admission at `admit_from_queue`, one
        request at a time: the vlm patch prefix writes rows [0, prefix) of
        the reserved pages and the text starts past them; encdec's cross-KV
        and ``src_len`` (vlm's ``pos_off``) are dense batch-1 leaves of the
        request, joined along the batch axis into every call's state, as
        the JAX engine does. They never match nor register a prefix.

        Streams equal the dense layout's: the gathered per-row view spans
        the same max_len positions under the same masks, and every
        unmasked position holds the same written values. The allocator's
        page copies run on the pool as they come (`copy_pool_pages`); the
        JAX engine pads each batch of copies to a pow2 with null-page
        self-copies to bound its jit traces, which torch does not need."""
        from repro_torch.serving.paging import PageCacheFull

        self._ensure_pool()
        if any(r.replay for r in self.queue):
            raise ValueError("replay requests require the dense KV layout")
        t_run0 = time.perf_counter()
        B = self.max_batch
        n_pg = self._n_row_pages
        n_layers = self.cfg.n_layers
        results: list[Result] = []
        slots: list[_Slot | None] = [None] * B
        token_buf = np.zeros(B, np.int32)
        decode_cost = self._decode_cost()
        decode_energy_j = decode_cost[0]
        adm: list[_Admission] = []
        alloc = self._allocator
        pool = self._pool
        admit_family = self.model.admit is not None
        # admit families' dense per-request leaves: every leaf of the dense
        # state but the index and the KV that has a paged twin in the pool
        spec = self.model.init_state(self.cfg, 1, self.max_len,
                                     device="meta")
        extra_top_keys = [k for k in spec if k not in ("kv", "index")]
        extra_kv_keys = [k for k in spec["kv"]
                         if f"{k}_pages" not in pool and k not in pool]

        def zero_leaf(leaf, ax: int, width: int) -> torch.Tensor:
            shape = list(leaf.shape)
            shape[ax] = width
            return torch.zeros(shape, dtype=leaf.dtype, device=self.device)

        def zero_extras(width: int) -> tuple[dict, dict]:
            """Zeroed extra leaves of `width` rows."""
            axes = self._state_axes
            return ({k: zero_leaf(spec[k], axes[k], width)
                     for k in extra_top_keys},
                    {k: zero_leaf(spec["kv"][k], axes["kv"][k], width)
                     for k in extra_kv_keys})

        def gather_extras(recs: list, width: int) -> tuple[dict, dict]:
            """Each call's extra leaves: the records' batch-1 leaves (zero
            rows for empty slots and pad rows) joined along each leaf's
            batch axis. Records are `_Admission`s or `_Slot`s."""
            if not admit_family:
                return {}, {}
            rows = list(recs[:width]) + [None] * (width - len(recs[:width]))
            ztop, zkv = zero_extras(1)
            axes = self._state_axes

            def join(key, leaves, zero, ax):
                return torch.cat([(leaves(r)[key] if r is not None
                                   and leaves(r) else zero[key])
                                  for r in rows], dim=ax)

            top = {k: join(k, lambda r: r.extra_top, ztop, axes[k])
                   for k in extra_top_keys}
            kvx = {k: join(k, lambda r: r.extra_kv, zkv, axes["kv"][k])
                   for k in extra_kv_keys}
            return top, kvx

        def dev_table(rows: list[list[int] | None], width: int):
            """(L, width, n_pg) device table from per-row page lists (rows
            missing or short padded with the null page): one table
            broadcast over the layers."""
            tbl = np.zeros((width, n_pg), np.int64)
            for i, pgs in enumerate(rows):
                if pgs:
                    tbl[i, :len(pgs)] = pgs
            return torch.as_tensor(tbl, device=self.device)[None].expand(
                n_layers, width, n_pg)

        def apply_copies(copies: list[tuple[int, int]]) -> None:
            """Run the allocator's (src, dst) page copies on the pool: COW
            forks and prefix snapshots."""
            if copies:
                src, dst = zip(*copies)
                L.copy_pool_pages(
                    pool, torch.as_tensor(src, device=self.device),
                    torch.as_tensor(dst, device=self.device))

        def admit_from_queue() -> None:
            """Admit queued requests while the lane has room and the pool
            covers their full reservation (see the docstring above)."""
            while self.queue and len(adm) < self.lane_width:
                req = self.queue[0]
                prefix, src = self._admit_dims(req)
                try:
                    a = alloc.admit(np.asarray(req.prompt, np.int32),
                                    self._budget(req), prefix_rows=prefix,
                                    reuse=not admit_family)
                except PageCacheFull:
                    # under pool pressure the prefix registry is a cache,
                    # not a promise: shed it (sole-owner pages free now,
                    # shared ones with their last reader) and retry before
                    # deferring the admission
                    if alloc.shed_registry():
                        continue
                    if not adm and not any(s is not None for s in slots):
                        raise
                    break
                self.queue.popleft()
                apply_copies(a.copies)
                rng = None if self.greedy else self._req_rng(req.uid)
                rec = _Admission(req=req, rng=rng, base=a.base,
                                 pages=a.pages, prefix=prefix)
                if admit_family and (prefix or src):
                    bucket = self._bucket(max(prefix, src))
                    packed = self.model.pack_admit(
                        self.cfg, [req.extras], 1, bucket,
                        device=self.device)
                    top0, kv0 = zero_extras(1)
                    st = {"kv": {**pool, "table": dev_table([a.pages], 1),
                                 **kv0},
                          "index": torch.zeros(1, dtype=torch.long,
                                               device=self.device), **top0}
                    with ops.launch_objective(self.tune_objective):
                        st = self.model.admit(self.params, packed, st,
                                              self.cfg)
                    rec.extra_top = {k: st[k] for k in extra_top_keys}
                    rec.extra_kv = {k: st["kv"][k] for k in extra_kv_keys}
                    adm_j, adm_s, adm_est = self._admit_cost(1, bucket)
                    self._tick(adm_s, adm_est)
                    self._stats["admit_calls"] += 1
                    rec.chunk_energy_j += adm_j
                    rec.t_start = time.perf_counter()
                adm.append(rec)

        def splice_ready() -> None:
            """Move parked admissions into free decode slots: a host move
            of the page list (the row's KV already lives in the pool)."""
            nonlocal adm
            free = [b for b in range(B) if slots[b] is None]
            if not free:
                return
            keep: list[_Admission] = []
            for a in adm:
                if a.ready is None or not free:
                    keep.append(a)
                    continue
                b = free.pop(0)
                slots[b] = a.ready
                token_buf[b] = a.first_tok
            adm = keep

        def chunk_stage() -> bool:
            """One bucketed chunk call over the rows still prefilling
            (parked rows hold no lane state here, so the call's width
            covers only pending rows). Returns True when a request finished
            outright on its first token (its lane row and pages freed)."""
            nonlocal adm
            pending = [a for a in adm if a.ready is None]
            W = 1
            while W < len(pending):
                W *= 2
            for i, a in enumerate(pending):
                a.row = i
            C = self._chunk_bucket(min(len(a.req.prompt) - a.base
                                       for a in pending))
            toks = np.zeros((W, C), np.int32)
            lens = np.zeros(W, np.int64)
            base = np.zeros(W, np.int64)
            rows: list[list[int] | None] = [None] * W
            recs: list[_Admission | None] = [None] * W
            t_disp = time.perf_counter()
            for a in pending:
                n = min(C, len(a.req.prompt) - a.base)
                toks[a.row, :n] = a.req.prompt[a.base:a.base + n]
                lens[a.row] = n
                # cache positions sit past the admission prefix (vlm patch
                # rows fill [0, prefix) of the row's pages)
                base[a.row] = a.prefix + a.base
                rows[a.row] = a.pages
                recs[a.row] = a
                if a.t_start == 0.0:
                    a.t_start = t_disp
            extra_top, extra_kv = gather_extras(recs, W)
            state = {"kv": {**pool, "table": dev_table(rows, W), **extra_kv},
                     "index": torch.as_tensor(base, device=self.device),
                     **extra_top}
            with ops.launch_objective(self.tune_objective):
                logits, _ = self.model.prefill_chunk(
                    self.params, torch.as_tensor(toks, device=self.device),
                    torch.as_tensor(lens, device=self.device), state,
                    self.cfg)
            logits = self._logits(logits)
            now = time.perf_counter()
            est_j, est_s, est = self._chunk_cost(W, C)
            self._tick(est_s, est)
            self._stats["chunk_steps"] += 1
            self._stats["idle_energy_j"] += (W - len(pending)) * est_j / W
            keep: list[_Admission] = []
            freed = False
            for a in adm:
                if a.ready is not None:
                    keep.append(a)
                    continue
                a.base += int(lens[a.row])
                a.chunk_energy_j += est_j / W
                plen = len(a.req.prompt)
                if a.base < plen:
                    keep.append(a)
                    continue
                if not admit_family:
                    # prompt fully cached: publish its pages to the prefix
                    # registry (may snapshot a partial last page); admit
                    # families never do: their KV depends on the modality
                    # input, so token-prefix reuse would be unsound
                    apply_copies(alloc.register(
                        np.asarray(a.req.prompt, np.int32), a.pages, a.base))
                tok = int(self._sample(logits[a.row:a.row + 1], [a.rng])[0])
                srec = _Slot(req=a.req, tokens=[tok],
                             prefill_energy_j=a.chunk_energy_j,
                             t_start=a.t_start, t_first=now,
                             t_first_model=self.model_clock_s, rng=a.rng,
                             pages=a.pages, index=a.prefix + plen,
                             extra_top=a.extra_top, extra_kv=a.extra_kv)
                if (a.req.eos_id is not None and tok == a.req.eos_id) or (
                        self._budget(a.req) <= 1):
                    self._finish(srec, now, decode_energy_j, results)
                    alloc.release(a.pages)
                    freed = True
                    continue
                a.ready = srec
                a.first_tok = tok
                keep.append(a)
            adm = keep
            return freed

        def decode_step() -> None:
            """One lockstep decode step: page tables and per-slot cache
            positions rebuilt from host records; finished slots release
            their pages (a shared prefix page drops one reference and frees
            only with its last reader)."""
            if not any(s is not None for s in slots):
                return
            self._tick(decode_cost[1], decode_cost[2])
            extra_top, extra_kv = gather_extras(slots, B)
            state = {"kv": {**pool, "table": dev_table(
                         [s.pages if s else None for s in slots], B),
                         **extra_kv},
                     "index": torch.as_tensor(
                         [s.index if s else 0 for s in slots],
                         device=self.device),
                     **extra_top}
            with ops.launch_objective(self.tune_objective):
                logits, _ = self.model.decode_step(
                    self.params, torch.as_tensor(token_buf,
                                                 device=self.device),
                    state, self.cfg)
            cur = self._sample(self._logits(logits),
                               [s.rng if s is not None else None
                                for s in slots])
            now = time.perf_counter()
            n_active = sum(s is not None for s in slots)
            self._stats["decode_steps"] += 1
            self._stats["slot_steps"] += B
            self._stats["resident_slot_steps"] += n_active
            self._stats["idle_energy_j"] += (
                (B - n_active) * decode_energy_j / B)
            for b in range(B):
                slot = slots[b]
                if slot is None:
                    continue
                tok = int(cur[b])
                slot.tokens.append(tok)
                slot.steps += 1
                slot.index += 1
                token_buf[b] = tok
                req = slot.req
                if (req.eos_id is not None and tok == req.eos_id) or (
                        len(slot.tokens) >= self._budget(req)):
                    self._finish(slot, now, decode_energy_j, results)
                    alloc.release(slot.pages)
                    slots[b] = None
                    token_buf[b] = 0

        while self.queue or adm or any(s is not None for s in slots):
            splice_ready()
            while True:
                admit_from_queue()
                if not any(a.ready is None for a in adm):
                    break
                freed = chunk_stage()
                if not (freed and self.queue):
                    break
            splice_ready()
            decode_step()
        self._stats["wall_s"] += time.perf_counter() - t_run0
        return results

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the cumulative counters behind `report()` — e.g. after a
        warm-up pass, so throughput leaves out the first calls' costs."""
        for k, v in self._stats.items():
            self._stats[k] = type(v)(0)

    def report(self) -> dict:
        """Engine-level serving report: counts, occupancy, host-clock
        throughput, the energy model's clock and joules, and on the paged
        layout the allocator's counters (``"paging"``).

        `energy_j` / `j_per_token` count *total* modelled spend — the
        per-request attributed energy plus the idle share of decode steps
        run with dead slots and of chunk-call pad rows."""
        s = self._stats
        toks = s["generated_tokens"]
        total_j = s["energy_j"] + s["idle_energy_j"]
        paging = ({"paging": self._allocator.report()}
                  if self._allocator is not None else {})
        return {
            **paging,
            "tp": self._tp,
            "model_s": s["model_s"],
            "model_tokens_per_s": (toks / s["model_s"]
                                   if s["model_s"] > 0 else 0.0),
            # the energy model's collective wire time and the share of it
            # hidden behind the GEMMs (zero at tp=1)
            "collective_wire_s": s["wire_s"],
            "overlap_factor": (s["hidden_wire_s"] / s["wire_s"]
                               if s["wire_s"] > 0 else 0.0),
            "requests": s["requests"],
            "generated_tokens": toks,
            "decode_steps": s["decode_steps"],
            "chunk_steps": s["chunk_steps"],
            "slot_steps": s["slot_steps"],
            "resident_slot_steps": s["resident_slot_steps"],
            "slot_occupancy": (s["resident_slot_steps"] / s["slot_steps"]
                               if s["slot_steps"] else 0.0),
            "lane_rebuilds": s["lane_rebuilds"],
            "admit_calls": s["admit_calls"],
            "wall_s": s["wall_s"],
            "tokens_per_s": toks / s["wall_s"] if s["wall_s"] > 0 else 0.0,
            "energy_j": total_j,
            "attributed_energy_j": s["energy_j"],
            "idle_energy_j": s["idle_energy_j"],
            "j_per_token": total_j / toks if toks else 0.0,
            # fault recovery: replayed work charged to this engine as the
            # failed attempt, rows adopted from failed members, and whether
            # tuning fell back to `autotuner.baseline_configs`
            "lost_energy_j": s["lost_energy_j"],
            "adopted_in": s["adopted_in"],
            "tuning_degraded": self.tuning_degraded,
            "tuning_degraded_reason": self._degraded_reason,
        }
