"""Continuous-batching serving engine with chunked admission prefill.

The counterpart of the JAX package's `repro.serving.engine.ServingEngine`
in continuous mode with ``admission="chunked"``, the dense KV layout, tp=1
and the dense family. The engine keeps one batched decode state of
``max_batch`` fixed slots. Every engine step runs one bucketed chunk call
over the *admission lane* — a compact pow2-width batch of the in-flight
admissions, up to ``2 * max_batch`` rows — and then one lockstep decode
step over the resident slots, so a long prompt never stops the world. A
finished admission samples its first token when its last chunk lands,
parks in the lane, and is spliced into a free decode slot (FIFO).

Streams match the JAX engine's token for token: the same admission order,
chunk buckets, splice order and host numpy sampler with per-(seed, uid)
Gumbel streams. `pretune` tunes the engine's GEMM fleet with the paper's
autotuner, as the JAX engine's does.

Energy and the model clock follow the JAX engine: every chunk call and
decode step is priced by the analytical GEMM fleet model
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

Paged KV, serial and wave admission, adoption and replay, `chunk_policy`
and tp are not ported yet (ROADMAP queue A); nothing here reports a
placeholder for them.

Where the JAX engine donates the decode state to its jitted calls, this
engine updates the KV tensors in place.
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


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a budget, an optional EOS id."""

    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    submit_s: float = 0.0       # stamped by ServingEngine.submit
    submit_model_s: float = 0.0  # engine model-clock at submission


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


class _LiveState:
    """The stepper's state across yields: slot table, decode state, lane."""

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
    """Continuous-batching engine with chunked admission (see the module
    docstring). `model` is the family's `ModelApi`, `params` its weights
    (a `TransformerLM` on `device`)."""

    def __init__(self, model, params, cfg: ModelConfig, *,
                 max_batch: int = 8, max_len: int = 512,
                 greedy: bool = True, seed: int = 0,
                 chunk_tokens: int = 64,
                 pretune: bool = False, tune_objective: str = "runtime",
                 tune_rank_mode: str = "auto",
                 chip: str | None = None,
                 device: str | torch.device = "cuda"):
        """`chunk_tokens` caps one chunk call's tokens per row; it must be
        a multiple of `ops.SSM_SERVE_GRAIN` or at least `max_len`, as in
        the JAX engine. `device` holds the decode state and must be where
        `params` live.

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
        if cfg.kind != "dense":
            raise NotImplementedError(
                f"the port serves kind='dense' only, not {cfg.kind!r}")
        if chunk_tokens < max_len and chunk_tokens % ops.SSM_SERVE_GRAIN:
            raise ValueError(
                f"chunk_tokens={chunk_tokens} must be a multiple of "
                f"{ops.SSM_SERVE_GRAIN} (or >= max_len)")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.greedy = greedy
        self.seed = seed
        self.chunk_tokens = chunk_tokens
        # admission-lane capacity: prefill and first-token sampling for up
        # to this many in-flight requests, decoupled from free slots
        self.lane_width = 2 * max_batch
        if chip is not None:
            # validate eagerly: a chip typo must raise here
            from repro_torch.core.chips import get_chip

            chip = get_chip(chip).name
        self.chip = chip
        self.tune_objective = tune_objective
        self.pretuned: dict[tuple, object] = {}
        if pretune:
            fleet = ops.serving_gemm_fleet(
                cfg, max_batch=max_batch, max_len=max_len,
                chunk_tokens=chunk_tokens, lane_width=self.lane_width)
            self.pretuned = ops.warm_gemm_cache(
                fleet, dtype=cfg.activation_dtype,
                objective=tune_objective, chip=chip,
                rank_mode=tune_rank_mode)
        self.queue: deque[Request] = deque()
        self._stepper = None
        self._step_energy_cache: dict[tuple, object] = {}
        self._state_axes = L.state_batch_axes(
            model.init_state(cfg, 1, max_len, device="meta"),
            model.init_state(cfg, 2, max_len, device="meta"))
        self._stats = {
            "decode_steps": 0, "chunk_steps": 0,
            "resident_slot_steps": 0, "slot_steps": 0,
            "generated_tokens": 0, "requests": 0, "wall_s": 0.0,
            "lane_rebuilds": 0, "energy_j": 0.0, "idle_energy_j": 0.0,
            # the model clock: predicted seconds of dispatched engine calls
            # (the energy model's step_s), advanced per chunk call and
            # decode step
            "model_s": 0.0,
        }

    # ------------------------------------------------------------------
    # model clock
    # ------------------------------------------------------------------
    def _tick(self, step_s: float) -> None:
        """Advance the model clock by one dispatched call's predicted
        time."""
        self._stats["model_s"] += step_s

    @property
    def model_clock_s(self) -> float:
        """Current model-clock reading: predicted seconds of every call
        this engine has dispatched, monotone across runs."""
        return self._stats["model_s"]

    @property
    def chip_spec(self):
        """The `ChipSpec` this engine prices energy on: `chip`, else the
        card the port runs on (`ops._CHIP`)."""
        from repro_torch.core.chips import get_chip

        return get_chip(self.chip or ops._CHIP)

    @property
    def idle_power_w(self) -> float:
        """The priced chip's idle-floor power (`ChipSpec.idle_power_w`;
        one chip, tp = 1)."""
        return self.chip_spec.idle_power_w

    # ------------------------------------------------------------------
    # queue
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        """True while requests are queued or in flight. May stay True for
        one extra `serve_step()` after the last retirement."""
        return bool(self.queue) or self._stepper is not None

    def submit(self, req: Request) -> None:
        """Queue a request (stamps its submit time). The prompt must leave
        at least one decode position in a row's `max_len` cache."""
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit "
                f"max_len={self.max_len} (need >= 1 decode position)")
        if req.submit_s == 0.0:
            req.submit_s = time.perf_counter()
        req.submit_model_s = self.model_clock_s
        self.queue.append(req)

    def _budget(self, req: Request) -> int:
        """Effective token budget: >= 1, bounded by the row's remaining
        cache room (max_len minus its own prompt length)."""
        return max(1, min(req.max_new_tokens, self.max_len - len(req.prompt)))

    def _chunk_bucket(self, n: int) -> int:
        """Smallest chunk bucket holding `n` remaining prompt tokens,
        capped at `chunk_tokens`."""
        buckets = ops.chunk_buckets(self.max_len, self.chunk_tokens)
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
        each row's cached keys and values once (the dense layout)."""
        from repro_torch.models.config import kv_cache_bytes

        return float(kv_cache_bytes(self.cfg, batch_rows * self.max_len))

    def _step_energy(self, key, n_rows: int, head_rows: int | None = None,
                     batch_rows: int | None = None):
        """Predicted `StepEnergyEstimate` for a step over `n_rows` GEMM
        rows (decode: max_batch; chunk: padded token count, with the LM
        head sized to the rows actually unembedded), with the KV reads of
        `batch_rows` rows as extra HBM bytes, cached per key. Raises when
        the energy model fails."""
        hit = self._step_energy_cache.get(key)
        if hit is not None:
            return hit
        from repro_torch.core.energy import gemm_fleet_energy
        from repro_torch.models.config import gemm_shape_counts

        est = gemm_fleet_energy(
            gemm_shape_counts(self.cfg, n_rows, head_tokens=head_rows),
            chip=self.chip_spec, dtype=self.cfg.activation_dtype,
            configs=self.pretuned or None,
            extra_hbm_bytes=self._kv_gather_bytes(batch_rows or 0),
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

    def _chunk_cost(self, width: int, chunk: int
                    ) -> tuple[float, float, object]:
        """(energy_j, step_s, est) of one admission chunk call: `width`
        lane rows of `chunk` tokens, LM head over last-valid positions."""
        return self._cost(self._step_energy(
            ("chunk", int(width), int(chunk)),
            int(width * chunk), int(width), batch_rows=int(width)))

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
        from repro_torch.models.config import gemm_shape_counts

        decode = gemm_shape_counts(self.cfg, self.max_batch)
        ch = gemm_shape_counts(self.cfg, width * chunk, head_tokens=width)
        est = fused_step_energy(
            decode, ch, chip=self.chip_spec,
            dtype=self.cfg.activation_dtype,
            configs=self.pretuned or None,
            extra_hbm_bytes=(self._kv_gather_bytes(self.max_batch)
                             + self._kv_gather_bytes(width)),
            name=f"{self.cfg.name}:fused:{width}x{chunk}")
        self._step_energy_cache[key] = est
        return est

    # ------------------------------------------------------------------
    # device calls
    # ------------------------------------------------------------------
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
        decode_energy_j, decode_step_s, _ = decode_cost
        B = self.max_batch
        active = np.array([s is not None for s in slots])
        if not active.any():
            return batch_state
        self._tick(decode_step_s)
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
    # the serving loop
    # ------------------------------------------------------------------
    def run_until_empty(self) -> list[Result]:
        """Serve every queued request to completion."""
        out: list[Result] = []
        while self.has_work:
            out.extend(self.serve_step())
        return out

    def serve_step(self) -> list[Result]:
        """Advance serving by one engine step — admit from the queue, one
        bucketed chunk call over the admission lane, one lockstep decode
        step over the residents — and return the requests that finished
        during it. Returns ``[]`` on the final call that observes the
        drained loop; poll `has_work` to drive to exhaustion."""
        if self._stepper is None:
            if not self.queue:
                return []
            self._stepper = self._chunked_stepper()
        try:
            return next(self._stepper)
        except StopIteration:
            self._stepper = None
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
        lv = _LiveState(B)
        decode_cost = self._decode_cost()
        decode_energy_j = decode_cost[0]

        def zero_lane_row(r: int) -> None:
            if lv.zero_src is None:
                lv.zero_src = self._init_state(1)
            self._splice(lv.adm_state, lv.zero_src, 0, r)

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
            for a in lv.adm:
                if a.row < 0:
                    a.row = lv.lane_free.pop(0)
                    if a.row in lv.lane_dirty:
                        lv.lane_dirty.discard(a.row)
                        zero_lane_row(a.row)
            pending = [a for a in lv.adm if a.ready is None]
            # shortest-remainder-first bucket: short admissions finish in
            # cheap narrow calls; long prompts still progress min(C, rem)
            # tokens per step
            C = self._chunk_bucket(min(len(a.req.prompt) - a.base
                                       for a in pending))
            toks = np.zeros((W, C), np.int32)
            lens = np.zeros(W, np.int64)
            t_disp = time.perf_counter()
            for a in pending:
                n = min(C, len(a.req.prompt) - a.base)
                toks[a.row, :n] = a.req.prompt[a.base:a.base + n]
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
            est_j, est_s, _ = self._chunk_cost(W, C)
            self._tick(est_s)
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
                if a.base < len(a.req.prompt):
                    keep.append(a)
                    continue
                tok = int(self._sample(logits[a.row:a.row + 1], [a.rng])[0])
                srec = _Slot(req=a.req, tokens=[tok],
                             prefill_energy_j=a.chunk_energy_j,
                             t_start=a.t_start, t_first=now,
                             t_first_model=self.model_clock_s, rng=a.rng)
                # EOS or a budget of one on the first token: finished
                # before occupying a decode slot
                if (a.req.eos_id is not None and tok == a.req.eos_id) or (
                        1 >= self._budget(a.req)):
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
        while self.queue or lv.adm or any(s is not None for s in lv.slots):
            t_it0 = time.perf_counter()
            # admit + chunk: fill free lane rows from the queue and run one
            # chunk call; a request finishing on its first token frees its
            # row again, so keep admitting while the queue has work
            splice_ready()
            while True:
                while self.queue and len(lv.adm) < self.lane_width:
                    req = self.queue.popleft()
                    rng = None if self.greedy else self._req_rng(req.uid)
                    lv.adm.append(_Admission(req=req, rng=rng))
                if not any(a.ready is None for a in lv.adm):
                    break
                freed = chunk_stage()
                if not (freed and self.queue):
                    break
            splice_ready()
            # one lockstep decode step over the residents
            lv.batch_state = self._decode_step(
                lv.slots, lv.batch_state, lv.token_buf, decode_cost,
                results)
            self._stats["wall_s"] += time.perf_counter() - t_it0
            new, emitted = results[emitted:], len(results)
            yield new

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def report(self) -> dict:
        """Engine-level serving report: counts, occupancy, host-clock
        throughput, and the energy model's clock and joules.

        `energy_j` / `j_per_token` count *total* modelled spend — the
        per-request attributed energy plus the idle share of decode steps
        run with dead slots and of chunk-call pad rows."""
        s = self._stats
        toks = s["generated_tokens"]
        total_j = s["energy_j"] + s["idle_energy_j"]
        return {
            "model_s": s["model_s"],
            "model_tokens_per_s": (toks / s["model_s"]
                                   if s["model_s"] > 0 else 0.0),
            "requests": s["requests"],
            "generated_tokens": toks,
            "decode_steps": s["decode_steps"],
            "chunk_steps": s["chunk_steps"],
            "slot_steps": s["slot_steps"],
            "resident_slot_steps": s["resident_slot_steps"],
            "slot_occupancy": (s["resident_slot_steps"] / s["slot_steps"]
                               if s["slot_steps"] else 0.0),
            "lane_rebuilds": s["lane_rebuilds"],
            "wall_s": s["wall_s"],
            "tokens_per_s": toks / s["wall_s"] if s["wall_s"] > 0 else 0.0,
            "energy_j": total_j,
            "attributed_energy_j": s["energy_j"],
            "idle_energy_j": s["idle_energy_j"],
            "j_per_token": total_j / toks if toks else 0.0,
        }
