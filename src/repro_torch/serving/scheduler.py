"""Predictor-driven SLA- and energy-aware fleet scheduler.

`FleetScheduler` owns one admission queue over N `ServingEngine`
instances — possibly on different `ChipSpec`s and tp widths — and makes
three predictor-priced decisions per tick, closing the loop the paper's
predictor exists for (price a GEMM configuration *before* running it):

1. **Routing** (`_route`): each pending request is priced on every
   active (engine, chunk-bucket) placement via the engine's cached
   `fused_step_estimate` (which runs `core.energy.fused_step_energy`
   over the decode + chunk GEMM fleets and `hwsim.collective_cost` over
   the ring traffic) folded into a per-request share by
   `core.energy.marginal_request_cost` — the same per-row/per-slot
   arithmetic the engine's attribution ledger uses. The scheduler picks
   the placement with the lowest predicted marginal fleet J/token among
   those whose predicted TTFT meets the request's SLA-class deadline,
   falling back to the fastest placement when none does.

2. **Chunk sizing** (`_chunk_policy_for`): each engine's SJF chunk
   sizing is replaced by a deadline-aware policy when SLO-classed
   requests are in its lane — the smallest chunk bucket predicted to
   land every pending deadline wins (small buckets waste no padded
   positions and interleave more decode; wide buckets cut calls when
   slack runs short). A draining engine always chunks at the widest
   bucket.

3. **Race to idle** (`_race_to_idle`): the ledger charges every fleet
   member its `ChipSpec` idle floor for the whole fleet makespan
   (`core.energy.parked_energy_j`), so shrinking the makespan — or
   finishing a lagging, expensive engine's work early and parking it —
   saves real energy. When the remaining fleet's predicted completion
   of all outstanding prefill work still meets every outstanding SLO
   deadline, the most expensive active engine is marked *draining*
   (no new routes, widest chunks) and parks at idle power once empty.

**Fault tolerance** (`serving/faults.py`, `docs/serving.md` "Failure
model & recovery"): a seeded `FaultPlan` injects crashes, stalls,
page-pool pressure, and predictor-artifact corruption on the same fleet
model clock the scheduler orders steps by, so chaos runs replay exactly.
A crashed (or straggler-evicted) member's in-flight requests are
checkpointed (`ServingEngine.checkpoint_inflight`) and either *migrated*
— their decode-state rows spliced into a `state_compatible` survivor for
a bit-identical continuation — or *replayed*: requeued with the tokens
already emitted as a forced prefix (`Request.replay`), so client-visible
streams stay append-only and every request finishes exactly once.
Replays pay capped exponential backoff (`faults.retry_backoff_s`) and
re-enter routing through the normal marginal-J/token pricing; the failed
attempt's unusable spend is charged back to the failed member
(`charge_lost_energy`) so fleet ledgers still sum. Stalls are not read
off the plan: detection reuses `train.ft.StragglerDetector` EWMAs over
each member's observed-vs-predicted step-time ratio, and eviction
follows the detector's flag. Overload admission control is per SLA
class (`SLAClass.policy`): `accept` places least-late, `defer` rotates
the request with capped backoff, `shed` records a terminal disposition;
the `admission_watermark_tokens` backlog watermark and predicted-TTFT
infeasibility both trigger it.

Fleet accounting: ``fleet_energy_j`` = every engine's served energy
(attributed + in-call idle shares) **plus** each engine's idle-floor
energy over the gap between its own busy time and the fleet makespan
(a crashed member's horizon truncates at the crash instant — dead chips
burn nothing). A single-engine baseline is the same ledger with all
work forced onto one member (``route_to=``) while the others sit parked
for its whole makespan — so the scheduler beats the best such baseline
by routing to efficient chips *and* by shrinking the makespan
(parallelism cuts the idle-floor term). `chip_smoke.py` phase 14 serves
the JAX package's fleet mix through it on the card and prints both
numbers; `tests/test_torch_fleet.py` holds it to the JAX package's
scheduler and holds the conservation and routing-invariance properties,
`tests/test_torch_faults.py` the recovery ones.

The port's scheduler is the JAX package's, over the port's engines (any
family the engine serves chunked on the dense layout, at tp = 1). It
differs in three places. Two come from the engine: an engine built without
``chip`` prices on, and is charged the idle floor of, the card the port
runs on (`ops._CHIP`, "h100"), not the TPU v5e; and `pretune` makes each
member launch `tune_objective`'s winners (`ops.launch_objective`), so it
runs the tiles it prices. The third is a fix: a deferred-only backlog
fast-forwards the fleet clock to the earliest wake-up exactly, where the
reference's clock sum can round short of it and livelock (ROADMAP queue
C). Members share one params object to migrate rows between them
(`ServingEngine.state_compatible`), so a fleet of N engines on one card
holds its weights once.

Time base: each engine advances its own deterministic model clock
(predicted seconds of dispatched calls). The scheduler aligns them into
one fleet timeline by always stepping the busiest-backlogged engine
with the *smallest* elapsed clock and fast-forwarding an idle engine's
clock to "now" at handoff — so TTFT measured against the fleet timeline
(`ttft_fleet_model_s`) includes scheduler queue wait and is
deterministic and hardware-independent, like the engine's own model
clock.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

from repro_torch.serving.engine import Request, Result, ServingEngine
from repro_torch.serving.faults import FaultPlan, retry_backoff_s
from repro_torch.train.ft import StragglerConfig, StragglerDetector

_POLICIES = ("accept", "defer", "shed")


@dataclasses.dataclass(frozen=True)
class SLAClass:
    """A named TTFT service class.

    `ttft_model_s` is the per-request time-to-first-token bound on the
    fleet model clock (submit -> first token, queue wait included);
    None declares a best-effort class with no deadline. The bench's
    attainment gate reads the fraction of a class's requests that met
    the bound.

    `policy` is the class's overload admission policy, applied when no
    placement is predicted to meet the deadline or the fleet backlog
    crosses the scheduler's admission watermark: ``accept`` places on
    the least-late engine anyway, ``defer`` pushes the request back
    with capped exponential backoff (`defer_s` base, at most
    `max_defers` times, then accepts late rather than starving it),
    ``shed`` rejects it with a terminal disposition in the request
    log."""

    name: str
    ttft_model_s: float | None = None
    policy: str = "accept"
    defer_s: float = 0.05
    max_defers: int = 4

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r} "
                             f"(expected one of {_POLICIES})")
        if self.defer_s <= 0.0:
            raise ValueError("defer_s must be positive")


@dataclasses.dataclass
class _ReqMeta:
    """Scheduler-side bookkeeping for one in-flight request."""

    sla: str | None
    t_submit: float             # fleet clock at scheduler submission
    t_handoff: float = 0.0      # fleet clock at engine handoff
    engine: str | None = None   # member the request was routed to
    bucket: int = 0             # chunk bucket chosen at routing time
    pred_j_per_token: float = 0.0
    pred_ttft_s: float = 0.0
    not_before: float = 0.0     # earliest fleet clock routing may place
    defers: int = 0             # admission-control deferrals so far
    retries: int = 0            # replay attempts after member failures
    migrations: int = 0         # state-row migrations between members
    ttft_override: float | None = None  # pinned fleet TTFT (see below)
    # ttft_override: once a request's first token has streamed, its
    # fleet TTFT is a historical fact — a later migration or replay of
    # the tail must not rewrite it, so the value is pinned at failure
    # time and _finish prefers it over the finishing engine's measure.


@dataclasses.dataclass
class _Member:
    """One fleet engine plus the scheduler's view of it."""

    name: str
    engine: ServingEngine
    host_idx: int = 0           # row in the straggler detector
    clock0: float = 0.0         # engine clock at scheduler epoch
    routed: int = 0
    completed: int = 0
    parked: bool = False
    draining: bool = False
    parks: int = 0
    drains: int = 0
    parked_model_s: float = 0.0  # closed park intervals (fleet clock)
    parked_from: float = 0.0     # open park interval start
    crashed: bool = False        # permanent loss (fault plan)
    crashed_at: float = 0.0      # fleet clock at the crash
    crashes: int = 0
    evicted: bool = False        # straggler eviction (may rejoin)
    evictions: int = 0
    stall_until: float = 0.0     # open stall window end (fleet clock)
    stall_factor: float = 1.0    # active step-time dilation
    stalls: int = 0

    @property
    def alive(self) -> bool:
        """False for members routing/stepping must never touch: crashed
        permanently, or evicted until their stall window passes."""
        return not self.crashed and not self.evicted

    @property
    def elapsed(self) -> float:
        """Fleet-timeline position of this engine (clock - epoch)."""
        return self.engine.model_clock_s - self.clock0

    @property
    def has_room(self) -> bool:
        """True while the engine can absorb another admission without
        queueing past its lane (the scheduler's late-binding
        backpressure)."""
        eng = self.engine
        return (len(eng.queue) + eng.lane_view["in_flight"]
                < eng.lane_width)


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    w = 1
    while w < n:
        w *= 2
    return w


def _percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile of a list (0 for an empty one)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(int(math.ceil(q / 100.0 * len(xs))) - 1, len(xs) - 1)
    return xs[max(i, 0)]


def _prefill_len(req: Request) -> int:
    """Effective prefill length of a request: the prompt plus any
    forced replay prefix (all but the last replayed token prefills; the
    last one is re-emitted as the first decode token)."""
    extra = max(len(req.replay) - 1, 0) if req.replay else 0
    return len(req.prompt) + extra


class FleetScheduler:
    """One admission queue over a fleet of `ServingEngine`s (see the
    module docstring for the decision loop; `docs/serving.md` for the
    guide)."""

    def __init__(self, engines: dict[str, ServingEngine], *,
                 sla: dict[str, SLAClass] | None = None,
                 default_sla: str | None = None,
                 route_to: str | None = None,
                 race_to_idle: bool = True,
                 pretune: bool = False,
                 tune_objective: str = "energy",
                 tune_rank_mode: str = "auto",
                 fault_plan: FaultPlan | None = None,
                 straggler_cfg: StragglerConfig | None = None,
                 admission_watermark_tokens: int | None = None):
        """`engines` maps member names to steppable engines (continuous
        chunked admission on the dense KV layout — `serve_step`'s
        contract). `sla` maps class names to `SLAClass` bounds;
        `default_sla` is applied to requests submitted without one.

        `route_to` forces every request onto one named member while the
        others sit parked — the single-engine baseline the fleet bench
        compares against (same ledger, so the comparison is
        apples-to-apples). `race_to_idle=False` disables the
        drain-and-park decision (routing and chunk sizing stay on).

        `pretune=True` warms the whole fleet's GEMM shapes up front via
        `ops.warm_fleet_gemm_cache` — engines sharing a chip are
        unioned into one batched tuning pass, and each engine's
        `pretuned` map (which its energy pricing consults) is filled
        from its chip's results; a member then launches
        `tune_objective`'s winners where its chip's were installed (only
        the active chip's are).

        `fault_plan` is a seeded chaos schedule polled once per tick
        (`serving/faults.py`). `straggler_cfg` tunes the eviction
        detector (`train.ft.StragglerDetector` over observed/predicted
        step-time ratios — 1.0 is healthy, so detection is
        chip-independent). `admission_watermark_tokens` is the fleet
        prefill-backlog level above which SLA admission policies kick
        in even for placements predicted feasible."""
        if not engines:
            raise ValueError("FleetScheduler needs at least one engine")
        self.members: dict[str, _Member] = {}
        for idx, (name, eng) in enumerate(engines.items()):
            if (eng.mode == "wave" or eng.admission != "chunked"
                    or eng.kv_layout != "dense"
                    or not eng._continuous_supported()):
                raise ValueError(
                    f"engine {name!r} is not steppable (fleet scheduling "
                    f"requires continuous chunked admission on the dense "
                    f"KV layout)")
            self.members[name] = _Member(name=name, engine=eng,
                                         host_idx=idx,
                                         clock0=eng.model_clock_s)
            eng.chunk_policy = self._chunk_policy_for(name)
        self.sla = dict(sla or {})
        for cname, cls in self.sla.items():
            if cname != cls.name:
                raise ValueError(f"SLA key {cname!r} != class {cls.name!r}")
        if default_sla is not None and default_sla not in self.sla:
            raise ValueError(f"default_sla {default_sla!r} not in sla map")
        self.default_sla = default_sla
        if route_to is not None and route_to not in self.members:
            raise ValueError(f"route_to {route_to!r} not in fleet")
        self.route_to = route_to
        self.race_to_idle = race_to_idle
        self.admission_watermark_tokens = admission_watermark_tokens
        self._fault_plan = fault_plan
        self._straggler_cfg = straggler_cfg
        self._detector = StragglerDetector(len(self.members),
                                           straggler_cfg)
        self._pending: deque[Request] = deque()
        self._recovery: deque[dict] = deque()
        self._meta: dict[int, _ReqMeta] = {}
        self._done: dict[int, dict] = {}
        self.routed_to: dict[int, str] = {}
        self._counters = {"migrations": 0, "replays": 0, "retries": 0}
        self._shed_counts: dict[str, int] = {}
        self._defer_counts: dict[str, int] = {}
        if pretune:
            self._pretune_fleet(tune_objective, tune_rank_mode)

    # ------------------------------------------------------------------
    # fleet pre-tuning
    # ------------------------------------------------------------------
    def _pretune_fleet(self, objective: str, rank_mode: str) -> None:
        """Warm every member's GEMM fleet in one batched pass per chip
        (`ops.warm_fleet_gemm_cache`) and install the per-engine config
        maps, invalidating any step-energy estimates priced before."""
        from repro_torch.kernels import ops

        names = list(self.members)
        specs = []
        for name in names:
            e = self.members[name].engine
            specs.append({
                "cfg": e.cfg, "chip": e.chip,
                "dtype": e.cfg.activation_dtype,
                "max_batch": e.max_batch, "max_len": e.max_len,
                "include_slot_prefill": True,
                "chunk_tokens": e.chunk_tokens,
                "lane_width": e.lane_width,
                "grain": e.ssm_grain})
        tuned = ops.warm_fleet_gemm_cache(specs, objective=objective,
                                          rank_mode=rank_mode)
        for name, configs in zip(names, tuned):
            eng = self.members[name].engine
            if configs:
                eng.pretuned = configs
                eng.tune_objective = objective
                eng._step_energy_cache.clear()

    # ------------------------------------------------------------------
    # clocks
    # ------------------------------------------------------------------
    def fleet_now(self) -> float:
        """Current fleet-timeline position: the smallest elapsed clock
        among busy live members (the next engine to step), or the
        largest elapsed anywhere when the fleet is idle."""
        busy = [m.elapsed for m in self.members.values()
                if m.alive and m.engine.has_work and not m.parked]
        if busy:
            return min(busy)
        return max((m.elapsed for m in self.members.values()), default=0.0)

    def _sync_clock(self, m: _Member, now: float) -> None:
        """Fast-forward an idle-lagging member's clock to `now`: its
        model clock only advances while dispatching, so an engine that
        sat idle re-enters the fleet timeline at the present, not in
        the past (handoff wait must never read negative)."""
        gap = now - m.elapsed
        if gap > 0.0:
            m.engine._clock += gap

    # ------------------------------------------------------------------
    # fault plane
    # ------------------------------------------------------------------
    def arm_faults(self, plan: FaultPlan | None) -> None:
        """Install (or clear) the chaos plan. The chaos bench arms it
        *after* its warm-up pass + `reset_stats`, so the plan's model-
        clock event times land on the measured run's timeline."""
        self._fault_plan = plan

    def _poll_faults(self) -> None:
        """Apply due chaos events and close expired stall windows (an
        evicted member whose stall has passed rejoins with fresh
        detector history). Runs once at the top of every tick."""
        now = self.fleet_now()
        for m in self.members.values():
            if m.stall_factor > 1.0 and now >= m.stall_until:
                m.stall_factor = 1.0
            if (m.evicted and m.stall_factor == 1.0
                    and now >= m.stall_until):
                m.evicted = False
                self._detector.reset(m.host_idx)
        if self._fault_plan is None:
            return
        for ev in self._fault_plan.due(now):
            m = self.members.get(ev.member)
            if m is None or not m.alive:
                continue
            if ev.kind == "crash":
                self._fail_member(m, evict=False,
                                  state_lost=ev.state_lost)
            elif ev.kind == "stall":
                m.stall_factor = max(float(ev.factor), 1.0)
                m.stall_until = now + float(ev.duration_s)
                m.stalls += 1
            elif ev.kind == "artifact_corruption":
                from repro_torch.core.predictor import ArtifactError

                # retune degrades itself to untuned pricing on the
                # injected error; serving continues, report() flags it
                m.engine.retune(_inject=ArtifactError(
                    f"chaos: corrupt predictor artifact on {m.name}"))
            elif ev.kind == "page_pressure":
                # fleet members are dense (serve_step contract); the
                # event only bites engines running the paged layout
                if m.engine.kv_layout == "paged":
                    m.engine.inject_page_pressure(ev.pages)

    def _fail_member(self, m: _Member, *, evict: bool,
                     state_lost: bool = False) -> None:
        """Take a member out of service (crash: permanent; evict:
        until its stall window passes) and checkpoint its in-flight
        work into the recovery queue. Requests whose first token
        already streamed get their fleet TTFT pinned here — migration
        or replay of the tail must not rewrite history."""
        now = self.fleet_now()
        records = m.engine.checkpoint_inflight(state_lost=state_lost)
        for rec in records:
            rec["src"] = m.name
            uid = rec["req"].uid
            meta = self._meta.get(uid)
            if meta is not None:
                if (rec["tokens"] and rec["ttft_model_s"] is not None
                        and meta.ttft_override is None):
                    wait = max(meta.t_handoff - meta.t_submit, 0.0)
                    meta.ttft_override = rec["ttft_model_s"] + wait
                meta.engine = None
            self.routed_to.pop(uid, None)
        self._recovery.extend(records)
        if m.parked:
            self._unpark(m, now)
        if evict:
            m.evicted = True
            m.evictions += 1
        else:
            m.crashed = True
            m.crashed_at = now
            m.crashes += 1

    def _maybe_evict(self) -> None:
        """Evict any member the straggler detector flags, as long as a
        survivor exists to absorb its work (a lone member rides out its
        stall instead — slow beats dead)."""
        flagged = set(self._detector.update_flags())
        if not flagged:
            return
        by_host = {m.host_idx: m for m in self.members.values()}
        for h in sorted(flagged):
            m = by_host.get(h)
            if m is None or not m.alive:
                continue
            if not any(o.alive for o in self.members.values()
                       if o is not m):
                continue
            self._fail_member(m, evict=True)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, req: Request, sla: str | None = None) -> None:
        """Queue a request on the fleet. `sla` (or `req.sla`, or the
        scheduler default) names its `SLAClass`; None serves best
        effort. Routing happens lazily inside `run_until_empty` /
        `step`, so a request's placement sees the fleet state at
        admission time, not submission time."""
        cname = sla or req.sla or self.default_sla
        if cname is not None and cname not in self.sla:
            raise ValueError(f"unknown SLA class {cname!r}")
        req.sla = cname
        self._meta[req.uid] = _ReqMeta(sla=cname, t_submit=self.fleet_now())
        self._pending.append(req)

    def _deadline(self, meta: _ReqMeta) -> float | None:
        """Absolute fleet-clock TTFT deadline of a request (None when
        best-effort)."""
        if meta.sla is None:
            return None
        bound = self.sla[meta.sla].ttft_model_s
        return None if bound is None else meta.t_submit + bound

    # ------------------------------------------------------------------
    # decision (a): predictor-priced routing
    # ------------------------------------------------------------------
    def _place_cost(self, m: _Member, req: Request, bucket: int,
                    now: float) -> tuple[float, float]:
        """(predicted marginal J/token, predicted fleet TTFT seconds) of
        placing `req` on member `m` with chunk bucket `bucket`.

        The chunk side prices the *fused* step the engine will actually
        dispatch (decode fleet + one `width x bucket` chunk call) at the
        width the lane would grow to; the per-request share and the
        decode-step share come from `core.energy.marginal_request_cost`.
        TTFT is first-order: the engine's unfinished prefill backlog
        plus this prompt's own chunk calls (replay prefixes included),
        at the fused step cadence, starting from the later of `now` and
        the engine's own clock."""
        eng = m.engine
        view = eng.lane_view
        width = _pow2ceil(min(view["in_flight"] + 1, eng.lane_width))
        fused = eng.fused_step_estimate(width, bucket)
        n_calls = max(int(math.ceil(_prefill_len(req) / bucket)), 1)
        budget = eng._budget(req)
        cost = _marginal(fused, eng.decode_step_estimate(),
                         chunk_calls=n_calls, chunk_width=width,
                         decode_steps=budget, decode_batch=eng.max_batch,
                         tokens=budget)
        step_s = fused.step_s if fused is not None else 0.0
        backlog_calls = eng.backlog_tokens / max(width * bucket, 1)
        start = max(m.elapsed, now)
        ttft = (start - now) + (n_calls + backlog_calls) * step_s
        return cost.j_per_token, ttft

    def _buckets(self, eng: ServingEngine) -> tuple[int, ...]:
        """The engine's chunk-bucket ladder (`ops.chunk_buckets`)."""
        from repro_torch.kernels import ops

        return ops.chunk_buckets(eng.max_len, eng.chunk_tokens,
                                 eng.ssm_grain)

    def _candidates(self, include_parked: bool) -> list[_Member]:
        """Members routing may currently target, cheapest-first order
        left to the cost search."""
        return [m for m in self.members.values()
                if m.alive and (include_parked or not m.parked)
                and not m.draining and m.has_room]

    def _overloaded(self) -> bool:
        """True when the fleet's live prefill backlog has crossed the
        admission watermark — SLA policies then gate even placements
        predicted feasible."""
        wm = self.admission_watermark_tokens
        if wm is None:
            return False
        backlog = sum(m.engine.backlog_tokens
                      for m in self.members.values() if m.alive)
        return backlog >= wm

    def _route(self) -> None:
        """Place recovery records, then pending requests FIFO onto
        (engine, chunk-bucket) placements: lowest predicted marginal
        fleet J/token among the SLO-feasible candidates. Requests in a
        backoff window rotate past; requests nothing can absorb stop
        the scan so FIFO fairness holds within the queue; infeasible or
        overloaded admissions go through their SLA class's policy."""
        self._route_recovery()
        hold: list[Request] = []
        while self._pending:
            req = self._pending.popleft()
            meta = self._meta[req.uid]
            now = self.fleet_now()
            if meta.not_before > now:
                hold.append(req)
                continue
            verdict = self._place(req, meta, now)
            if verdict == "wait":
                hold.append(req)
                break              # every lane full: the rest waits too
            if verdict == "deferred":
                hold.append(req)
        self._pending.extendleft(reversed(hold))

    def _place(self, req: Request, meta: _ReqMeta, now: float) -> str:
        """Try to hand one request off. Returns ``placed``, ``wait``
        (no candidate has room), ``deferred`` (admission control pushed
        it back with backoff) or ``shed`` (terminal disposition)."""
        if self.route_to is not None:
            target = self.members[self.route_to]
            bucket = self._buckets(target.engine)[-1]
            meta.pred_j_per_token, meta.pred_ttft_s = self._place_cost(
                target, req, bucket, now)
            self._handoff(target, req, meta, bucket)
            return "placed"
        deadline = self._deadline(meta)
        slack = (None if deadline is None
                 else max(deadline - now, 0.0))
        pick = None
        feasible_found = False
        for widen in (False, True):
            scored = [
                (m, b, *self._place_cost(m, req, b, now))
                for m in self._candidates(include_parked=widen)
                for b in self._buckets(m.engine)]
            if not scored:
                continue
            feasible = [c for c in scored
                        if slack is None or c[3] <= slack]
            if feasible:
                # cheapest predicted marginal J/token among the
                # placements that make the deadline
                pick = min(feasible, key=lambda c: (c[2], c[3]))
                feasible_found = True
                break
            if widen:
                # nothing makes the deadline even woken: the least-late
                # placement (admission control may still intervene)
                pick = min(scored, key=lambda c: (c[3], c[2]))
        if pick is None:
            return "wait"
        if not feasible_found or self._overloaded():
            verdict = self._admission_control(req, meta, now)
            if verdict is not None:
                return verdict
        target, bucket = pick[0], pick[1]
        meta.pred_j_per_token, meta.pred_ttft_s = pick[2], pick[3]
        self._handoff(target, req, meta, bucket)
        return "placed"

    def _admission_control(self, req: Request, meta: _ReqMeta,
                           now: float) -> str | None:
        """Apply the request's SLA-class overload policy; None means
        accept (place on the pick anyway)."""
        cls = self.sla.get(meta.sla) if meta.sla is not None else None
        if cls is None or cls.policy == "accept":
            return None
        if cls.policy == "shed":
            self._shed_request(req, meta, now)
            return "shed"
        if meta.defers >= cls.max_defers:
            return None            # cap hit: accept late, don't starve
        meta.defers += 1
        self._defer_counts[meta.sla] = (
            self._defer_counts.get(meta.sla, 0) + 1)
        meta.not_before = now + retry_backoff_s(meta.defers,
                                                base_s=cls.defer_s)
        return "deferred"

    def _shed_request(self, req: Request, meta: _ReqMeta, now: float,
                      *, status: str = "shed") -> None:
        """Record a terminal non-served disposition (admission shed, or
        work lost with the whole fleet) so every submitted request has
        exactly one entry in the request log."""
        self._meta.pop(req.uid, None)
        self.routed_to.pop(req.uid, None)
        key = meta.sla if meta.sla is not None else "_best_effort"
        self._shed_counts[key] = self._shed_counts.get(key, 0) + 1
        self._done[req.uid] = {
            "engine": None, "sla": meta.sla, "status": status,
            "ttft_fleet_model_s": None,
            "queue_wait_model_s": max(now - meta.t_submit, 0.0),
            "met_slo": False,
            "pred_j_per_token": meta.pred_j_per_token,
            "pred_ttft_model_s": meta.pred_ttft_s,
            "bucket": meta.bucket,
            "energy_j": 0.0, "n_tokens": 0,
            "retries": meta.retries, "migrations": meta.migrations,
        }

    def _route_recovery(self) -> None:
        """Place work checkpointed off failed members. A record with a
        surviving decode-state row *migrates*: the row is adopted by the
        cheapest state-compatible member with lane room (bit-identical
        continuation — same tokens as the no-fault run). Otherwise it
        *replays*: the request is requeued with its emitted tokens as a
        forced prefix (`Request.replay`, streams stay append-only)
        after capped exponential backoff, and the failed attempt's
        unusable spend is charged back to the source member so fleet
        ledgers still sum. Records whose compatible members are merely
        full wait for the next tick rather than degrade to replay."""
        if not self._recovery:
            return
        requeue: list[Request] = []
        keep: deque[dict] = deque()
        while self._recovery:
            rec = self._recovery.popleft()
            req = rec["req"]
            meta = self._meta.get(req.uid)
            if meta is None:
                continue           # already terminal
            now = self.fleet_now()
            src = self.members.get(rec.get("src", ""))
            if rec.get("state") is not None and src is not None:
                compat = [m for m in self.members.values()
                          if m.alive and m is not src
                          and m.engine.state_compatible(src.engine)]
                if compat:
                    roomy = [m for m in compat
                             if not m.draining and m.has_room]
                    if not roomy:
                        keep.append(rec)
                        continue
                    dst = min(roomy, key=self._decode_j_per_token)
                    if dst.parked:
                        self._unpark(dst, now)
                    self._sync_clock(dst, now)
                    dst.engine.adopt(rec)
                    meta.engine = dst.name
                    meta.migrations += 1
                    self.routed_to[req.uid] = dst.name
                    dst.routed += 1
                    self._counters["migrations"] += 1
                    continue
            # replay: the failed attempt's spend has no surviving owner
            # (engine_j and lost_j overlap by construction — the larger
            # of the two is the attempt's total unusable spend)
            meta.retries += 1
            self._counters["replays"] += 1
            self._counters["retries"] += 1
            meta.not_before = now + retry_backoff_s(meta.retries)
            req.replay = [int(t) for t in rec["tokens"]] or None
            lost = max(float(rec.get("energy_j", 0.0)),
                       float(rec.get("lost_energy_j", 0.0)))
            if src is not None and lost > 0.0:
                src.engine.charge_lost_energy(lost)
            requeue.append(req)
        self._recovery = keep
        self._pending.extendleft(reversed(requeue))

    def _handoff(self, m: _Member, req: Request, meta: _ReqMeta,
                 bucket: int) -> None:
        """Commit a routing decision: wake a parked member, align its
        clock with the fleet timeline, and enqueue the request on the
        engine."""
        now = self.fleet_now()
        if m.parked:
            self._unpark(m, now)
        self._sync_clock(m, now)
        meta.engine = m.name
        meta.bucket = int(bucket)
        meta.t_handoff = m.elapsed
        self.routed_to[req.uid] = m.name
        m.routed += 1
        m.engine.submit(req)

    # ------------------------------------------------------------------
    # decision (b): SLO-aware chunk sizing
    # ------------------------------------------------------------------
    def _chunk_policy_for(self, name: str):
        """Build the `ServingEngine.chunk_policy` hook for one member.

        Draining members chunk at the widest bucket (finish prefill in
        the fewest steps and get to idle). Otherwise, when any pending
        lane row carries an SLO deadline, pick the smallest chunk
        bucket whose predicted cadence lands *every* pending deadline —
        small buckets waste no padded positions (J/token) and
        interleave more decode steps; slack that has burned down forces
        wider chunks. Lanes holding only best-effort rows return None,
        keeping the engine's SJF default."""
        def policy(eng: ServingEngine,
                   pending: list[tuple[Request, int]]) -> int | None:
            """Chunk-bucket override for this member's pending lane
            (None keeps the engine's SJF default)."""
            m = self.members[name]
            ladder = self._buckets(eng)
            if m.draining:
                return ladder[-1]
            now = m.elapsed
            deadlines = []
            for req, rem in pending:
                meta = self._meta.get(req.uid)
                if meta is None:
                    continue
                dl = self._deadline(meta)
                if dl is not None:
                    deadlines.append((dl, rem))
            if not deadlines:
                return None
            width = _pow2ceil(len(pending))
            for bucket in ladder:
                est = eng.fused_step_estimate(width, bucket)
                step_s = est.step_s if est is not None else 0.0
                if all(now + math.ceil(rem / bucket) * step_s <= dl
                       for dl, rem in deadlines):
                    return bucket
            return ladder[-1]
        return policy

    # ------------------------------------------------------------------
    # decision (c): race to idle
    # ------------------------------------------------------------------
    def _decode_j_per_token(self, m: _Member) -> float:
        """Marginal decode J/token of a member (its full-batch decode
        step's energy split per slot) — the expense ranking the drain
        decision uses."""
        est = m.engine.decode_step_estimate()
        if est is None:
            return 0.0
        return est.energy_j / max(m.engine.max_batch, 1)

    def _outstanding_deadlines(self) -> list[tuple[float, float]]:
        """(deadline, remaining prefill tokens) of every request that
        has not yet produced its first token, fleet-wide — the load the
        remaining fleet must absorb for a drain/park to be safe."""
        out = []
        for req in self._pending:
            meta = self._meta[req.uid]
            dl = self._deadline(meta)
            if dl is not None:
                out.append((dl, float(_prefill_len(req))))
        return out

    def _fleet_meets_slo_without(self, excl: _Member) -> bool:
        """Would the remaining active members still land every
        outstanding SLO deadline if `excl` stopped taking work?

        First-order feasibility: the other members' aggregate
        widest-chunk prefill throughput must finish the fleet's whole
        unstarted prefill backlog (pending queue + every member's lane
        backlog) before the tightest outstanding deadline."""
        others = [m for m in self.members.values()
                  if m is not excl and m.alive
                  and not m.parked and not m.draining]
        if not others:
            return False
        deadlines = self._outstanding_deadlines()
        if not deadlines:
            return True
        rate = 0.0
        for m in others:
            eng = m.engine
            bucket = self._buckets(eng)[-1]
            width = _pow2ceil(eng.lane_width)
            est = eng.fused_step_estimate(width, bucket)
            if est is not None and est.step_s > 0.0:
                rate += width * bucket / est.step_s
        if rate <= 0.0:
            return False
        backlog = (sum(tok for _, tok in deadlines)
                   + sum(m.engine.backlog_tokens
                         for m in self.members.values()
                         if m is not excl and m.alive))
        t_done = self.fleet_now() + backlog / rate
        return t_done <= min(dl for dl, _ in deadlines)

    def _park(self, m: _Member, now: float) -> None:
        """Park an empty member at its chip's idle floor."""
        m.parked = True
        m.parks += 1
        m.parked_from = now

    def _unpark(self, m: _Member, now: float) -> None:
        """Wake a parked member (closing its park interval) so routing
        can hand it work again."""
        m.parked_model_s += max(now - m.parked_from, 0.0)
        m.parked = False
        m.draining = False

    def _race_to_idle(self) -> None:
        """Drain-and-park pass, run once per scheduler tick.

        Parks any live member that has fully drained (idle engines burn
        the same idle floor either way — parking records the decision
        and removes the member from routing). Separately, while more
        than one member is active and the remaining fleet is predicted
        to absorb all outstanding SLO load, the most expensive active
        member (marginal decode J/token) is marked draining: no new
        routes, widest chunks, park on empty."""
        now = self.fleet_now()
        for m in self.members.values():
            if m.alive and not m.parked and not m.engine.has_work:
                if m.draining or not self._pending:
                    self._park(m, now)
        if not self.race_to_idle or self.route_to is not None:
            return
        active = [m for m in self.members.values()
                  if m.alive and not m.parked and not m.draining]
        if len(active) < 2:
            return
        costly = max(active, key=self._decode_j_per_token)
        if (self._decode_j_per_token(costly) > 0.0
                and self._outstanding_deadlines()
                and self._fleet_meets_slo_without(costly)):
            costly.draining = True
            costly.drains += 1

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def step(self) -> list[Result]:
        """One scheduler tick: poll the fault plane, route recovery and
        pending work, advance the live busy member with the smallest
        elapsed clock by one fused engine step (dilating its clock when
        a stall window is open), fold its finished requests into the
        fleet ledger, feed the straggler detector, then run the
        race-to-idle pass. When nothing can step but work is backlogged
        — every member parked or draining, deferrals pending, or the
        whole fleet dead — `_rescue` wakes a member, advances the clock
        past the earliest backoff, or sheds with a terminal disposition
        (the livelock guarantee). Returns the finished `Result`s."""
        self._poll_faults()
        self._route()
        busy = [m for m in self.members.values()
                if m.alive and m.engine.has_work]
        if not busy:
            if self._pending or self._recovery:
                self._rescue()
            return []
        m = min(busy, key=lambda mm: mm.elapsed)
        if m.parked:
            self._unpark(m, self.fleet_now())
        t0 = m.engine.model_clock_s
        out = m.engine.serve_step()
        dt = m.engine.model_clock_s - t0
        if m.stall_factor > 1.0 and dt > 0.0:
            # the stalled member really takes stall_factor x the
            # predicted model time: dilate its clock by the overhead
            m.engine._clock += (m.stall_factor - 1.0) * dt
        for r in out:
            self._finish(m, r)
        if dt > 0.0:
            # observed/predicted step-time ratio: 1.0 when healthy,
            # ~stall_factor under a stall — chip-independent, so a
            # naturally slower chip never reads as a straggler
            self._detector.record(m.host_idx,
                                  (dt * m.stall_factor) / dt)
            self._maybe_evict()
        self._race_to_idle()
        return out

    def _rescue(self) -> None:
        """Unblock a stalled tick (the livelock edge): backlogged work
        with no member able to step. Wakes the cheapest parked or
        draining member when routable work exists, fast-forwards the
        fleet clock to the earliest backoff expiry when everything is
        deferred, and sheds with terminal ``lost`` dispositions when
        the whole fleet is dead."""
        now = self.fleet_now()
        alive = [m for m in self.members.values() if m.alive]
        if not alive:
            while self._recovery:
                rec = self._recovery.popleft()
                meta = self._meta.get(rec["req"].uid)
                if meta is not None:
                    self._shed_request(rec["req"], meta, now,
                                       status="lost")
            while self._pending:
                req = self._pending.popleft()
                self._shed_request(req, self._meta[req.uid], now,
                                   status="lost")
            return
        blocked = [m for m in alive if m.parked or m.draining]
        routable = (bool(self._recovery)
                    or any(self._meta[r.uid].not_before <= now
                           for r in self._pending))
        if blocked and routable:
            m = min(blocked, key=self._decode_j_per_token)
            if m.parked:
                self._unpark(m, now)
            m.draining = False
            return
        nb = [self._meta[r.uid].not_before for r in self._pending
              if self._meta[r.uid].not_before > now]
        if nb:
            # deferred-only backlog: idle the fleet forward to the
            # earliest wake-up so backoffs expire on the model clock
            target = max(alive, key=lambda mm: mm.elapsed)
            wake = min(nb)
            gap = wake - target.elapsed
            if gap > 0.0:
                target.engine._clock += gap
                # the member's elapsed time is its clock less its clock at
                # the fleet's epoch, so the sum can round to just short of
                # the wake-up, and the next gap below half the clock's last
                # bit adds nothing (the JAX package's scheduler livelocks
                # there once `reset_stats` has run on a used engine)
                while target.elapsed < wake:
                    target.engine._clock = math.nextafter(
                        target.engine._clock, math.inf)

    def _finish(self, m: _Member, r: Result) -> None:
        """Record one retirement: provenance (the member that produced
        it must be the member it was routed to), fleet-timeline TTFT
        (engine TTFT plus scheduler queue wait, or the value pinned at
        a mid-stream failure), and SLO attainment."""
        meta = self._meta.pop(r.uid, None)
        if meta is None or meta.engine != m.name:
            raise RuntimeError(
                f"request {r.uid} finished on {m.name!r} but was routed "
                f"to {None if meta is None else meta.engine!r}")
        m.completed += 1
        wait = max(meta.t_handoff - meta.t_submit, 0.0)
        ttft_fleet = (meta.ttft_override
                      if meta.ttft_override is not None
                      else r.ttft_model_s + wait)
        dl_bound = (None if meta.sla is None
                    else self.sla[meta.sla].ttft_model_s)
        self._done[r.uid] = {
            "engine": m.name, "sla": meta.sla, "status": "ok",
            "ttft_fleet_model_s": ttft_fleet,
            "queue_wait_model_s": wait,
            "met_slo": (True if dl_bound is None
                        else ttft_fleet <= dl_bound),
            "pred_j_per_token": meta.pred_j_per_token,
            "pred_ttft_model_s": meta.pred_ttft_s,
            "bucket": meta.bucket,
            "energy_j": r.energy_j, "n_tokens": r.n_tokens,
            "retries": meta.retries, "migrations": meta.migrations,
        }

    def run_until_empty(self) -> list[Result]:
        """Serve every submitted request to a terminal disposition
        (finished, shed, or lost) across the fleet and return the
        finished `Result`s (engine telemetry intact; fleet-level
        telemetry in `report()` / `request_log`)."""
        results: list[Result] = []
        guard = None
        stuck = 0
        while (self._pending or self._recovery
               or any(m.alive and m.engine.has_work
                      for m in self.members.values())):
            out = self.step()
            results.extend(out)
            if out:
                stuck = 0
                continue
            snap = (len(self._pending), len(self._recovery),
                    len(self._done), round(self.fleet_now(), 9))
            if snap == guard:
                stuck += 1
                if stuck > 1000:
                    raise RuntimeError(
                        "fleet scheduler made no progress for 1000 "
                        "idle ticks — livelock")
            else:
                stuck = 0
                guard = snap
        now = self.fleet_now()
        for m in self.members.values():
            if m.alive and not m.parked and not m.engine.has_work:
                self._park(m, now)
        return results

    # ------------------------------------------------------------------
    # ledger / reporting
    # ------------------------------------------------------------------
    @property
    def request_log(self) -> dict[int, dict]:
        """Per-terminal-request fleet telemetry keyed by uid: status
        (``ok``/``shed``/``lost``), routed engine, fleet-timeline TTFT,
        queue wait, SLO attainment, retries/migrations, the routing
        decision's predicted costs, and the engine's energy
        attribution."""
        return dict(self._done)

    def reset_stats(self) -> None:
        """Re-zero the fleet ledger (engines' counters, members' park/
        drain/route/fault records, the request log, the straggler
        detector) after a warm-up pass. Requires a drained fleet."""
        if (self._pending or self._recovery
                or any(m.engine.has_work for m in self.members.values())):
            raise RuntimeError("reset_stats with in-flight work")
        self._done.clear()
        self.routed_to.clear()
        self._meta.clear()
        self._counters = {"migrations": 0, "replays": 0, "retries": 0}
        self._shed_counts.clear()
        self._defer_counts.clear()
        self._detector = StragglerDetector(len(self.members),
                                           self._straggler_cfg)
        for m in self.members.values():
            m.engine.reset_stats()
            m.clock0 = m.engine.model_clock_s
            m.routed = m.completed = m.parks = m.drains = 0
            m.parked_model_s = 0.0
            m.parked = m.draining = False
            m.crashed = m.evicted = False
            m.crashed_at = 0.0
            m.crashes = m.evictions = m.stalls = 0
            m.stall_factor = 1.0
            m.stall_until = 0.0

    def report(self) -> dict:
        """Fleet-level serving report.

        `fleet_energy_j` is the full ledger: every member's served
        energy (attributed + in-call idle, replayed work's lost spend
        included) plus its idle-floor energy
        (`core.energy.parked_energy_j`) over the gap between its busy
        model time and the fleet makespan — a parked or never-used
        member is charged for the whole run (a crashed one only up to
        the crash), which is what makes the single-engine baselines
        comparable. Per-SLA-class blocks carry measured fleet-TTFT
        p50/p95, attainment against the class bound, and the class's
        shed/defer/retry counts; the ``faults`` block aggregates the
        robustness counters and the fault plan's audit trail."""
        from repro_torch.core.energy import parked_energy_j

        makespan = max((m.elapsed for m in self.members.values()),
                       default=0.0)
        engines = {}
        fleet_j = 0.0
        toks = 0
        lost_j = 0.0
        for m in self.members.values():
            rep = m.engine.report()
            busy = rep["model_s"]
            horizon = m.crashed_at if m.crashed else makespan
            gap = max(horizon - busy, 0.0)
            gap_j = parked_energy_j(gap, chip=m.engine.chip_spec,
                                    n_chips=m.engine.tp)
            fleet_j += rep["energy_j"] + gap_j
            toks += rep["generated_tokens"]
            lost_j += rep.get("lost_energy_j", 0.0)
            engines[m.name] = {
                "chip": m.engine.chip_spec.name,
                "tp": m.engine.tp,
                "routed": m.routed, "completed": m.completed,
                "busy_model_s": busy, "gap_idle_model_s": gap,
                "gap_idle_j": gap_j,
                "idle_power_w": m.engine.idle_power_w,
                "parked": m.parked, "parks": m.parks,
                "drains": m.drains,
                "parked_model_s": m.parked_model_s,
                "crashed": m.crashed, "crashes": m.crashes,
                "evicted": m.evicted, "evictions": m.evictions,
                "stalls": m.stalls,
                "tuning_degraded": m.engine.tuning_degraded,
                "engine": rep,
            }
        classes = {}
        names = set(self.sla) | {d["sla"] for d in self._done.values()
                                 if d["sla"] is not None}
        for cname in sorted(names):
            rows = [d for d in self._done.values() if d["sla"] == cname]
            bound = (self.sla[cname].ttft_model_s
                     if cname in self.sla else None)
            ttfts = [d["ttft_fleet_model_s"] for d in rows
                     if d["ttft_fleet_model_s"] is not None]
            classes[cname] = {
                "ttft_slo_model_s": bound,
                "requests": len(rows),
                "attainment": (sum(d["met_slo"] for d in rows) / len(rows)
                               if rows else 1.0),
                "ttft_fleet_p50_model_s": _percentile(ttfts, 50),
                "ttft_fleet_p95_model_s": _percentile(ttfts, 95),
                "shed": self._shed_counts.get(cname, 0),
                "deferred": self._defer_counts.get(cname, 0),
                "retries": sum(d.get("retries", 0) for d in rows),
                "migrations": sum(d.get("migrations", 0) for d in rows),
            }
        slo_rows = [d for d in self._done.values()
                    if d["sla"] is not None
                    and self.sla.get(d["sla"], SLAClass(d["sla"])
                                     ).ttft_model_s is not None]
        return {
            "requests": len(self._done),
            "generated_tokens": toks,
            "makespan_model_s": makespan,
            "fleet_energy_j": fleet_j,
            "fleet_j_per_token": fleet_j / toks if toks else 0.0,
            "attainment": (sum(d["met_slo"] for d in slo_rows)
                           / len(slo_rows) if slo_rows else 1.0),
            "parks": sum(m.parks for m in self.members.values()),
            "drains": sum(m.drains for m in self.members.values()),
            "route_to": self.route_to,
            "sla": classes,
            "engines": engines,
            "faults": {
                "plan": (self._fault_plan.report()
                         if self._fault_plan is not None else None),
                "crashes": sum(m.crashes for m in self.members.values()),
                "evictions": sum(m.evictions
                                 for m in self.members.values()),
                "stalls": sum(m.stalls for m in self.members.values()),
                "migrations": self._counters["migrations"],
                "replays": self._counters["replays"],
                "retries": self._counters["retries"],
                "shed": dict(self._shed_counts),
                "deferred": dict(self._defer_counts),
                "lost_energy_j": lost_j,
                "degraded_members": sorted(
                    n for n, m in self.members.items()
                    if m.engine.tuning_degraded),
            },
        }


def _marginal(chunk_est, decode_est, **kw):
    """Thin alias for `core.energy.marginal_request_cost` (imported
    lazily so the scheduler module imports without the energy stack)."""
    from repro_torch.core.energy import marginal_request_cost

    return marginal_request_cost(chunk_est, decode_est, **kw)
