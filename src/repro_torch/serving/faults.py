"""Deterministic fault injection for the serving fleet.

A `FaultPlan` is a seeded schedule of `FaultEvent`s pinned to the fleet
*model clock* — the deterministic timeline of predicted call seconds the
scheduler already orders engine steps by — so a chaos run is exactly
reproducible from its seed: the same faults land between the same engine
steps on every host and platform. The scheduler polls `due(now)` once
per tick and applies whatever fired.

Four fault kinds cover the serving failure model (`docs/serving.md`,
"Failure model & recovery"):

* ``crash`` — the member dies. Its in-flight requests are checkpointed
  (`ServingEngine.checkpoint_inflight`) and migrated or replayed by the
  scheduler; ``state_lost=True`` models losing the device state with the
  node (every request replays). A crashed member is charged its idle
  floor only up to the crash instant.
* ``stall`` — the member's steps dilate by ``factor`` for
  ``duration_s`` of fleet time (thermal throttling, a sick NIC). The
  scheduler does NOT act on the plan directly: detection goes through
  `train.ft.StragglerDetector` EWMAs over per-member step times, the
  same machinery the training stack trusts, and eviction follows the
  detector's flag, not the schedule.
* ``page_pressure`` — ``pages`` pages vanish from the member's page
  pool for ``duration_s`` (`PageAllocator.squeeze`), modelling an
  external tenant; the engine sheds shared-prefix registry entries
  before deferring admissions. Only meaningful for paged engines.
* ``artifact_corruption`` — the member's next (re)tune hits an
  `ArtifactError` (`ServingEngine.retune`); tuning degrades to the
  untuned tiles of `autotuner.baseline_configs` (`plan`'s on the h100,
  the paper's BASELINE on the reference's chips), which price work and
  launch nothing new, and serving continues, flagged in `report()`.

A copy of the JAX package's `repro.serving.faults` (numpy only;
`tests/test_torch_faults.py` holds the copy equal to the reference).

Faults change *where and when* work runs — never what it computes. The
engine's bit-parity contract (streams are placement/batch/chunk
independent) is what makes migration bit-identical and replay
append-only, so the chaos property suite can diff token streams against
a no-fault run directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("crash", "stall", "page_pressure", "artifact_corruption")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, pinned to the fleet model clock."""

    t_model_s: float            # fleet-clock firing time
    kind: str                   # one of KINDS
    member: str                 # fleet member the fault targets
    duration_s: float = 0.0     # stall / page_pressure window
    factor: float = 4.0         # stall: step-time dilation
    state_lost: bool = False    # crash: device state unrecoverable
    pages: int = 0              # page_pressure: pages squeezed

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "stall" and self.factor <= 1.0:
            raise ValueError("stall factor must exceed 1.0")


class FaultPlan:
    """A deterministic, seeded schedule of faults on the fleet clock.

    Events fire in time order via `due(now)`, which pops and returns
    every event with ``t_model_s <= now`` — the scheduler calls it once
    per tick. `random()` draws a reproducible schedule; `report()`
    serializes the plan (seed included) so a chaos bench artifact alone
    reproduces the run.
    """

    def __init__(self, events: list[FaultEvent] | None = None, *,
                 seed: int | None = None):
        self.seed = seed
        self._events = sorted(events or [], key=lambda e: e.t_model_s)
        self._fired: list[FaultEvent] = []

    @classmethod
    def random(cls, members: list[str], seed: int, *,
               horizon_s: float, n_events: int = 3,
               kinds: tuple[str, ...] = ("crash", "stall"),
               stall_factor: float = 8.0,
               stall_duration_frac: float = 0.3,
               state_lost_p: float = 0.5) -> "FaultPlan":
        """Draw `n_events` faults uniformly over ``(0, horizon_s)`` with
        kinds/members chosen by the seeded stream. At most one crash per
        member is drawn (a member only dies once), and never every
        member: at least one survivor remains to absorb the work."""
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        crashed: set[str] = set()
        for _ in range(n_events):
            kind = str(rng.choice(list(kinds)))
            member = str(rng.choice(members))
            t = float(rng.uniform(0.0, horizon_s))
            if kind == "crash":
                if member in crashed or len(crashed) + 1 >= len(members):
                    kind = "stall"     # keep a survivor
                else:
                    crashed.add(member)
            if kind == "crash":
                events.append(FaultEvent(
                    t, "crash", member,
                    state_lost=bool(rng.random() < state_lost_p)))
            elif kind == "stall":
                events.append(FaultEvent(
                    t, "stall", member, factor=stall_factor,
                    duration_s=stall_duration_frac * horizon_s))
            elif kind == "page_pressure":
                events.append(FaultEvent(
                    t, "page_pressure", member,
                    duration_s=stall_duration_frac * horizon_s,
                    pages=int(rng.integers(1, 9))))
            else:
                events.append(FaultEvent(t, "artifact_corruption", member))
        return cls(events, seed=seed)

    def due(self, now: float) -> list[FaultEvent]:
        """Pop and return every event scheduled at or before `now`."""
        fired: list[FaultEvent] = []
        while self._events and self._events[0].t_model_s <= now:
            fired.append(self._events.pop(0))
        self._fired.extend(fired)
        return fired

    @property
    def remaining(self) -> int:
        """Events scheduled but not yet fired."""
        return len(self._events)

    def __len__(self) -> int:
        return len(self._events) + len(self._fired)

    def report(self) -> dict:
        """Serializable view of the plan: the seed plus every event and
        whether it has fired — the chaos bench embeds this in its JSON
        artifact so a fault run is auditable (and reproducible) from the
        artifact alone."""
        def row(e: FaultEvent, fired: bool) -> dict:
            return {**dataclasses.asdict(e), "fired": fired}
        return {
            "seed": self.seed,
            "events": ([row(e, True) for e in self._fired]
                       + [row(e, False) for e in self._events]),
        }


def retry_backoff_s(attempt: int, *, base_s: float = 0.05,
                    cap_s: float = 1.0) -> float:
    """Capped exponential backoff for replay/defer retries: ``base *
    2**(attempt-1)`` clamped to `cap_s` (attempt counts from 1).
    Deterministic — no jitter — so retry timelines replay exactly under
    a fixed seed."""
    if attempt < 1:
        raise ValueError("attempt counts from 1")
    return min(base_s * (2.0 ** (attempt - 1)), cap_s)
