"""Fault tolerance: straggler detection, preemption handling, restart policy.

A copy of the JAX package's `repro.train.ft` (numpy-free, framework-free
code; `tests/test_torch_ft.py` holds the copy equal to the reference). At
1000+ nodes, three failure classes matter:
  1. hard node loss  -> checkpoint/restart (CheckpointManager) onto the
     surviving topology (launch/elastic.py re-meshes);
  2. stragglers      -> per-host step-time heartbeats; a host whose EWMA
     exceeds `threshold` x the fleet median for `patience` consecutive
     steps is flagged for eviction (the scheduler then restarts without it);
  3. preemption      -> SIGTERM triggers a final blocking save.
"""

from __future__ import annotations

import dataclasses
import signal
import time


@dataclasses.dataclass
class StragglerConfig:
    threshold: float = 1.5     # x fleet median
    patience: int = 5          # consecutive slow steps before flagging
    ewma: float = 0.2


class StragglerDetector:
    """Tracks per-host step-time EWMAs; flags persistent outliers.

    The serving fleet reuses this over per-member `serve_step` model
    times (`serving/scheduler.py`): a stalled member's EWMA crosses
    `threshold` x the fleet median and, after `patience` consecutive
    slow observations, the scheduler evicts it and migrates its
    in-flight requests. A recovered host re-enters via `reset`."""

    def __init__(self, n_hosts: int, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.n_hosts = n_hosts
        self._ewma = [None] * n_hosts
        self._slow_streak = [0] * n_hosts

    def record(self, host: int, step_time_s: float) -> None:
        prev = self._ewma[host]
        a = self.cfg.ewma
        self._ewma[host] = (step_time_s if prev is None
                            else (1 - a) * prev + a * step_time_s)

    def reset(self, host: int) -> None:
        """Forget a host's history — a recovered (or replaced) straggler
        starts a fresh EWMA and a zero streak, so a past stall cannot
        re-flag it the moment it rejoins."""
        self._ewma[host] = None
        self._slow_streak[host] = 0

    def update_flags(self) -> list[int]:
        """Call once per step after all records; returns flagged hosts.

        The reference is the *true* median of known EWMAs (central pair
        averaged for even counts): taking the upper-median element made
        the slowest of two hosts its own reference, so a 2-host fleet
        could never flag its straggler. A single-host fleet never flags
        (no peer to compare against)."""
        known = [e for e in self._ewma if e is not None]
        if len(known) < max(2, self.n_hosts // 2):
            return []
        ks = sorted(known)
        n = len(ks)
        med = ks[n // 2] if n % 2 else 0.5 * (ks[n // 2 - 1] + ks[n // 2])
        flagged = []
        for h in range(self.n_hosts):
            e = self._ewma[h]
            if e is not None and e > self.cfg.threshold * med:
                self._slow_streak[h] += 1
            else:
                self._slow_streak[h] = 0
            if self._slow_streak[h] >= self.cfg.patience:
                flagged.append(h)
        return flagged


class PreemptionHandler:
    """SIGTERM/SIGINT -> set flag; the loop saves and exits cleanly."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._orig = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._orig[sig] = signal.signal(sig, self._handler)
                except ValueError:  # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.preempted = True

    def restore(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


@dataclasses.dataclass
class StepTimer:
    """Wall-clock step timing with warmup discard and simple stats."""

    warmup: int = 2
    times: list = dataclasses.field(default_factory=list)
    _t0: float = 0.0
    _count: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
