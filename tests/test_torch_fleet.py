"""The port's fleet scheduler (`repro_torch.serving.scheduler`) against the
JAX package's, on the CPU.

Both schedulers drive fleets of the tiny dense config of the reference's
suites (2 layers, d_model 64) on the same weights (`bridge`), priced on the
reference's chips (TPU v5e, RTX 4070), where the port's energy model gives
the reference's floats. The same seeded workloads go through both: every
request's placement, bucket, stream, disposition and SLO verdict are equal,
and every energy, fleet TTFT and predicted cost agrees to 1e-9 relative.
The reference's properties then run on the port alone: conservation (each
request finishes once, on the member it was routed to, and the fleet
ledger sums from the members) and routing invariance (a request's stream
does not depend on who serves it), under hypothesis.

The JAX engines are built once per module and reused by every scenario
(a JAX engine compiles per shape on first use); each scenario puts their
clocks back at 0 and starts with `FleetScheduler.reset_stats`, so it runs
as on fresh engines, and the port's engines are reused the same way.
"""

from __future__ import annotations

import math
import types
from collections import Counter

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models.config import ModelConfig as JModelConfig
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.faults import FaultEvent as JFaultEvent
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.scheduler import FleetScheduler as JFleetScheduler
from repro.serving.scheduler import SLAClass as JSLAClass
from repro.train.ft import StragglerConfig as JStragglerConfig
from repro_torch.kernels import ops
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.faults import FaultEvent, FaultPlan
from repro_torch.serving.scheduler import FleetScheduler, SLAClass
from repro_torch.train.ft import StragglerConfig

RTOL = 1e-9

PORT = types.SimpleNamespace(
    name="port", Engine=ServingEngine, Request=Request,
    Fleet=FleetScheduler, SLA=SLAClass, FaultPlan=FaultPlan,
    FaultEvent=FaultEvent, StragglerConfig=StragglerConfig,
    engine_kw={"device": "cpu"})
REF = types.SimpleNamespace(
    name="jax", Engine=JServingEngine, Request=JRequest,
    Fleet=JFleetScheduler, SLA=JSLAClass, FaultPlan=JFaultPlan,
    FaultEvent=JFaultEvent, StragglerConfig=JStragglerConfig,
    engine_kw={"mode": "continuous"})

TINY = dict(name="fleet-test", kind="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
            param_dtype="float32", activation_dtype="float32", remat=False)

_CACHE: dict = {}


def served() -> dict:
    """{side name: (cfg, model API, params)}: the tiny config in both
    packages on one set of weights (the JAX init, bridged), memoized."""
    if "served" not in _CACHE:
        jcfg = JModelConfig(**TINY)
        japi = jget_model(jcfg)
        jparams = japi.init(jax.random.key(0), jcfg)
        cfg = ModelConfig(**TINY)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
        _CACHE["served"] = {"jax": (jcfg, japi, jparams),
                            "port": (cfg, get_model(cfg), params)}
    return _CACHE["served"]


def make_engine(side, chip: str = "tpu_v5e", **kw):
    """One fleet member of the reference's suites: 2 slots, max_len 64,
    16-token chunks, seed 0."""
    cfg, model, params = served()[side.name]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    kw.setdefault("seed", 0)
    return side.Engine(model, params, cfg, chip=chip, **side.engine_kw, **kw)


def pooled(side, key: str = "pair") -> dict:
    """The module's reused members of `side`: "pair" is the reference's
    two-member fleet (v5e on the TPU v5e, ada on the RTX 4070), "alone" one
    v5e engine."""
    k = (side.name, key)
    if k not in _CACHE:
        chips = ({"v5e": "tpu_v5e", "ada": "rtx4070"} if key == "pair"
                 else {"v5e": "tpu_v5e"})
        _CACHE[k] = {n: make_engine(side, c) for n, c in chips.items()}
    return _CACHE[k]


def make_fleet(side, slo: float | None = 0.5, engines: dict | None = None,
               **sched_kw):
    """A fleet over `engines` (default: the pooled pair, its clocks back at
    0 and its ledger re-zeroed, as a fresh pair's) with one interactive
    TTFT class when `slo` is set (or `sla=`)."""
    fresh = engines is not None
    if not fresh:
        engines = pooled(side)
        for eng in engines.values():
            # a fleet on used engines can livelock the reference (queue C;
            # test_torch_faults.py holds the port's fix)
            eng._clock = 0.0
    if slo is not None or "sla" in sched_kw:
        sched_kw.setdefault("default_sla", "interactive")
        sched_kw.setdefault("sla", {"interactive": side.SLA("interactive",
                                                             slo)})
    sched = side.Fleet(engines, **sched_kw)
    if not fresh:
        sched.reset_stats()
    return sched


def workload(side, seed: int, n: int, lo: int = 3, hi: int = 40,
             max_budget: int = 8) -> list:
    """The reference suites' seeded mixed-length workload, fresh requests
    of `side`'s class."""
    rng = np.random.default_rng(seed)
    return [side.Request(
        uid=i, prompt=rng.integers(0, 256, int(rng.integers(lo, hi))
                                   ).astype(np.int32),
        max_new_tokens=int(rng.integers(1, max_budget + 1)))
        for i in range(n)]


def run(side, seed: int, n: int, slo: float | None = 0.5, **kw) -> tuple:
    """(results by uid, scheduler) of a seeded workload through a fleet."""
    sched = make_fleet(side, slo, **kw)
    for r in workload(side, seed, n):
        sched.submit(r)
    return {r.uid: r for r in sched.run_until_empty()}, sched


def reference_streams(side, seed: int, n: int) -> tuple[dict, float]:
    """(streams by uid, model seconds) of one v5e engine serving the
    workload alone: the streams every placement must give, and the horizon
    fault plans are pinned to."""
    (eng,) = pooled(side, "alone").values()
    eng.reset_stats()
    for r in workload(side, seed, n):
        eng.submit(r)
    out = {r.uid: list(r.tokens) for r in eng.run_until_empty()}
    return out, eng.report()["model_s"]


def _close(got, want, what: str) -> None:
    if want is None or got is None:
        assert got is want, what
    else:
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0), (
            what, got, want)


LOG_EXACT = ("engine", "sla", "status", "met_slo", "bucket", "n_tokens",
             "retries", "migrations")
LOG_CLOSE = ("ttft_fleet_model_s", "queue_wait_model_s", "pred_j_per_token",
             "pred_ttft_model_s", "energy_j")
REPORT_EXACT = ("requests", "generated_tokens", "parks", "drains",
                "route_to")
REPORT_CLOSE = ("makespan_model_s", "fleet_energy_j", "fleet_j_per_token",
                "attainment")
MEMBER_EXACT = ("chip", "tp", "routed", "completed", "parked", "parks",
                "drains", "crashed", "crashes", "evicted", "evictions",
                "stalls", "tuning_degraded")
MEMBER_CLOSE = ("busy_model_s", "gap_idle_model_s", "gap_idle_j",
                "idle_power_w", "parked_model_s")
FAULTS_EXACT = ("plan", "crashes", "evictions", "stalls", "migrations",
                "replays", "retries", "shed", "deferred",
                "degraded_members")


def assert_same_run(ref: tuple, port: tuple) -> None:
    """Two runs of one scenario agree: placements, streams, dispositions,
    recovery counts and the fault report exactly; every joule, model
    second, TTFT and predicted cost to 1e-9 relative."""
    (jres, jsched), (pres, psched) = ref, port
    assert psched.routed_to == jsched.routed_to
    assert sorted(pres) == sorted(jres)
    for uid, r in jres.items():
        np.testing.assert_array_equal(pres[uid].tokens, r.tokens)
        _close(pres[uid].energy_j, r.energy_j, f"uid {uid} energy")
    jlog, plog = jsched.request_log, psched.request_log
    assert sorted(plog) == sorted(jlog)
    for uid, d in jlog.items():
        for key in LOG_EXACT:
            assert plog[uid][key] == d[key], (uid, key)
        for key in LOG_CLOSE:
            _close(plog[uid][key], d[key], f"uid {uid} {key}")
    jrep, prep = jsched.report(), psched.report()
    for key in REPORT_EXACT:
        assert prep[key] == jrep[key], key
    for key in REPORT_CLOSE:
        _close(prep[key], jrep[key], key)
    for name, e in jrep["engines"].items():
        for key in MEMBER_EXACT:
            assert prep["engines"][name][key] == e[key], (name, key)
        for key in MEMBER_CLOSE:
            _close(prep["engines"][name][key], e[key], f"{name} {key}")
        for key in ("energy_j", "attributed_energy_j", "idle_energy_j",
                    "model_s", "lost_energy_j"):
            _close(prep["engines"][name]["engine"][key], e["engine"][key],
                   f"{name} engine {key}")
        assert (prep["engines"][name]["engine"]["adopted_in"]
                == e["engine"]["adopted_in"])
    for cname, c in jrep["sla"].items():
        p = prep["sla"][cname]
        for key in ("requests", "shed", "deferred", "retries", "migrations"):
            assert p[key] == c[key], (cname, key)
        for key in ("attainment", "ttft_fleet_p50_model_s",
                    "ttft_fleet_p95_model_s"):
            _close(p[key], c[key], f"{cname} {key}")
    for key in FAULTS_EXACT:
        assert prep["faults"][key] == jrep["faults"][key], key
    _close(prep["faults"]["lost_energy_j"], jrep["faults"]["lost_energy_j"],
           "lost_energy_j")


def both(scenario) -> tuple:
    """`scenario(side)` on the reference, then on the port."""
    return scenario(REF), scenario(PORT)


# ---------------------------------------------------------------------------
# parity with the JAX package's scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,slo", [
    (11, 6, 0.5),
    (29, 5, 0.02),      # tight SLO: misses allowed
    (47, 4, None),      # best effort only
    (3, 10, 30.0),      # loose SLO: race to idle drains the costly member
])
def test_fleet_matches_the_reference(seed, n, slo):
    ref, port = both(lambda side: run(side, seed, n, slo))
    assert_same_run(ref, port)
    if slo == 30.0:
        assert port[1].report()["drains"] >= 1


@pytest.mark.parametrize("route_to", ["v5e", "ada"])
def test_single_engine_baseline_matches_the_reference(route_to):
    assert_same_run(*both(lambda side: run(side, 5, 4, route_to=route_to)))


def test_two_sla_classes_match_the_reference():
    """The fleet mix's shape: batch (best effort) prompts ahead of
    interactive ones, each submitted with its class."""
    def scenario(side):
        sched = make_fleet(side, None, sla={
            "interactive": side.SLA("interactive", 0.01),
            "batch": side.SLA("batch", None)})
        reqs = workload(side, 19, 8, lo=3, hi=12)
        long = workload(side, 23, 2, lo=40, hi=60)
        for r in long:
            r.uid += 100
            sched.submit(r, sla="batch")
        for r in reqs:
            sched.submit(r, sla="interactive")
        return {r.uid: r for r in sched.run_until_empty()}, sched

    assert_same_run(*both(scenario))


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------


def check_fleet(seed: int, n: int, slo: float | None, engines=None,
                **kw) -> tuple:
    """Serve a seeded workload across a port fleet and hold every
    conservation invariant; returns (results by uid, scheduler)."""
    results, sched = run(PORT, seed, n, slo, engines=engines, **kw)
    rep, log = sched.report(), sched.request_log
    assert sorted(results) == list(range(n))
    assert rep["requests"] == n
    routed = Counter(sched.routed_to.values())
    assert sum(routed.values()) == n
    for name, e in rep["engines"].items():
        assert e["completed"] == routed.get(name, 0)
        assert e["engine"]["requests"] == routed.get(name, 0)
    for uid in results:
        assert log[uid]["engine"] == sched.routed_to[uid]
    attributed = sum(r.energy_j for r in results.values())
    eng_attr = sum(e["engine"]["attributed_energy_j"]
                   for e in rep["engines"].values())
    np.testing.assert_allclose(attributed, eng_attr, rtol=RTOL, atol=1e-12)
    ledger = sum(e["engine"]["energy_j"] + e["gap_idle_j"]
                 for e in rep["engines"].values())
    np.testing.assert_allclose(rep["fleet_energy_j"], ledger, rtol=RTOL)
    assert rep["fleet_energy_j"] >= attributed - 1e-9
    assert rep["generated_tokens"] == sum(r.n_tokens
                                          for r in results.values())
    return results, sched


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16 - 1), n=st.integers(2, 7),
       slo=st.sampled_from([0.05, 0.5, None]))
def test_fleet_conservation_and_routing_invariance(seed, n, slo):
    results, _ = check_fleet(seed, n, slo)
    streams, _ = reference_streams(PORT, seed, n)
    for uid, r in results.items():
        assert list(r.tokens) == streams[uid], uid


def test_h100_members_keep_the_invariants():
    """Members priced on the card (chip=None prices on the "h100") beside
    one on the RTX 4070: the ledger charges the h100's idle floor, and
    placement changes no stream."""
    from repro_torch.core.chips import get_chip

    engines = {"h100-a": make_engine(PORT, None),
               "h100-b": make_engine(PORT, "h100"),
               "ada": make_engine(PORT, "rtx4070")}
    results, sched = check_fleet(7, 8, 1e-3, engines=engines)
    rep = sched.report()
    assert rep["engines"]["h100-a"]["chip"] == "h100"
    assert (rep["engines"]["h100-a"]["idle_power_w"]
            == get_chip("h100").idle_power_w)
    streams, _ = reference_streams(PORT, 7, 8)
    assert {u: list(r.tokens) for u, r in results.items()} == streams


def test_single_engine_baseline_parks_the_rest():
    results, sched = check_fleet(5, 4, 0.5, route_to="ada")
    rep = sched.report()
    assert rep["engines"]["v5e"]["routed"] == 0
    assert rep["engines"]["v5e"]["busy_model_s"] == 0.0
    np.testing.assert_allclose(rep["engines"]["v5e"]["gap_idle_model_s"],
                               rep["makespan_model_s"], rtol=RTOL)
    assert rep["engines"]["ada"]["completed"] == 4


def test_race_to_idle_drains_expensive_engine():
    results, sched = check_fleet(3, 10, 30.0)
    rep = sched.report()
    assert rep["drains"] >= 1 and rep["attainment"] == 1.0
    drained = [n for n, e in rep["engines"].items() if e["drains"]]
    assert all(rep["engines"][n]["parked"] for n in drained)


def test_chunk_policy_installed_and_scoped():
    sched = make_fleet(PORT, None)
    for m in sched.members.values():
        assert m.engine.chunk_policy is not None
        assert m.engine.chunk_policy(m.engine, [(Request(
            uid=99, prompt=np.zeros(4, np.int32)), 4)]) is None


def test_chunk_policy_widens_the_chunk():
    """An engine's chunk stage takes the policy's bucket: a policy that
    asks for the widest bucket serves a multi-chunk prompt in fewer chunk
    calls, with the same stream."""
    def serve(policy):
        eng = make_engine(PORT)
        eng.chunk_policy = policy
        eng.submit(Request(uid=0, prompt=np.arange(48, dtype=np.int32),
                           max_new_tokens=3))
        eng.submit(Request(uid=1, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=3))
        out = eng.run_until_empty()
        return {r.uid: list(r.tokens) for r in out}, eng.report()

    seen = []
    base, rb = serve(None)
    wide, rw = serve(lambda eng, pending: seen.append(pending) or 16)
    assert wide == base and rw["chunk_steps"] < rb["chunk_steps"]
    assert seen[0][0][1] == 48 and seen[0][1][1] == 5


@pytest.mark.parametrize("kw", [{"mode": "wave"}, {"admission": "serial"},
                                {"kv_layout": "paged", "page_size": 8}])
def test_scheduler_rejects_unsteppable_engine(kw):
    with pytest.raises(ValueError, match="steppable"):
        FleetScheduler({"w": make_engine(PORT, **kw)})


def test_scheduler_validates_sla_names():
    with pytest.raises(ValueError, match="default_sla"):
        make_fleet(PORT, 0.5, default_sla="nope")
    sched = make_fleet(PORT, 0.5)
    with pytest.raises(ValueError, match="unknown SLA"):
        sched.submit(Request(uid=0, prompt=np.zeros(4, np.int32)),
                     sla="bulk")
    with pytest.raises(ValueError, match="route_to"):
        make_fleet(PORT, 0.5, route_to="nope")
    with pytest.raises(ValueError, match="policy"):
        SLAClass("x", 0.1, policy="drop")


def test_reset_stats_rezeroes_ledger():
    engines = {"v5e": make_engine(PORT, "tpu_v5e"),
               "ada": make_engine(PORT, "rtx4070")}
    sched = make_fleet(PORT, 0.5, engines=engines)
    for r in workload(PORT, 13, 3):
        sched.submit(r)
    sched.run_until_empty()
    sched.reset_stats()
    rep = sched.report()
    assert rep["requests"] == 0
    assert rep["fleet_energy_j"] == 0.0
    assert rep["makespan_model_s"] == 0.0
    for r in workload(PORT, 17, 3):
        sched.submit(r)
    assert len(sched.run_until_empty()) == 3


def test_draining_fleet_cannot_livelock():
    sched = make_fleet(PORT, 0.5)
    now = sched.fleet_now()
    for m in sched.members.values():
        m.draining = True
        sched._park(m, now)
    sched.submit(Request(uid=0, prompt=np.zeros(6, np.int32),
                         max_new_tokens=3))
    results = []
    for _ in range(200):
        results.extend(sched.step())
        if results:
            break
    assert [r.uid for r in results] == [0]
    assert sched.request_log[0]["status"] == "ok"


def test_serve_step_contract():
    """Steps interleave with submissions and drain exactly the
    run_until_empty streams; the lane view and backlog read the lane."""
    eng = make_engine(PORT)
    assert eng.lane_view == dict.fromkeys(eng.lane_view, 0)
    stepped: list = []
    for r in workload(PORT, 21, 3):
        eng.submit(r)
        assert eng.backlog_tokens >= len(r.prompt)
        while eng.has_work:
            out = eng.serve_step()
            stepped.extend(out)
            if out:
                break
    views = []
    while eng.has_work:
        stepped.extend(eng.serve_step())
        views.append(eng.lane_view)
    assert views[-1] == dict.fromkeys(views[-1], 0) and eng.backlog_tokens == 0
    streams, _ = reference_streams(PORT, 21, 3)
    assert {r.uid: list(r.tokens) for r in stepped} == streams


# ---------------------------------------------------------------------------
# fleet pre-tuning
# ---------------------------------------------------------------------------


def test_warm_fleet_gemm_cache_tunes_one_pass_per_chip(monkeypatch):
    """Engines sharing a chip are unioned into one `warm_gemm_cache` call
    (chip=None names the active chip); each spec gets its own shapes."""
    calls = []

    def fake_warm(shapes, *, dtype, objective, chip, rank_mode):
        calls.append((chip, dtype, tuple(shapes)))
        return {s: ops.BlockConfig(8, 128, 128) for s in shapes}

    monkeypatch.setattr(ops, "warm_gemm_cache", fake_warm)
    cfg = served()["port"][0]
    base = {"cfg": cfg, "max_len": 64, "chunk_tokens": 16, "dtype": "float32"}
    specs = [{**base, "max_batch": 2, "chip": None},
             {**base, "max_batch": 4, "chip": "h100"},
             {**base, "max_batch": 2, "chip": "rtx4070"}]
    out = ops.warm_fleet_gemm_cache(specs, objective="energy")
    assert sorted(c[0] for c in calls) == ["h100", "rtx4070"]
    for sp, got in zip(specs, out):
        kw = {k: v for k, v in sp.items() if k not in ("cfg", "chip",
                                                        "dtype")}
        assert sorted(got) == ops.serving_gemm_fleet(cfg, **kw)
    h100 = next(c for c in calls if c[0] == "h100")[2]
    assert set(out[0]) | set(out[1]) == set(h100)


def test_pretune_installs_the_members_winners(monkeypatch):
    """`pretune=True` fills each member's `pretuned` from its chip's pass
    and has it launch the tuned objective's winners; the step estimates
    are priced again."""
    def fake(specs, *, objective, rank_mode):
        return [{(1, 2, 3): ops.BlockConfig(8, 128, 128)} for _ in specs]

    monkeypatch.setattr(ops, "warm_fleet_gemm_cache", fake)
    engines = {"a": make_engine(PORT, "h100"),
               "b": make_engine(PORT, "rtx4070")}
    for e in engines.values():
        e.decode_step_estimate()
    FleetScheduler(engines, pretune=True, tune_objective="energy")
    for e in engines.values():
        assert e.pretuned == {(1, 2, 3): ops.BlockConfig(8, 128, 128)}
        assert e.tune_objective == "energy"
        assert not e._step_energy_cache
