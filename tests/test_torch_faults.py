"""The port's fault injection and recovery (`repro_torch.serving.faults`, the
engine's recovery hooks, the scheduler's fault plane) against the JAX
package's, on the CPU.

`faults.py` is numpy code the port copies: its code is held equal to the
reference's and a seeded `FaultPlan.random` gives the reference's events.
The same seeded fault plans then run through both packages' fleets (the
helpers and engine pools of `test_torch_fleet.py`): placements, streams,
dispositions (done, shed, deferred), recovery kinds (migrated, replayed)
and the fault report are equal, and the joules, lost joules and fleet
TTFTs agree to 1e-9 relative. The reference's chaos properties run on the
port alone: exactly once, streams equal to the fault-free run (a migrated
row continues bit for bit, a replay re-emits its prefix and continues), an
append-only replay, the ledger, eviction, the degrade flag and page
pressure.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.autotuner import BASELINE as JBASELINE
from repro.core.predictor import ArtifactError as JArtifactError
from repro.serving import faults as jfaults
from repro_torch.core.autotuner import REFERENCE_BASELINE, baseline_configs
from repro_torch.core.energy import default_tile
from repro_torch.core.predictor import ArtifactError
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.serving import faults
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import FaultEvent, FaultPlan, retry_backoff_s
from repro_torch.serving.paging import PageAllocator
from repro_torch.train.ft import StragglerConfig
from test_torch_fleet import (PORT, REF, assert_same_run, both, make_engine,
                              make_fleet, reference_streams, workload)
from test_torch_ft import code_without_docstrings


def test_the_copy_is_the_reference_code():
    assert code_without_docstrings(faults) == code_without_docstrings(jfaults)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n_members=st.integers(1, 4),
       n_events=st.integers(0, 12),
       kinds=st.sets(st.sampled_from(faults.KINDS), min_size=1),
       horizon=st.floats(1e-6, 10.0))
def test_random_plans_match_the_reference(seed, n_members, n_events, kinds,
                                          horizon):
    members = [f"m{i}" for i in range(n_members)]
    kinds = tuple(sorted(kinds))
    ours = FaultPlan.random(members, seed, horizon_s=horizon,
                            n_events=n_events, kinds=kinds)
    ref = jfaults.FaultPlan.random(members, seed, horizon_s=horizon,
                                   n_events=n_events, kinds=kinds)
    assert ours.report() == ref.report()
    for now in (0.25 * horizon, horizon):
        assert ours.due(now) == [FaultEvent(**vars(e))
                                 for e in ref.due(now)]
        assert ours.remaining == ref.remaining and len(ours) == len(ref)
    assert ours.report() == ref.report()


def test_fault_plan_due_pops_in_order():
    plan = FaultPlan([FaultEvent(2.0, "crash", "b"),
                      FaultEvent(1.0, "stall", "a", factor=4.0)])
    assert plan.due(0.5) == []
    assert [e.kind for e in plan.due(1.5)] == ["stall"]
    assert plan.remaining == 1
    assert [e.kind for e in plan.due(10.0)] == ["crash"]
    assert plan.due(10.0) == [] and len(plan) == 2


def test_fault_plan_random_keeps_a_survivor():
    p = FaultPlan.random(["a", "b"], 5, horizon_s=1.0, n_events=10,
                         kinds=("crash",))
    assert len([e for e in p._events if e.kind == "crash"]) <= 1
    assert all(0.0 <= e.t_model_s <= 1.0 for e in p._events)


def test_fault_plan_report_tracks_fired():
    plan = FaultPlan([FaultEvent(1.0, "stall", "a", factor=2.0)], seed=9)
    rep = plan.report()
    assert rep["seed"] == 9 and not rep["events"][0]["fired"]
    plan.due(2.0)
    assert plan.report()["events"][0]["fired"]


def test_fault_event_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent(0.0, "meteor", "a")
    with pytest.raises(ValueError, match="factor"):
        FaultEvent(0.0, "stall", "a", factor=1.0)
    with pytest.raises(ValueError, match="kind"):
        FaultPlan.random(["a"], 0, horizon_s=1.0, kinds=("meteor",))


@pytest.mark.parametrize("attempt,kw", [(1, {}), (2, {}), (20, {}),
                                        (3, {"base_s": 0.01, "cap_s": 0.02})])
def test_retry_backoff_matches_the_reference(attempt, kw):
    assert retry_backoff_s(attempt, **kw) == jfaults.retry_backoff_s(
        attempt, **kw)
    with pytest.raises(ValueError):
        retry_backoff_s(0)


# ---------------------------------------------------------------------------
# chaos runs against the JAX package's
# ---------------------------------------------------------------------------


def _step_until_resident(sched, name: str, budget: int = 500) -> list:
    """Drive the scheduler until member `name` holds a decode row with an
    emitted token; returns the results retired on the way."""
    out = []
    for _ in range(budget):
        out.extend(sched.step())
        lv = sched.members[name].engine._live
        if lv is not None and any(s is not None for s in lv.slots):
            return out
    raise AssertionError(f"{name} never held a decode slot")


def _chaos(seed: int, n: int, slo, plan_of, crash: tuple | None = None,
           **kw):
    """The scenario behind each parity test: a seeded workload through the
    pooled fleet with the plan `plan_of(side, horizon)` (the horizon is the
    JAX side's fault-free makespan, so both plans are the same floats),
    and optionally a manual `_fail_member` once `crash[0]` holds a row."""
    _, horizon = reference_streams(REF, seed, n)

    def scenario(side):
        plan = plan_of(side, max(horizon, 1e-6)) if plan_of else None
        if "straggler_cfg" in kw:
            kw["straggler_cfg"] = side.StragglerConfig(
                **vars(kw["straggler_cfg"]))
        sched = make_fleet(side, slo, **kw)
        sched.arm_faults(plan)
        for r in workload(side, seed, n):
            sched.submit(r)
        out = []
        if crash is not None:
            out = _step_until_resident(sched, crash[0])
            sched._fail_member(sched.members[crash[0]], evict=False,
                               state_lost=crash[1])
        out += sched.run_until_empty()
        return {r.uid: r for r in out}, sched

    return both(scenario)


@pytest.mark.parametrize("seed,n,slo,plan_seed", [
    (11, 5, 0.5, 101),
    (29, 4, None, 7),
    (5, 6, 0.5, 3),
])
def test_random_chaos_matches_the_reference(seed, n, slo, plan_seed):
    ref, port = _chaos(seed, n, slo, lambda side, h: side.FaultPlan.random(
        ["v5e", "ada"], plan_seed, horizon_s=h))
    assert_same_run(ref, port)


@pytest.mark.parametrize("member,state_lost", [("v5e", False),
                                               ("ada", True)])
def test_crash_recovery_matches_the_reference(member, state_lost):
    """A crash with the device state kept migrates the resident rows (and
    replays the queued and mid-prefill ones); one that loses it replays
    every request: both recover as the reference does, the same requests
    the same way."""
    ref, port = _chaos(7 if not state_lost else 13, 6, 0.5, None,
                       crash=(member, state_lost))
    assert_same_run(ref, port)
    faults_ = port[1].report()["faults"]
    assert faults_["crashes"] == 1 and faults_["replays"] > 0
    assert (faults_["migrations"] > 0) != state_lost


def test_stall_eviction_matches_the_reference():
    ref, port = _chaos(
        23, 8, 0.5, lambda side, h: side.FaultPlan([side.FaultEvent(
            0.0, "stall", "ada", factor=8.0, duration_s=1e9)]),
        straggler_cfg=StragglerConfig(patience=2))
    assert_same_run(ref, port)
    assert port[1].report()["engines"]["ada"]["evictions"] >= 1


def test_artifact_corruption_matches_the_reference():
    """Degraded pricing on the reference's chips is the reference's
    BASELINE: the schedule after the fault, every joule and TTFT, agree.
    Fresh engines: a degraded member stays degraded."""
    def fresh(side):
        return {"v5e": make_engine(side, "tpu_v5e"),
                "ada": make_engine(side, "rtx4070")}

    _, horizon = reference_streams(REF, 31, 5)

    def scenario(side):
        sched = make_fleet(side, 0.5, engines=fresh(side),
                           fault_plan=side.FaultPlan([side.FaultEvent(
                               0.3 * horizon, "artifact_corruption",
                               "v5e")]))
        for r in workload(side, 31, 5):
            sched.submit(r)
        return {r.uid: r for r in sched.run_until_empty()}, sched

    ref, port = both(scenario)
    assert_same_run(ref, port)
    rep = port[1].report()
    assert rep["faults"]["degraded_members"] == ["v5e"]
    assert "corrupt" in rep["engines"]["v5e"]["engine"][
        "tuning_degraded_reason"]


@pytest.mark.parametrize("sla,kw", [
    ({"policy": "shed", "ttft": 1e-12}, {}),
    ({"policy": "defer", "ttft": 1e-12, "defer_s": 0.01, "max_defers": 2},
     {}),
    ({"policy": "defer", "ttft": 1e6, "defer_s": 0.01, "max_defers": 3},
     {"admission_watermark_tokens": 1}),
])
def test_admission_control_matches_the_reference(sla, kw):
    """Shed, defer and the backlog watermark, on fresh engines (a
    deferral on a used engine's clock can livelock the reference, see
    below)."""
    sla = dict(sla)
    ttft = sla.pop("ttft")
    ref, port = both(lambda side: _admission(side, ttft, sla, kw))
    assert_same_run(ref, port)
    assert port[1].report()["sla"]["interactive"][
        "shed" if sla["policy"] == "shed" else "deferred"] >= 1


def _admission(side, ttft: float, sla: dict, kw: dict,
               clock: float = 0.0) -> tuple:
    engines = {"v5e": make_engine(side, "tpu_v5e"),
               "ada": make_engine(side, "rtx4070")}
    for eng in engines.values():
        eng._clock = clock
    sched = make_fleet(side, None, engines=engines, sla={
        "interactive": side.SLA("interactive", ttft, **sla)}, **kw)
    for r in workload(side, 67, 4):
        sched.submit(r)
    return {r.uid: r for r in sched.run_until_empty()}, sched


def test_deferred_backlog_wakes_on_a_used_engines_clock():
    """Deferred requests on engines whose clock read 0.0542... at the
    fleet's epoch: the reference fast-forwards the clock by the gap to the
    wake-up, which rounds 5e-18 short of it and then adds nothing, and
    livelocks (ROADMAP queue C); the port lands on the wake-up and serves
    every request with the fault-free streams."""
    args = (1e-12, {"policy": "defer", "defer_s": 0.01, "max_defers": 2},
            {}, 0.054279241575537346)
    with pytest.raises(RuntimeError, match="livelock"):
        _admission(REF, *args)
    results, sched = _admission(PORT, *args)
    check_chaos(67, 4, results, sched)


# ---------------------------------------------------------------------------
# the reference's chaos properties, on the port
# ---------------------------------------------------------------------------


def check_chaos(seed: int, n: int, results: dict, sched,
                allow_non_ok: bool = False) -> tuple:
    """Exactly once, provenance, streams equal to the fault-free run and
    the ledger after a (possibly faulty) port fleet run."""
    rep, log = sched.report(), sched.request_log
    assert sorted(log) == list(range(n))
    assert sorted(results) == sorted(u for u, d in log.items()
                                     if d["status"] == "ok")
    if not allow_non_ok:
        assert all(d["status"] == "ok" for d in log.values())
    for uid in results:
        assert log[uid]["engine"] == sched.routed_to[uid]
    streams, _ = reference_streams(PORT, seed, n)
    for uid, r in results.items():
        assert list(r.tokens) == streams[uid], uid
    ledger = sum(e["engine"]["energy_j"] + e["gap_idle_j"]
                 for e in rep["engines"].values())
    np.testing.assert_allclose(rep["fleet_energy_j"], ledger, rtol=1e-9)
    assert rep["fleet_energy_j"] >= sum(
        r.energy_j for r in results.values()) - 1e-9
    assert rep["faults"]["lost_energy_j"] >= 0.0
    return rep, log


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16 - 1), n=st.integers(2, 6),
       slo=st.sampled_from([0.5, None]),
       plan_seed=st.integers(0, 2**16 - 1),
       kinds=st.sampled_from([("crash", "stall"),
                              ("crash", "stall", "artifact_corruption")]))
def test_chaos_invariants(seed, n, slo, plan_seed, kinds):
    _, horizon = reference_streams(PORT, seed, n)
    plan = FaultPlan.random(["v5e", "ada"], plan_seed,
                            horizon_s=max(horizon, 1e-6), kinds=kinds)
    engines = {"v5e": make_engine(PORT, "tpu_v5e"),
               "ada": make_engine(PORT, "rtx4070")}
    sched = make_fleet(PORT, slo, engines=engines, fault_plan=plan)
    for r in workload(PORT, seed, n):
        sched.submit(r)
    results = {r.uid: r for r in sched.run_until_empty()}
    check_chaos(seed, n, results, sched)


def test_replays_are_append_only():
    """Requests replayed after a crash that lost the device state re-emit
    what had streamed before it, and pay the lost attempt as lost energy
    on the failed member."""
    seed, n = 13, 6
    sched = make_fleet(PORT, 0.5)
    for r in workload(PORT, seed, n):
        sched.submit(r)
    results = {r.uid: r for r in _step_until_resident(sched, "ada")}
    sched._fail_member(sched.members["ada"], evict=False, state_lost=True)
    emitted = {rec["req"].uid: list(rec["tokens"]) for rec in sched._recovery}
    assert any(emitted.values())
    results.update({r.uid: r for r in sched.run_until_empty()})
    rep, log = check_chaos(seed, n, results, sched)
    assert rep["faults"]["lost_energy_j"] > 0.0
    assert rep["engines"]["ada"]["engine"]["lost_energy_j"] > 0.0
    for uid, prefix in emitted.items():
        assert list(results[uid].tokens)[:len(prefix)] == prefix
        assert log[uid]["retries"] >= 1


def test_checkpoint_adopt_roundtrip_engine_level():
    """Rows checkpointed mid-decode and adopted by a compatible engine
    (the rest replayed there) give the fault-free streams; the failed
    engine is left empty, and its checkpointed rows are clones."""
    seed, n = 41, 4
    streams, _ = reference_streams(PORT, seed, n)
    src = make_engine(PORT)
    for r in workload(PORT, seed, n):
        src.submit(r)
    done = []
    while src.has_work:
        done.extend(src.serve_step())
        lv = src._live
        if lv is not None and any(s is not None for s in lv.slots):
            break
    live_state = src._live.batch_state
    records = src.checkpoint_inflight()
    assert not src.has_work and records and src.lane_view["in_flight"] == 0
    dst = make_engine(PORT, max_batch=4)
    assert dst.state_compatible(src)
    for rec in records:
        if rec["state"] is not None:
            for leaf in (rec["state"]["index"], rec["state"]["kv"]["k"]):
                assert not any(leaf.data_ptr() == t.data_ptr() for t in (
                    live_state["index"], live_state["kv"]["k"]))
            dst.adopt(rec)
        else:
            rec["req"].replay = list(rec["tokens"]) or None
            dst.submit(rec["req"])
    while dst.has_work:
        done.extend(dst.serve_step())
    assert {r.uid: list(r.tokens) for r in done} == streams
    assert dst.report()["adopted_in"] == sum(
        rec["state"] is not None for rec in records)


def test_state_compatible_and_adopt_refusals():
    eng = make_engine(PORT)
    assert eng.state_compatible(make_engine(PORT, "rtx4070"))
    assert not eng.state_compatible(make_engine(PORT, seed=1))
    assert not eng.state_compatible(make_engine(PORT, max_len=32))
    paged = make_engine(PORT, kv_layout="paged", page_size=8)
    assert not eng.state_compatible(paged)
    with pytest.raises(ValueError, match="replay"):
        eng.adopt({"req": None, "tokens": [1], "state": None})
    row = make_engine(PORT, max_len=32)._init_state(1)
    with pytest.raises(ValueError, match="incompatible"):
        eng.adopt({"req": None, "tokens": [1], "state": row})
    with pytest.raises(ValueError, match="dense"):
        paged.adopt({"req": None, "tokens": [1],
                     "state": paged._init_state(1)})


def test_state_structures_match():
    eng = make_engine(PORT)
    one = eng._init_state(1)
    assert L.state_structures_match(one, eng.model.init_state(
        eng.cfg, 1, eng.max_len, device="meta"))
    assert not L.state_structures_match(one, eng._init_state(2))
    assert not L.state_structures_match(one, {"kv": one["kv"]})
    assert not L.state_structures_match(
        one, {**one, "index": one["index"].int()})


def test_replay_prefix_continues_stream_engine_level():
    prompt = np.arange(10, dtype=np.int32)
    ref_eng = make_engine(PORT)
    ref_eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    (ref_r,) = ref_eng.run_until_empty()
    ref = list(ref_r.tokens)
    for k in (1, 2, 6):
        eng = make_engine(PORT)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6,
                           replay=ref[:k]))
        out = []
        while eng.has_work:
            out.extend(eng.serve_step())
        assert [list(r.tokens) for r in out] == [ref], k


def test_sampled_replay_burns_the_failed_attempts_draws():
    """A sampled (non-greedy) request replayed with its first tokens draws
    its later tokens from where its Gumbel stream left off."""
    prompt = np.arange(12, dtype=np.int32)
    eng = make_engine(PORT, greedy=False, seed=3)
    eng.submit(Request(uid=5, prompt=prompt, max_new_tokens=8))
    (ref,) = eng.run_until_empty()
    again = make_engine(PORT, greedy=False, seed=3)
    again.submit(Request(uid=5, prompt=prompt, max_new_tokens=8,
                         replay=list(ref.tokens[:3])))
    (out,) = again.run_until_empty()
    assert list(out.tokens) == list(ref.tokens)


@pytest.mark.parametrize("kw,run", [({"mode": "wave"}, "run_wave"),
                                    ({"admission": "serial"},
                                     "run_until_empty"),
                                    ({"kv_layout": "paged", "page_size": 8},
                                     "run_until_empty")])
def test_replay_rejected_off_the_chunked_dense_path(kw, run):
    req = workload(PORT, 53, 1)[0]
    req.replay = [1, 2]
    eng = make_engine(PORT, **kw)
    eng.submit(req)
    with pytest.raises(ValueError, match="replay"):
        getattr(eng, run)()


def test_retune_degrades_to_the_baseline_and_launches_nothing_new():
    """On an `ArtifactError` a reference chip's member prices at the
    reference's BASELINE (so its step estimates equal the JAX engine's
    degraded ones) and an h100 member at `plan`'s tiles; neither installs
    a winner."""
    ops._TUNED.clear()
    peng, jeng = make_engine(PORT), make_engine(REF)
    assert not peng.retune(_inject=ArtifactError("chaos: corrupt artifact"))
    assert not jeng.retune(_inject=JArtifactError("chaos: corrupt artifact"))
    assert REFERENCE_BASELINE.as_tuple() == JBASELINE.as_tuple()
    assert set(peng.pretuned.values()) == {REFERENCE_BASELINE}
    assert sorted(peng.pretuned) == sorted(jeng.pretuned)
    for est in ("decode_step_estimate", "fused_step_estimate"):
        args = () if est.startswith("decode") else (2, 16)
        pe, je = getattr(peng, est)(*args), getattr(jeng, est)(*args)
        np.testing.assert_allclose(pe.energy_j, je.energy_j, rtol=1e-9)
        np.testing.assert_allclose(pe.step_s, je.step_s, rtol=1e-9)
    rep = peng.report()
    assert rep["tuning_degraded"] and "corrupt" in rep[
        "tuning_degraded_reason"]
    card = make_engine(PORT, "h100")
    before = card.fused_step_estimate(2, 16).energy_j
    assert not card.retune(_inject=ArtifactError("corrupt"))
    assert all(t.as_tuple() == default_tile(*s, "h100", "float32")
               for s, t in card.pretuned.items())
    assert card.fused_step_estimate(2, 16).energy_j == before
    assert not ops._TUNED


def test_retune_raises_what_is_not_an_artifact_error():
    eng = make_engine(PORT)
    with pytest.raises(RuntimeError):
        eng.retune(_inject=RuntimeError("not an artifact"))
    assert not eng.tuning_degraded


def test_retune_success_installs_the_active_chips_winners(monkeypatch):
    """A successful retune prices at the winners and launches the tuned
    objective's; it goes through `warm_gemm_cache(strict=True)`."""
    calls = []

    def fake(shapes, **kw):
        calls.append(kw)
        return {s: ops.BlockConfig(8, 128, 128) for s in shapes}

    monkeypatch.setattr(ops, "warm_gemm_cache", fake)
    eng = make_engine(PORT, "h100")
    eng.retune(_inject=ArtifactError("corrupt"))
    assert eng.retune(objective="energy")
    assert calls == [{"dtype": "float32", "objective": "energy",
                      "chip": "h100", "rank_mode": "auto", "strict": True}]
    assert not eng.tuning_degraded and eng.tune_objective == "energy"
    assert set(eng.pretuned.values()) == {ops.BlockConfig(8, 128, 128)}


def test_baseline_configs_per_chip():
    shapes = [(4, 512, 3584), (512, 3584, 18944)]
    assert baseline_configs(shapes, "rtx4070") == {
        s: REFERENCE_BASELINE for s in shapes}
    card = baseline_configs(shapes, "h100")
    assert [t.as_tuple() for t in card.values()] == [
        default_tile(*s, "h100") for s in shapes]


# ---------------------------------------------------------------------------
# page-pool pressure
# ---------------------------------------------------------------------------


def test_page_pressure_squeeze_unsqueeze():
    alloc = PageAllocator(8, 4)
    assert alloc.squeeze(3) == 3 and alloc.free_pages == 4
    assert alloc.squeeze(100) == 4 and alloc.free_pages == 0
    assert alloc.unsqueeze() == 7 and alloc.free_pages == 7
    assert alloc.stats["squeezed"] == 0


def test_page_pressure_requires_paged_engine():
    eng = make_engine(PORT)
    with pytest.raises(ValueError, match="paged"):
        eng.inject_page_pressure(2)
    with pytest.raises(ValueError, match="paged"):
        eng.release_page_pressure()
    paged = make_engine(PORT, kv_layout="paged", page_size=8)
    assert paged.inject_page_pressure(2) == 2
    assert paged.release_page_pressure() == 2


def _pressured(side, seed: int, n: int, num_pages: int, squeeze: int):
    """A paged engine serving the workload in two halves, `squeeze` pages
    out of its pool for the first."""
    eng = make_engine(side, kv_layout="paged", page_size=8,
                      num_pages=num_pages)
    reqs = workload(side, seed, n)
    taken = eng.inject_page_pressure(squeeze)
    out = {}
    for part in (reqs[:n // 2], reqs[n // 2:]):
        for r in part:
            eng.submit(r)
        out.update({r.uid: list(r.tokens) for r in eng.run_until_empty()})
        if taken:
            assert eng.release_page_pressure() == taken
            taken = 0
    return out, eng.report()["paging"]


def test_page_pressure_matches_the_reference():
    """Streams and every allocator counter equal the JAX engine's under
    the same squeeze."""
    ref, port = both(lambda side: _pressured(side, 29, 6, 25, 12))
    assert port == ref


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16 - 1), n=st.integers(2, 6),
       squeeze=st.integers(0, 15))
def test_page_pressure_keeps_streams_and_returns_pages(seed, n, squeeze):
    """Under any squeeze that leaves room for one request, streams are the
    dense layout's, and once released every page but the registry's is
    free again."""
    streams, pg = _pressured(PORT, seed, n, 25, squeeze)
    want, _ = reference_streams(PORT, seed, n)
    assert streams == want
    assert pg["squeezed"] == 0
    assert pg["pages_in_use"] == pg["registry_entries"]
