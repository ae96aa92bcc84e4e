"""The port engine's energy attribution and model clock against the JAX
engine's, on the CPU.

Both engines serve the qwen2-7b smoke config with the same weights
(through `bridge.params_from_numpy`) and price on the TPU v5e, where the
port's energy model matches the reference's: every request's energy,
prefill share, J/token and model-clock TTFT, and the engine report's model
seconds and joules, agree to 1e-9 relative. Further tests pin the port's
deliberate differences: it prices on the "h100" by default, a failing
energy model raises, and an engine tuned for an objective launches that
objective's winners.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.kernels.tiled_matmul import BlockConfig as JBlockConfig
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.core import energy
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import BlockConfig
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import gemm_shape_counts
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

RTOL = 1e-9
REPORT_KEYS = ("model_s", "model_tokens_per_s", "energy_j",
               "attributed_energy_j", "idle_energy_j", "j_per_token")


@pytest.fixture(scope="module")
def served():
    """(port (cfg, api, params), jax (cfg, api, params))."""
    jcfg = jget_config("qwen2-7b", smoke=True)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = get_config("qwen2-7b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


def workload(n=9, seed=0, vocab=256, lo=4, hi=40):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, rng.integers(lo, hi)).astype(np.int32),
             int(rng.choice([1, 4, 8, 16]))) for uid in range(n)]


def engines(served, **kw):
    """(port engine, JAX engine) on the same config, weights and knobs."""
    (cfg, api, params), (jcfg, japi, jparams) = served
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    return (ServingEngine(api, params, cfg, device="cpu", **kw),
            JServingEngine(japi, jparams, jcfg, mode="continuous", **kw))


def serve(eng, reqs, request_cls):
    for uid, p, mnt in reqs:
        eng.submit(request_cls(uid=uid, prompt=p.copy(), max_new_tokens=mnt))
    return {r.uid: r for r in eng.run_until_empty()}


def _rel(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


def _tiles(shapes, block) -> dict:
    """A seeded tuned-tile map over the shapes, in either package's
    BlockConfig."""
    rng = np.random.default_rng(5)
    tiles = [(8, 128, 128), (32, 256, 512), (64, 512, 256)]
    return {s: block(*tiles[int(rng.integers(len(tiles)))])
            for s in sorted(shapes)}


@pytest.mark.parametrize("tuned", (False, True))
@pytest.mark.parametrize("greedy,seed", [(True, 0), (False, 7)])
def test_energy_and_model_clock_match_the_jax_engine(served, greedy, seed,
                                                     tuned):
    """A 9-request workload over 2 slots and multi-chunk prompts: every
    request's joules, prefill share, J/token and model-clock TTFT, and the
    report's model seconds and joules, equal the JAX engine's; `tuned`
    prices both at the same installed tiles."""
    peng, jeng = engines(served, chip="tpu_v5e", greedy=greedy, seed=seed)
    if tuned:
        fleet = ops.serving_gemm_fleet(peng.cfg, max_batch=2, max_len=64,
                                       chunk_tokens=16, lane_width=4)
        peng.pretuned = _tiles(fleet, BlockConfig)
        jeng.pretuned = _tiles(fleet, JBlockConfig)
    reqs = workload(seed=seed)
    got, want = serve(peng, reqs, Request), serve(jeng, reqs, JRequest)
    assert sorted(got) == sorted(want)
    dec_j = jeng.decode_step_estimate().energy_j
    for uid, w in want.items():
        g = got[uid]
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.steps == w.steps
        _rel(g.energy_j, w.energy_j)
        _rel(g.energy_per_token_j, w.energy_per_token_j)
        _rel(g.ttft_model_s, w.ttft_model_s)
        _rel(g.prefill_energy_j,
             w.energy_j - w.steps * dec_j / jeng.max_batch)
        assert g.energy_j > 0 and g.ttft_model_s > 0
    prep, jrep = peng.report(), jeng.report()
    for key in REPORT_KEYS:
        _rel(prep[key], jrep[key])
    assert peng.model_clock_s == pytest.approx(jeng.model_clock_s, rel=RTOL)
    _rel(prep["energy_j"],
         sum(r.energy_j for r in got.values()) + prep["idle_energy_j"])


def test_step_estimates_match_the_jax_engine(served):
    peng, jeng = engines(served, chip="tpu_v5e", max_batch=4)
    _rel(list(peng.decode_step_estimate().as_row().values())[1:],
         list(jeng.decode_step_estimate().as_row().values())[1:])
    for w, c in ((1, 8), (4, 16), (8, 64)):
        got = peng.fused_step_estimate(w, c).as_row()
        want = jeng.fused_step_estimate(w, c).as_row()
        assert got.pop("name") == want.pop("name")
        _rel(list(got.values()), list(want.values()))
    assert peng.idle_power_w == jeng.idle_power_w


def test_model_clock_advances_per_dispatched_call(served):
    """Every chunk call and decode step advances the model clock by its
    predicted time; requests submitted later stamp the later clock."""
    peng, _ = engines(served, chip="tpu_v5e")
    serve(peng, workload(n=3), Request)
    rep = peng.report()
    dec_s = peng.decode_step_estimate().step_s
    assert rep["model_s"] == pytest.approx(peng.model_clock_s, rel=1e-12)
    assert rep["model_s"] > rep["decode_steps"] * dec_s > 0
    assert rep["model_tokens_per_s"] == pytest.approx(
        rep["generated_tokens"] / rep["model_s"])
    req = Request(uid=99, prompt=np.arange(5, dtype=np.int32),
                  max_new_tokens=2)
    peng.submit(req)
    assert req.submit_model_s == peng.model_clock_s > 0
    res = peng.run_until_empty()[0]
    assert res.ttft_model_s == pytest.approx(
        peng._chunk_cost(1, 8)[1], rel=1e-12)


def test_default_chip_prices_the_h100(served):
    peng, _ = engines(served)
    assert peng.chip is None and peng.chip_spec.name == "h100"
    cfg = peng.cfg
    want = energy.gemm_fleet_energy(
        gemm_shape_counts(cfg, 2), chip="h100", dtype=cfg.activation_dtype,
        extra_hbm_bytes=peng._kv_gather_bytes(2),
        name=f"{cfg.name}:('decode', 2)")
    assert peng.decode_step_estimate() == want
    assert peng.idle_power_w == 70.0
    got = serve(peng, workload(n=2), Request)
    assert all(r.energy_j > 0 for r in got.values())


def test_a_failing_energy_model_raises(served, monkeypatch):
    """The JAX engine warns and reads its telemetry as zeros; the port
    raises."""
    def broken(*a, **kw):
        raise RuntimeError("energy model down")

    monkeypatch.setattr(energy, "gemm_fleet_energy", broken)
    peng, _ = engines(served)
    peng.submit(Request(uid=0, prompt=np.arange(6, dtype=np.int32),
                        max_new_tokens=2))
    with pytest.raises(RuntimeError, match="energy model down"):
        peng.run_until_empty()


def test_step_energy_estimates_scale_with_rows(served):
    """The counterpart of the JAX engine test of the same name."""
    cfg = served[0][0]
    small = energy.gemm_fleet_energy(gemm_shape_counts(cfg, 8),
                                     chip="tpu_v5e", dtype="bfloat16")
    big = energy.gemm_fleet_energy(gemm_shape_counts(cfg, 4096),
                                   chip="tpu_v5e", dtype="bfloat16")
    assert big.energy_j > small.energy_j > 0
    assert big.step_s > small.step_s > 0
    assert small.power_w <= big.power_w or small.power_w > 0


@pytest.mark.parametrize("objective", ("runtime", "energy"))
def test_engine_launches_its_objectives_winners(served, objective,
                                                monkeypatch):
    """Winners installed for each objective: the engine's projections take
    those of its `tune_objective`, and the launch switch is undone after
    each call."""
    peng, _ = engines(served, tune_objective=objective)
    cfg = peng.cfg
    assert cfg.activation_dtype == "float32"
    fleet = ops.serving_gemm_fleet(cfg, max_batch=2, max_len=64,
                                   chunk_tokens=16, lane_width=4)
    tiles = {"runtime": BlockConfig(64, 64, 32),
             "energy": BlockConfig(8, 64, 64)}
    seen = []
    real = ops.tiled_matmul

    def recording(a, b, c=None, **kw):
        seen.append(kw.get("config"))
        return real(a, b, c, **kw)

    monkeypatch.setattr(ops, "tiled_matmul", recording)
    import torch

    try:
        for (m, n, k) in fleet:
            for obj, tile in tiles.items():
                ops._TUNED[(m, n, k, torch.float32, obj)] = tile
        serve(peng, workload(n=2), Request)
    finally:
        ops._TUNED.clear()
    assert seen and all(c == tiles[objective] for c in seen)
    assert ops._OBJECTIVE == "runtime"
