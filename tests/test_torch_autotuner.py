"""The port's autotuner, `ops` tuning hooks and pretuned engine against the
JAX package's, on the CPU.

On the reference's chips the port enumerates the same candidates, ranks
them with the same predictor bits and verifies them on the same simulator,
so `tune_many` must pick the same winners. The port's in-graph ranking (a
torch feature grid and scorer on the tuner's device) must pick what its
trace-time ranking picks. On the H100 the candidates are the compiled tiles
`plan` accepts and the verification is the card's; here a stand-in runner
takes the card's place.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import autotuner as jautotuner
from repro.core import predictor as jpredictor
from repro.core import profiler as jprofiler
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.core import autotuner, predictor, profiler
from repro_torch.core.hwsim import GemmConfig, TpuGemmSimulator, telemetry_row
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG, TILE_PATHS,
                                              BlockConfig, candidate_tiles,
                                              plan)
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

REF_CHIPS = ("tpu_v5e", "rtx4070")
SHAPES = [(1024, 1024, 1024), (16, 2048, 2048), (4096, 4096, 1024),
          (333, 777, 1234), (4, 3584, 18944), (512, 152064, 3584)]
H100_SHAPES = [(4, 512, 3584), (8, 152064, 3584), (64, 18944, 3584),
               (128, 18944, 3584), (512, 3584, 18944), (2048, 3584, 3584),
               (33, 200, 296), (5, 100, 300)]


@pytest.fixture(scope="module")
def preds(tmp_path_factory):
    """{chip: (port predictor, JAX predictor)}: on the reference's chips
    one artifact, fitted by the JAX package and loaded by both (the port's
    own fit places raw thresholds differently; see test_torch_mlperf); on
    the H100 a port fit on the simulator's table, with no JAX twin."""
    out = {}
    for chip in REF_CHIPS:
        table = jprofiler.collect_dataset(n_configs=600, seed=0, chip=chip)
        ref = jpredictor.PerfPredictor(model="rf", residual=True, fast=True,
                                       chip=chip).fit(table)
        path = str(tmp_path_factory.mktemp(chip) / "pred.npz")
        ref.save(path)
        out[chip] = (predictor.PerfPredictor.load(path), ref)
    table = profiler.collect_dataset(n_configs=600, seed=0, chip="h100")
    out["h100"] = (predictor.PerfPredictor(model="rf", residual=True,
                                           fast=True, chip="h100").fit(table),
                   None)
    return out


@pytest.fixture
def clean_tuners():
    """Leave no process-wide tuner or installed winner behind."""
    yield
    autotuner.set_tuner(None)
    jautotuner.set_tuner(None)
    ops.force_chip("h100")
    ops._TUNED.clear()


def _fake_card(calls: list):
    """A stand-in for the card's runner: the h100 simulator's noisy
    runtime, and plan's refusal for tiles that cannot take the config."""
    sim = TpuGemmSimulator(chip="h100", seed=1)

    def factory(*, device="cuda", reps=5):
        def measure(cfg):
            calls.append(cfg)
            return dataclasses.replace(
                telemetry_row(sim.measure_batch([cfg]), 0),
                valid=True)

        measure.power_source = "model"
        return measure

    return factory


def _tuple(cfgs):
    return [c.as_tuple() for c in cfgs]


@pytest.mark.parametrize("objective", ("runtime", "energy", "edp"))
@pytest.mark.parametrize("chip", REF_CHIPS)
def test_tune_many_winners_equal_the_reference(chip, objective, preds):
    port, ref = preds[chip]
    t = autotuner.GemmAutotuner(port, chip=chip, scorer="numpy",
                                device="cpu")
    j = jautotuner.GemmAutotuner(ref, chip=chip, scorer="numpy")
    assert t.artifact_fingerprint == j.artifact_fingerprint
    got = t.tune_many(SHAPES, objective=objective, rank_mode="trace")
    want = j.tune_many(SHAPES, objective=objective, rank_mode="trace")
    assert _tuple(got) == _tuple(want)
    for m, n, k in SHAPES[:2]:
        assert ([c.key() for c in t.candidate_configs(m, n, k)]
                == [c.key() for c in j.candidate_configs(m, n, k)])


@pytest.mark.parametrize("chip", REF_CHIPS + ("h100",))
def test_graph_ranking_equals_trace_ranking(chip, preds):
    port, _ = preds[chip]
    shapes = H100_SHAPES if chip == "h100" else SHAPES
    tuner = autotuner.GemmAutotuner(port, chip=chip, device="cpu")
    for objective in ("runtime", "power", "edp"):
        tops, scores = tuner.rank_in_graph(shapes, objective=objective,
                                           top_k=3)
        for (m, n, k), top in zip(shapes, tops):
            cfgs, X = tuner.candidate_table(m, n, k, "bf16")
            order = tuner.rank(cfgs, objective=objective, features=X)
            assert top == [cfgs[i] for i in order[:3]]
        assert scores.shape == (len(shapes), 3)
    # the float32 scorer ranks the same grid approximately: its winner is
    # among the float64 ranking's top 3
    tops64, _ = tuner.rank_in_graph(shapes, top_k=3)
    tops32, _ = tuner.rank_in_graph(shapes, top_k=3, x64=False)
    for t32, t64 in zip(tops32, tops64):
        assert t32 and t32[0] in t64
    # each tuner verifies on its own runner, seeded alike
    graph = autotuner.GemmAutotuner(port, chip=chip, device="cpu")
    trace = autotuner.GemmAutotuner(port, chip=chip, device="cpu")
    assert (_tuple(graph.tune_many(
                shapes, rank_mode="graph",
                measure_fn=profiler.measure_many(_fake_card([])())))
            == _tuple(trace.tune_many(
                shapes, rank_mode="trace",
                measure_fn=profiler.measure_many(_fake_card([])()))))


def test_h100_candidates_are_the_compiled_tiles_plan_accepts():
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    for m in (1, 4, 8, 9, 16, 33, 64, 65, 128, 512, 4096):
        for n, k in ((3584, 3584), (200, 296), (100, 300), (152064, 3584)):
            for dtype in ("bf16", "f32"):
                tiles = autotuner.h100_candidate_tiles(m, n, k, dtype)
                fast = dtype == "bf16" and n % 8 == 0 and k % 8 == 0
                want = [DEFAULT_CONFIG] + (candidate_tiles(m) if fast else [])
                assert tiles == [t.as_tuple() for t in want], (m, n, k, dtype)
                for t in tiles:   # plan takes every one
                    plan(m, n, k, (k, 1), (n, 1), 0, 0, dts[dtype],
                         dts[dtype], config=BlockConfig(*t))
    tuner = autotuner.GemmAutotuner.__new__(autotuner.GemmAutotuner)
    tuner.chip = autotuner.H100
    cfgs = tuner.candidate_configs(64, 3584, 3584, "bfloat16")
    assert [(c.block_m, c.block_n, c.block_k, c.stages) for c in cfgs] == [
        (64, 64, 32, 2), (64, 64, 64, 4), (128, 256, 64, 4),
        (128, 128, 64, 4), (128, 64, 64, 4)]
    assert autotuner.h100_candidate_tiles(64, 64, 64, "int8") == []


def test_measure_fn_is_called_once_with_the_flat_top_k(preds):
    port, _ = preds["h100"]
    tuner = autotuner.GemmAutotuner(port, chip="h100", device="cpu",
                                    verify_top_k=3)
    calls = []

    def measure(cfgs):
        calls.append(list(cfgs))
        # the last candidate of each shape's top-k is the fastest
        rt = np.array([1.0 if i % 3 < 2 else 0.5 for i in range(len(cfgs))])
        return {"runtime_ms": rt, "power_w": rt, "energy_j": rt}

    shapes = H100_SHAPES[:5]
    best = tuner.tune_many(shapes, measure_fn=measure)
    assert len(calls) == 1 and len(calls[0]) == 3 * len(shapes)
    for i, (m, n, k) in enumerate(shapes):
        top = calls[0][3 * i:3 * i + 3]
        assert all((c.m, c.n, c.k) == (m, n, k) for c in top)
        assert best[i].as_tuple() == (top[2].block_m, top[2].block_n,
                                      top[2].block_k)
    # winners are cached: a second pass measures nothing
    assert tuner.tune_many(shapes, measure_fn=measure) == best
    assert len(calls) == 1


@pytest.mark.parametrize("objective", ("runtime", "energy", "power", "edp"))
def test_h100_energy_objectives_verify_on_the_power_runner(preds, monkeypatch,
                                                           objective):
    """On the card, every objective but "runtime" verifies with the runner
    that reads power (`card_measure_fn(power=True)`), so those objectives
    rank measured joules; the winner is the measured best, and the sweep
    is kept in `last_verification`."""
    port, _ = preds["h100"]
    made = []
    sim = TpuGemmSimulator(chip="h100", seed=2)

    def factory(*, device="cuda", reps=5, power=False):
        made.append(power)

        def measure(cfg):
            return dataclasses.replace(
                telemetry_row(sim.measure_batch([cfg]), 0), valid=True)

        measure.power_source = "nvml" if power else "model"
        return measure

    monkeypatch.setattr(autotuner, "card_measure_fn", factory)
    tuner = autotuner.GemmAutotuner(port, chip="h100", device="cpu",
                                    verify_top_k=autotuner.H100_VERIFY_TOP_K)
    best = tuner.tune_many(H100_SHAPES, objective=objective)
    tuner.tune_many(H100_SHAPES[:2], objective=objective)    # cached
    assert made == [objective != "runtime"]
    flat, tel = tuner.last_verification
    score = tuner._objective_scores(
        {t: np.asarray(tel[t], dtype=np.float64)
         for t in ("runtime_ms", "power_w", "energy_j")}, objective)
    for (m, n, k), won in zip(H100_SHAPES, best):
        mine = [i for i, c in enumerate(flat) if (c.m, c.n, c.k) == (m, n, k)]
        assert len(mine) == len(autotuner.h100_candidate_tiles(m, n, k))
        i = min(mine, key=lambda j: score[j])
        assert won.as_tuple() == (flat[i].block_m, flat[i].block_n,
                                  flat[i].block_k)


def test_h100_verification_runs_on_the_card_runner(preds, monkeypatch):
    port, _ = preds["h100"]
    calls: list = []
    monkeypatch.setattr(autotuner, "card_measure_fn", _fake_card(calls))
    tuner = autotuner.GemmAutotuner(port, chip="h100", device="cpu",
                                    verify_top_k=2)
    best = tuner.tune_many(H100_SHAPES)
    assert len(calls) == sum(
        min(2, len(autotuner.h100_candidate_tiles(*s))) for s in H100_SHAPES)
    assert (5, 100, 300) in H100_SHAPES   # one shape with the general only
    for (m, n, k), cfg in zip(H100_SHAPES, best):
        assert cfg.as_tuple() in autotuner.h100_candidate_tiles(m, n, k)
        assert TILE_PATHS[cfg.as_tuple()]


def test_h100_tuner_times_every_candidate(preds, tmp_path, monkeypatch,
                                         clean_tuners):
    """The process-wide H100 tuner verifies all of a shape's candidates,
    `plan`'s own tile among them, so its winner on the card can never be
    slower than the rule's whatever the forest ranks first."""
    port, _ = preds["h100"]
    port.save(str(tmp_path / "perf_predictor_h100.npz"))
    calls: list = []
    monkeypatch.setattr(autotuner, "card_measure_fn", _fake_card(calls))
    tuner = autotuner.get_tuner(str(tmp_path), chip="h100", device="cpu")
    assert tuner.verify_top_k == autotuner.H100_VERIFY_TOP_K == 5
    fleet = ops.serving_gemm_fleet(get_config("qwen2-7b"), max_batch=4,
                                   max_len=512, chunk_tokens=64, lane_width=8)
    tuner.tune_many(fleet)
    per_shape = [autotuner.h100_candidate_tiles(*s) for s in fleet]
    assert max(map(len, per_shape)) == autotuner.H100_VERIFY_TOP_K
    assert len(calls) == sum(map(len, per_shape))
    timed = {(c.m, c.n, c.k, c.block_m, c.block_n, c.block_k) for c in calls}
    for m, n, k in fleet:
        rule = plan(m, n, k, (k, 1), (n, 1), 0, 0, torch.bfloat16,
                    torch.bfloat16).tile.as_tuple()
        assert (m, n, k, *rule) in timed, (m, n, k, rule)


def test_installed_winners_reach_matmul(preds, monkeypatch, clean_tuners):
    port, _ = preds["h100"]
    monkeypatch.setattr(autotuner, "card_measure_fn", _fake_card([]))
    tuner = autotuner.GemmAutotuner(port, chip="h100", device="cpu")
    autotuner.set_tuner(tuner)
    shapes = [(4, 96, 64), (24, 64, 40)]
    won = ops.warm_gemm_cache(shapes, strict=True)
    assert sorted(won) == sorted(shapes)
    seen = []

    def recording(a, b, c=None, **kw):
        seen.append(kw.get("config"))
        return b.new_zeros((a.shape[0], b.shape[0] if kw.get("transpose_b")
                            else b.shape[1]))

    monkeypatch.setattr(ops, "tiled_matmul", recording)
    x = torch.zeros(2, 2, 64, dtype=torch.bfloat16)
    ops.matmul(x, torch.zeros(64, 96, dtype=torch.bfloat16))
    ops.matmul(torch.zeros(24, 40, dtype=torch.bfloat16),
               torch.zeros(40, 64, dtype=torch.bfloat16))
    ops.matmul(x, torch.zeros(64, 32, dtype=torch.bfloat16))  # untuned
    ops.matmul(x, torch.zeros(96, 64, dtype=torch.bfloat16),
               transpose_b=True)                     # tuned on "nn" only
    ops.matmul(x.float(), torch.zeros(64, 96))      # another dtype
    ops.matmul(x, torch.zeros(64, 96, dtype=torch.bfloat16),
               objective="energy")                   # another objective
    assert seen == [won[(4, 96, 64)], won[(24, 64, 40)], None, None, None,
                    None]
    assert ops._tuned_config(4, 96, 64, torch.bfloat16) == won[(4, 96, 64)]
    # another chip's winners are returned but not installed
    ops.warm_gemm_cache([(8, 8, 8)], chip="tpu_v5e")
    assert ops._tuned_config(8, 8, 8, torch.bfloat16) is None
    ops.force_chip("rtx4070")
    assert ops._tuned_config(4, 96, 64, torch.bfloat16) is None


def test_warm_gemm_cache_strict_raises_on_a_corrupt_artifact(
        preds, tmp_path, monkeypatch, clean_tuners):
    port, _ = preds["tpu_v5e"]
    path = str(tmp_path / "perf_predictor_tpu_v5e.npz")
    port.save(path)
    with np.load(path, allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    state["model/value"] = state["model/value"] * 2.0
    np.savez(path, **state)

    def get_tuner(chip, **kw):
        return autotuner.GemmAutotuner(predictor.PerfPredictor.load(path),
                                       chip=chip, device="cpu")

    monkeypatch.setattr(autotuner, "get_tuner", get_tuner)
    with pytest.raises(predictor.ArtifactError, match="fingerprint"):
        ops.warm_gemm_cache(SHAPES, chip="tpu_v5e", strict=True)
    assert ops.warm_gemm_cache(SHAPES, chip="tpu_v5e") == {}
    with pytest.raises(ValueError, match="rank_mode"):
        ops.warm_gemm_cache(SHAPES, rank_mode="bogus")


def test_tuner_entry_points_default_to_the_card(preds, clean_tuners):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    port, _ = preds["tpu_v5e"]
    with pytest.raises(RuntimeError, match="GPU"):
        autotuner.GemmAutotuner(port, chip="tpu_v5e")
    autotuner.set_tuner(None)
    with pytest.raises(RuntimeError, match="GPU"):
        autotuner.get_tuner(chip="tpu_v5e")
    assert autotuner.GemmAutotuner(port, chip="tpu_v5e",
                                   device="cpu").scorer == "auto"
    assert not autotuner.GemmAutotuner(
        port, chip="tpu_v5e", device="cpu")._use_torch_scorer()


def test_tune_report_prices_against_the_general_tile(preds):
    port, _ = preds["h100"]
    tuner = autotuner.GemmAutotuner(port, chip="h100", device="cpu")
    tuner._cache_put(tuner._key(128, 18944, 3584, "bf16", "runtime"),
                     (128, 256, 64))
    rep = tuner.tune_report(128, 18944, 3584)
    assert rep["baseline"] == autotuner.BASELINE.as_tuple() == (64, 64, 32)
    assert rep["best"] == (128, 256, 64) and rep["chip"] == "h100"
    assert rep["speedup"] == pytest.approx(
        rep["baseline_runtime_ms"] / rep["tuned_runtime_ms"])


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("qwen2-7b", smoke=True)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = get_config("qwen2-7b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


def test_pretuned_engine_equals_the_jax_engine(served, preds, clean_tuners):
    """Both engines pretune their fleet on the same predictor (tpu_v5e,
    the chip the JAX engine tunes for): the same shapes and winners, and
    the same token streams."""
    port, ref = preds["tpu_v5e"]
    autotuner.set_tuner(autotuner.GemmAutotuner(port, chip="tpu_v5e",
                                                device="cpu"))
    jautotuner.set_tuner(jautotuner.GemmAutotuner(ref, chip="tpu_v5e"))
    (cfg, api, params), (jcfg, japi, jparams) = served
    kw = dict(max_batch=2, max_len=64, chunk_tokens=16, pretune=True,
              chip="tpu_v5e")
    eng = ServingEngine(api, params, cfg, device="cpu", **kw)
    jeng = JServingEngine(japi, jparams, jcfg, mode="continuous", **kw)
    assert sorted(eng.pretuned) == sorted(jeng.pretuned)
    assert sorted(eng.pretuned) == ops.serving_gemm_fleet(
        cfg, max_batch=2, max_len=64, chunk_tokens=16, lane_width=4)
    assert ({s: c.as_tuple() for s, c in eng.pretuned.items()}
            == {s: c.as_tuple() for s, c in jeng.pretuned.items()})
    rng = np.random.default_rng(0)
    reqs = [(uid, rng.integers(0, 256, rng.integers(4, 30)).astype(np.int32),
             int(rng.choice([4, 8]))) for uid in range(6)]
    got, want = {}, {}
    for e, cls, out in ((eng, Request, got), (jeng, JRequest, want)):
        for uid, p, mnt in reqs:
            e.submit(cls(uid=uid, prompt=p.copy(), max_new_tokens=mnt))
        out.update({r.uid: r.tokens for r in e.run_until_empty()})
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    with pytest.raises(ValueError, match="unknown chip"):
        ServingEngine(api, params, cfg, device="cpu", chip="bogus")


def test_candidate_configs_are_gemm_configs(preds):
    port, _ = preds["h100"]
    tuner = autotuner.GemmAutotuner(port, chip="h100", device="cpu")
    cfgs, X = tuner.candidate_table(4, 512, 3584, "bfloat16")
    assert all(isinstance(c, GemmConfig) for c in cfgs)
    assert X.shape == (len(cfgs), len(port.feature_names))
