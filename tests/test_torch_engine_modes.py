"""The port engine's other serving modes against the JAX engine's, on the
CPU: the paged KV layout (with and without prefix reuse), serial admission
and the wave loop.

Both engines serve smoke configs with the same weights (through
`bridge.params_from_numpy`). Token streams, per-request step counts, the
engine's step counters and the page allocator's report must be exactly
equal, greedy and seeded. Inside the port the modes agree as in the JAX
package's own tests (`tests/test_paged_kv.py`, `test_serving_engine.py`):
paged equals dense, serial equals chunked, wave equals continuous, with and
without prefix reuse, exactly.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paging import PageCacheFull

COUNTERS = ("requests", "generated_tokens", "decode_steps", "chunk_steps",
            "slot_steps", "resident_slot_steps", "slot_occupancy")

MODES = {
    "paged": dict(kv_layout="paged", page_size=8),
    "paged_no_prefix": dict(kv_layout="paged", page_size=8,
                            prefix_cache=False),
    "serial": dict(admission="serial"),
    "wave": dict(mode="wave"),
}


def _pair(arch: str):
    """(port (cfg, api, params), jax (cfg, api, params)) of a smoke
    config with the same weights."""
    jcfg = jget_config(arch, smoke=True)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = get_config(arch, smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


@pytest.fixture(scope="module")
def served():
    return _pair("qwen2-7b")


def prompt(seed: int, n: int, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def workload(n=9, seed=0, vocab=256):
    """Half the prompts share a 20-token prefix (2.5 pages of 8); budgets
    mixed, some of one token; more requests than slots."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20)
    out = []
    for uid in range(n):
        own = rng.integers(0, vocab, int(rng.integers(3, 20)))
        p = np.concatenate([shared, own]) if uid % 2 == 0 else own
        out.append((uid, p.astype(np.int32), int(rng.choice([1, 4, 8, 16]))))
    return out


def port_engine(served, **kw):
    cfg, api, params = served[0]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    return ServingEngine(api, params, cfg, device="cpu", **kw)


def jax_engine(served, **kw):
    jcfg, japi, jparams = served[1]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    return JServingEngine(japi, jparams, jcfg, **kw)


def serve(eng, reqs, request_cls, waves=(None,)) -> dict:
    """Submit `reqs` in the given splits (each served to completion before
    the next is submitted) and return {uid: Result}."""
    out = {}
    cuts = [0, *[w for w in waves if w is not None], len(reqs)]
    for lo, hi in zip(cuts, cuts[1:]):
        for uid, p, mnt in reqs[lo:hi]:
            eng.submit(request_cls(uid=uid, prompt=p.copy(),
                                   max_new_tokens=mnt))
        out.update({r.uid: r for r in eng.run_until_empty()})
    return out


def assert_same_results(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid {uid}")
        assert (got[uid].steps, got[uid].n_tokens, got[uid].prompt_len) == \
            (want[uid].steps, want[uid].n_tokens, want[uid].prompt_len)


# ---------------------------------------------------------------------------
# every mode against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("greedy,seed", [(True, 0), (False, 7)])
def test_streams_and_counters_equal_jax_engine(served, mode, greedy, seed):
    """The first request runs alone so its prompt is registered before the
    rest arrive (prefix hits on the paged layout)."""
    reqs = workload()
    peng = port_engine(served, greedy=greedy, seed=seed, **MODES[mode])
    jeng = jax_engine(served, greedy=greedy, seed=seed, **MODES[mode])
    got = serve(peng, reqs, Request, waves=(1,))
    want = serve(jeng, reqs, JRequest, waves=(1,))
    assert_same_results(got, want)
    prep, jrep = peng.report(), jeng.report()
    assert {k: prep[k] for k in COUNTERS} == {k: jrep[k] for k in COUNTERS}
    assert prep.get("paging") == jrep.get("paging")
    if mode == "paged":
        assert prep["paging"]["prefix_hits"] > 0


@pytest.mark.parametrize("arch", ["starcoder2-3b", "codeqwen1.5-7b",
                                  "qwen2.5-14b"])
@pytest.mark.parametrize("mode", ["chunked", "paged"])
def test_other_dense_configs_equal_jax_engine(arch, mode):
    """The GELU FFN (starcoder2), multi-head attention (codeqwen) and
    qwen2.5-14b's smoke config, served chunked and paged."""
    pair = _pair(arch)
    kw = MODES["paged"] if mode == "paged" else {}
    reqs = workload(n=5, seed=3)
    got = serve(port_engine(pair, **kw), reqs, Request, waves=(1,))
    want = serve(jax_engine(pair, **kw), reqs, JRequest, waves=(1,))
    assert_same_results(got, want)


def test_page_boundary_prompts_equal_jax_engine(served):
    """Prompts ending exactly on, one before and one past a page boundary,
    a prompt repeated whole (COW fork of its last page) and a 63-token
    prompt filling the row to max_len."""
    shared = prompt(30, 16)
    reqs = [(0, shared, 4), (1, np.concatenate([shared, prompt(31, 7)]), 4),
            (2, np.concatenate([shared, prompt(32, 8)]), 4),
            (3, np.concatenate([shared, prompt(33, 9)]), 4),
            (4, shared.copy(), 6), (5, prompt(34, 63), 8)]
    kw = dict(kv_layout="paged", page_size=8)
    peng, jeng = port_engine(served, **kw), jax_engine(served, **kw)
    got = serve(peng, reqs, Request, waves=(1, 4))
    want = serve(jeng, reqs, JRequest, waves=(1, 4))
    assert_same_results(got, want)
    assert peng.report()["paging"] == jeng.report()["paging"]
    assert peng.report()["paging"]["cow_forks"] > 0


# ---------------------------------------------------------------------------
# the modes agree inside the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunked_dense(served):
    """The port's chunked dense streams of ``workload(seed=5)``, served
    once for the module: every mode of the next test is held to them."""
    return serve(port_engine(served), workload(seed=5), Request, waves=(1,))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_mode_gives_the_chunked_dense_streams(served, chunked_dense,
                                                    mode):
    reqs = workload(seed=5)
    want = chunked_dense
    got = serve(port_engine(served, **MODES[mode]), reqs, Request,
                waves=(1,))
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens)


def test_prefix_reuse_skips_chunks_and_keeps_streams(served):
    """A later request sharing a finished request's 32-token prefix maps
    its pages and prefills only its own tail."""
    shared = prompt(7, 32)
    reqs = [(0, np.concatenate([shared, prompt(8, 8)]), 4),
            (1, np.concatenate([shared, prompt(9, 8)]), 4)]
    dense_eng = port_engine(served)
    dense = serve(dense_eng, reqs, Request, waves=(1,))
    eng = port_engine(served, kv_layout="paged", page_size=8)
    paged = serve(eng, reqs, Request, waves=(1,))
    for uid in dense:
        np.testing.assert_array_equal(paged[uid].tokens, dense[uid].tokens)
    rep = eng.report()
    assert rep["paging"]["prefix_hits"] >= 1
    assert rep["paging"]["prefix_hit_tokens"] >= 32
    assert rep["chunk_steps"] < dense_eng.report()["chunk_steps"]


def test_exhaustion_under_a_full_lane_defers_admission(served):
    """9 usable pages, 2 per request: at most 4 of 6 in flight, the rest
    wait at the head of the queue, every request completes and every page
    returns."""
    eng = port_engine(served, max_len=32, kv_layout="paged", page_size=8,
                      num_pages=10, prefix_cache=False)
    for i in range(6):
        eng.submit(Request(uid=i, prompt=prompt(20 + i, 12),
                           max_new_tokens=4))
    res = eng.run_until_empty()
    assert sorted(r.uid for r in res) == list(range(6))
    assert all(r.n_tokens == 4 for r in res)
    rep = eng.report()["paging"]
    assert rep["peak_in_use"] <= 9
    assert rep["pages_in_use"] == 0


def test_exhaustion_with_nothing_in_flight_raises(served):
    eng = port_engine(served, max_len=32, kv_layout="paged", page_size=8,
                      num_pages=3)
    eng.submit(Request(uid=0, prompt=prompt(0, 24), max_new_tokens=4))
    with pytest.raises(PageCacheFull):
        eng.run_until_empty()


def test_mid_decode_retire_releases_only_its_own_references(served):
    eng = port_engine(served, kv_layout="paged", page_size=8)
    shared = prompt(5, 24)
    eng.submit(Request(uid=0, prompt=np.concatenate([shared, prompt(6, 4)]),
                       max_new_tokens=2))
    eng.run_until_empty()
    eng.submit(Request(uid=1, prompt=np.concatenate([shared, prompt(7, 4)]),
                       max_new_tokens=2))
    eng.submit(Request(uid=2, prompt=np.concatenate([shared, prompt(8, 4)]),
                       max_new_tokens=12))
    res = eng.run_until_empty()
    assert {r.uid: r.n_tokens for r in res} == {1: 2, 2: 12}
    rep = eng.report()["paging"]
    assert rep["prefix_hits"] >= 2
    assert rep["pages_in_use"] == rep["registry_entries"]
    assert int(eng._allocator.refs.max()) == 1


def test_pool_is_built_on_first_run_and_kept(served):
    eng = port_engine(served, kv_layout="paged", page_size=8)
    assert eng._pool is None
    serve(eng, workload(n=2), Request)
    pool = eng._pool
    assert set(pool) == {"k_pages", "v_pages"}
    cfg = served[0][0]
    assert pool["k_pages"].shape == (cfg.n_layers, (2 + 4) * 8 + 1, 8,
                                     cfg.kv_heads, cfg.hd)
    serve(eng, workload(n=2, seed=1), Request)
    assert eng._pool is pool


# ---------------------------------------------------------------------------
# knobs, validation, stepping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="interleaved"), "kv_layout"),
    (dict(kv_layout="paged", page_size=12), "page_size"),
    (dict(kv_layout="paged", page_size=8, mode="wave"), "paged"),
    (dict(kv_layout="paged", page_size=8, admission="serial"), "paged"),
    (dict(mode="batch"), "serving mode"),
    (dict(admission="eager"), "admission"),
])
def test_layout_validation_raises_where_the_reference_does(served, kw,
                                                           match):
    with pytest.raises(ValueError, match=match):
        port_engine(served, **kw)
    with pytest.raises(ValueError, match=match):
        jax_engine(served, **kw)


def test_serial_admission_skips_the_chunk_grain_check(served):
    """chunk_tokens is a chunked-admission knob: serial admission takes any
    value, as in the JAX engine."""
    port_engine(served, admission="serial", chunk_tokens=12)
    jax_engine(served, admission="serial", chunk_tokens=12)
    with pytest.raises(ValueError, match="multiple"):
        port_engine(served, chunk_tokens=12)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_step_refuses_the_modes_that_do_not_step(served, mode):
    eng = port_engine(served, **MODES[mode])
    assert eng.serve_step() == []           # nothing queued: no error
    eng.submit(Request(uid=0, prompt=prompt(1, 6), max_new_tokens=2))
    with pytest.raises(ValueError, match="serve_step"):
        eng.serve_step()


def test_auto_mode_serves_continuously(served):
    eng = port_engine(served)
    assert eng.mode == "auto" and eng._continuous_supported()
    res = serve(eng, workload(n=3), Request)
    assert eng.report()["chunk_steps"] > 0 and len(res) == 3


def test_wave_keeps_finished_rows_resident(served):
    """A wave runs until its longest request finishes: an 8-token request
    beside a 2-token one stays 7 decode steps, the short one too."""
    eng = port_engine(served, mode="wave")
    eng.submit(Request(uid=0, prompt=prompt(2, 5), max_new_tokens=8))
    eng.submit(Request(uid=1, prompt=prompt(3, 9), max_new_tokens=2))
    res = {r.uid: r for r in eng.run_wave()}
    assert res[0].n_tokens == 8 and res[1].n_tokens == 2
    assert res[0].steps == res[1].steps == 7
    assert eng.report()["slot_occupancy"] == 1.0


def test_reset_stats_zeroes_the_counters(served):
    eng = port_engine(served, kv_layout="paged", page_size=8)
    serve(eng, workload(n=3), Request)
    assert eng.report()["decode_steps"] > 0
    eng.reset_stats()
    rep = eng.report()
    assert rep["decode_steps"] == rep["generated_tokens"] == 0
    assert rep["wall_s"] == rep["energy_j"] == 0.0
    assert isinstance(rep["model_s"], float)
