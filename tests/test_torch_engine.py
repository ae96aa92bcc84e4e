"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the qwen2-7b smoke config with the same weights (through
`bridge.params_from_numpy`) in continuous mode with chunked admission on a
dense KV cache. Token streams, per-request step counts and the engine's
step counters must be exactly equal: the port keeps the JAX engine's
admission order, chunk buckets, splice order and host numpy sampler.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

COUNTERS = ("requests", "generated_tokens", "decode_steps", "chunk_steps",
            "slot_steps", "resident_slot_steps", "slot_occupancy",
            "lane_rebuilds")


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


def prompt(seed: int, n: int, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def mixed_workload(n=9, seed=0, vocab=256, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, rng.integers(lo, hi)).astype(np.int32),
             int(rng.choice([4, 8, 16]))) for uid in range(n)]


def port_engine(served, **kw):
    cfg, api, params = served[0]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    return ServingEngine(api, params, cfg, device="cpu", **kw)


def jax_engine(served, **kw):
    jcfg, japi, jparams = served[1]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    return JServingEngine(japi, jparams, jcfg, mode="continuous", **kw)


def serve(eng, reqs, request_cls, **req_kw):
    for uid, p, mnt in reqs:
        eng.submit(request_cls(uid=uid, prompt=p.copy(), max_new_tokens=mnt,
                               **req_kw))
    return {r.uid: r for r in eng.run_until_empty()}


def assert_same_results(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid {uid}")
        assert (got[uid].steps, got[uid].n_tokens, got[uid].prompt_len) == \
            (want[uid].steps, want[uid].n_tokens, want[uid].prompt_len)


# ---------------------------------------------------------------------------
# streams against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("greedy,seed", [(True, 0), (False, 7)])
def test_streams_equal_jax_engine(served, greedy, seed):
    """A mixed 9-request workload at max_batch=2: more requests than slots,
    mixed budgets, so slots retire and refill mid-decode."""
    reqs = mixed_workload()
    peng = port_engine(served, greedy=greedy, seed=seed)
    jeng = jax_engine(served, greedy=greedy, seed=seed)
    got = serve(peng, reqs, Request)
    want = serve(jeng, reqs, JRequest)
    assert_same_results(got, want)
    for uid, _, mnt in reqs:
        assert got[uid].n_tokens <= mnt
    prep, jrep = peng.report(), jeng.report()
    assert {k: prep[k] for k in COUNTERS} == {k: jrep[k] for k in COUNTERS}


def test_multi_chunk_prompts_equal_jax_engine(served):
    """Prompts longer than chunk_tokens cross chunk boundaries; the lane
    grows, parks finished rows and reuses freed rows."""
    reqs = mixed_workload(n=7, seed=3, lo=5, hi=40)
    got = serve(port_engine(served, max_batch=3, chunk_tokens=16), reqs,
                Request)
    want = serve(jax_engine(served, max_batch=3, chunk_tokens=16), reqs,
                 JRequest)
    assert_same_results(got, want)


# ---------------------------------------------------------------------------
# termination and bounds
# ---------------------------------------------------------------------------


def _greedy_alone(served, p, **req_kw):
    eng = port_engine(served)
    eng.submit(Request(uid=0, prompt=p.copy(), **req_kw))
    (res,) = eng.run_until_empty()
    return res


def test_eos_as_first_token_stops_immediately(served):
    p = prompt(0, 8)
    first = int(_greedy_alone(served, p, max_new_tokens=8).tokens[0])
    res = _greedy_alone(served, p, max_new_tokens=8, eos_id=first)
    assert res.tokens.tolist() == [first]
    assert res.n_tokens == 1 and res.steps == 0   # never held a decode slot


def test_max_new_tokens_one(served):
    res = _greedy_alone(served, prompt(1, 6), max_new_tokens=1)
    assert res.n_tokens == 1 and len(res.tokens) == 1 and res.steps == 0


def test_budget_clamped_to_kv_room(served):
    eng = port_engine(served, max_len=16)
    eng.submit(Request(uid=0, prompt=prompt(3, 12), max_new_tokens=64))
    (res,) = eng.run_until_empty()
    assert res.n_tokens == 16 - 12


def test_prompt_too_long_raises(served):
    eng = port_engine(served, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=prompt(2, 16)))


def test_chunk_tokens_must_align_to_grain(served):
    with pytest.raises(ValueError, match="multiple"):
        port_engine(served, chunk_tokens=12)


# ---------------------------------------------------------------------------
# continuous batching inside the port
# ---------------------------------------------------------------------------


def test_mid_decode_refill_matches_serving_alone(served):
    """Each request of a workload larger than the slot table generates
    what it generates when served alone."""
    reqs = mixed_workload(n=5, seed=5)
    eng = port_engine(served)
    res = serve(eng, reqs, Request)
    for uid, p, mnt in reqs:
        assert res[uid].n_tokens == mnt
        np.testing.assert_array_equal(
            res[uid].tokens,
            _greedy_alone(served, p, max_new_tokens=mnt).tokens)
    rep = eng.report()
    assert rep["requests"] == 5
    assert rep["generated_tokens"] == sum(r.n_tokens for r in res.values())
    assert 0 < rep["slot_occupancy"] <= 1


@pytest.mark.parametrize("chunk_tokens", [8, 16, 64])
def test_streams_invariant_to_chunk_grid(served, chunk_tokens):
    """The same streams whatever the chunk size: a prompt prefilled in
    8-token chunks generates what it generates in one 64-token chunk."""
    reqs = mixed_workload(n=6, seed=9, lo=5, hi=50)
    got = serve(port_engine(served, chunk_tokens=chunk_tokens), reqs,
                Request)
    want = serve(port_engine(served, chunk_tokens=64), reqs, Request)
    assert_same_results(got, want)


def test_serve_step_drives_to_exhaustion(served):
    eng = port_engine(served)
    assert not eng.has_work and eng.serve_step() == []
    for uid, p, mnt in mixed_workload(n=3, seed=11):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=mnt))
    done = []
    steps = 0
    while eng.has_work:
        done.extend(eng.serve_step())
        steps += 1
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert steps >= eng.report()["decode_steps"]
    for r in done:
        assert r.ttft_s >= r.queue_s >= 0 and r.decode_s >= 0


def test_engine_default_device_is_the_card(served):
    """The engine defaults to the card: with no GPU it raises, and with
    one it refuses CPU params rather than serving on the CPU."""
    cfg, api, params = served[0]
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err):
        ServingEngine(api, params, cfg)
