"""Tensor-parallel serving at tp=2 against the JAX package, on the CPU.

The port serves each case in two rank processes (one `RankPool` for the
module, a gloo group between them; `torch_tp_ranks` holds their entry
points), each cutting its shard of the weights bridged from JAX; the JAX
engine serves the same requests at tp=1 in this process. The reference's
own tests (`tests/test_tp_serving.py`) hold its tp=2 streams to its tp=1
streams; here the port's tp=2 streams, on both ranks, must equal the JAX
tp=1 engine's token for token, for the dense family in every serving mode
(chunked, serial, paged with prefix reuse, the wave loop) and for moe, vlm
and encdec, with the reference's smoke configs and workload. Logits are
held to a tolerance, not bits: on the CPU the plain GEMM's bits depend on
the shard's width (`x @ w[:, shard]` is not always the columns of
`x @ w` in f32), so exact bits are the card's check (`chip_smoke.py`
phases 3 and 17).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro.models.config import ModelConfig as JModelConfig
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.launch.mesh import Mesh, RankPool
from repro_torch.models.config import ModelConfig

TP = 2
ENGINE = dict(max_batch=2, max_len=64)
CASES = {
    "dense-chunked": ("dense", {}),
    "dense-serial": ("dense", dict(admission="serial")),
    "dense-paged": ("dense", dict(admission="chunked", chunk_tokens=16,
                                  kv_layout="paged", page_size=16)),
    "dense-wave": ("dense", dict(mode="wave")),
    "moe": ("moe", {}),
    "vlm": ("vlm", {}),
    "encdec": ("encdec", {}),
}


@pytest.fixture(scope="module")
def pool():
    with RankPool(TP, timeout_s=240, threads=1) as p:
        yield p


def _jax(kind: str, **over):
    jcfg = JModelConfig(**R.config_kw(kind, **over))
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    return jcfg, japi, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jax_served():
    """{kind: (numpy parameter tree, the JAX tp=1 engine's streams)}, each
    family served once in chunked continuous mode: the JAX engine's modes
    give one stream (its own tests hold serial, paged and wave to
    chunked), so every port mode is held to it."""
    out = {}

    def get(kind: str):
        if kind not in out:
            jcfg, japi, jparams, tree = _jax(kind)
            eng = JServingEngine(japi, jparams, jcfg, tp=1, **ENGINE)
            for uid, p, mnt, ex in R.requests(kind, jcfg.d_model,
                                              jcfg.vocab):
                eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=mnt,
                                    extras=ex))
            out[kind] = (tree, {r.uid: r.tokens.tolist()
                                for r in eng.run_until_empty()})
        return out[kind]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp2_streams_equal_the_jax_engines(case, pool, jax_served):
    """Both ranks' greedy streams equal the JAX tp=1 engine's; each rank
    holds half of every sharded leaf and its heads' cache, the report
    carries tp=2 with wire telemetry, and the paged pool is released over
    two drains."""
    kind, kw = CASES[case]
    tree, want = jax_served(kind)
    cfg = ModelConfig(**R.config_kw(kind))
    reqs = R.requests(kind, cfg.d_model, cfg.vocab)
    drains = 2 if "paged" in case else 1
    ranks = pool.run(R.serve, cfg, tree, reqs, {**ENGINE, **kw}, drains)
    for out in ranks:
        for got in out["streams"]:
            assert got == want, (case, got, want)
        rep = out["report"]
        assert rep["tp"] == TP
        assert rep["collective_wire_s"] > 0.0
        assert 0.0 < rep["overlap_factor"] < 1.0
        assert out["estimate"]["n_chips"] == TP
        kv = out["state"]["kv"]["k"]
        assert kv[-2] == cfg.kv_heads // TP
        assert out["params"]["embed.table"] == (cfg.vocab // TP, cfg.d_model)
        if "paging" in out:
            pg = out["paging"]
            assert pg["pool"]["k_pages"][-2] == cfg.kv_heads // TP
            assert pg["min_ref"] >= 0
    assert ranks[0]["report"] == ranks[1]["report"]


def test_tp2_prices_two_chips_above_one(pool, jax_served):
    """The tp=2 report prices the fleet: the same tokens on two chips
    burning a shorter step cost more joules a token than one chip, and
    the decode estimate carries n_chips=2 and wire time."""
    tree, _ = jax_served("dense")
    cfg = ModelConfig(**R.config_kw("dense"))
    reqs = R.requests("dense", cfg.d_model, cfg.vocab)
    one = R.serve(Mesh(None, 0, 1), cfg, tree, reqs, ENGINE)
    two = pool.run(R.serve, cfg, tree, reqs, ENGINE)[0]
    assert one["report"]["tp"] == 1 and one["estimate"]["n_chips"] == 1
    assert one["report"]["collective_wire_s"] == 0.0
    assert two["streams"] == one["streams"]
    assert two["report"]["j_per_token"] > one["report"]["j_per_token"]
    assert two["estimate"]["collective_s"] > 0.0


@pytest.mark.parametrize("kind", ["dense", "moe", "vlm"])
def test_tp2_logits_match_jax(kind, pool):
    """One chunk call's whole-vocabulary logits at tp=2, on both ranks,
    against the JAX model's at tp=1: the whole-model tolerance (1e-4 of
    the largest logit: the bf16 KV cache can flip an entry by one bf16
    step), the ranks equal to each other bit for bit."""
    jcfg, japi, jparams, tree = _jax(kind)
    cfg = ModelConfig(**R.config_kw(kind))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    want, _ = japi.prefill_chunk(jparams, toks, np.array([16, 16], np.int32),
                                 japi.init_state(jcfg, 2, 64), jcfg)
    want = np.asarray(want)
    got = pool.run(R.logits, cfg, tree, toks)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def test_tp_primitives_match_the_unsharded_products(pool):
    """The layers of `distributed.tp` on each rank's shards: the
    column-parallel product is the whole product's columns, gather mode's
    row-parallel product (sharded or whole input, 3 chunks of 24 columns,
    put back in shard-major order) the whole product, psum mode's the
    whole product to the f32 tolerance, `replicate_for_parity` the whole
    input exactly, the vocab-sharded lookup the table's rows exactly and
    the tied head the whole logits; every rank holds the same gathered
    bits."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 144)) / 8).astype(np.float32)
    table = rng.standard_normal((128, 64)).astype(np.float32)
    tokens = rng.integers(0, 128, (2, 5))
    ranks = pool.run(R.layers, x, w, table, tokens, 3)
    full = torch.as_tensor(x) @ torch.as_tensor(w)
    tol = dict(rtol=0, atol=1e-5 * float(full.abs().max()))
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["column"],
                                   full[..., r * 72:(r + 1) * 72], **tol)
        for key in ("gather", "gather_whole", "psum"):
            np.testing.assert_allclose(out[key], full, **tol)
        np.testing.assert_array_equal(out["replicated"], x)
        np.testing.assert_array_equal(out["embed"], table[tokens])
        np.testing.assert_allclose(out["head"], x @ table.T, rtol=0,
                                   atol=1e-5 * np.abs(x @ table.T).max())
        for key in ("gather", "gather_whole", "psum", "embed", "head"):
            np.testing.assert_array_equal(out[key], ranks[0][key])
    # one gather of x, three chunk gathers; the whole input skips the
    # first: 4 + 3 + 3 (psum's chunks) + 1 (replicate) + 1 (lookup) + 1
    # (head)
    assert ranks[0]["collectives"] == 13


def test_a_failing_rank_fails_the_run_and_the_pool_recovers(pool):
    """A rank that raises makes `run` raise with its traceback; the pool
    is stopped and the next run starts fresh ranks."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        pool.run(R.fail_on, 1)
    assert len(pool.exitcodes) == TP
    assert pool.run(R.fail_on, None) == [0, 1]
