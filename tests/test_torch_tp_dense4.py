"""Tensor-parallel serving at tp=4 against the JAX package, on the CPU:
the dense smoke config over the reference's 4-way head layout (8 query and
4 KV heads, `tests/test_tp_serving.py`'s tp=4 case), served by four rank
processes (one `RankPool` for the module), chunked and on the paged
layout, and the mamba1 and mamba2 smoke configs (32 of 128 channels, 2 of
8 SSD heads a rank), must give the JAX tp=1 engine's streams token for
token on every rank; and the tp layers at four ranks, with a chunk count
that does not divide a rank's columns."""

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
from repro_torch.launch.mesh import RankPool
from repro_torch.models.config import ModelConfig

TP = 4
HEADS = dict(n_heads=8, n_kv_heads=4)
ENGINE = dict(max_batch=2, max_len=64)


@pytest.fixture(scope="module")
def pool():
    with RankPool(TP, timeout_s=240, threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def jax_served():
    """(numpy parameter tree, the JAX tp=1 engine's streams)."""
    jcfg = JModelConfig(**R.config_kw("dense", **HEADS))
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    eng = JServingEngine(japi, jparams, jcfg, tp=1, **ENGINE)
    for uid, p, mnt, ex in R.requests("dense", jcfg.d_model, jcfg.vocab):
        eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=mnt,
                            extras=ex))
    return (jax.tree.map(np.asarray, jparams),
            {r.uid: r.tokens.tolist() for r in eng.run_until_empty()})


@pytest.mark.parametrize("kw", [{}, dict(chunk_tokens=16, kv_layout="paged",
                                         page_size=16)],
                         ids=["chunked", "paged"])
def test_tp4_streams_equal_the_jax_engines(kw, pool, jax_served):
    """Every rank's streams equal the JAX tp=1 engine's; each rank holds
    one KV head of the cache and a quarter of every sharded leaf."""
    tree, want = jax_served
    cfg = ModelConfig(**R.config_kw("dense", **HEADS))
    reqs = R.requests("dense", cfg.d_model, cfg.vocab)
    ranks = pool.run(R.serve, cfg, tree, reqs, {**ENGINE, **kw})
    for out in ranks:
        assert out["streams"] == [want]
        assert out["report"]["tp"] == TP
        assert out["state"]["kv"]["k"][-2] == 1
        assert out["params"]["blocks.0.attn.wq"] == (cfg.d_model,
                                                     cfg.d_model // TP)
        assert out["params"]["blocks.0.attn.wo"] == (cfg.d_model,
                                                     cfg.d_model // TP)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_tp4_ssm_streams_equal_the_jax_engines(kind, pool):
    """Every rank's streams equal the JAX tp=1 engine's with a quarter of
    the channels (mamba1) or SSD heads (mamba2) in each rank's leaves and
    decode state."""
    jcfg = JModelConfig(**R.config_kw(kind))
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    eng = JServingEngine(japi, jparams, jcfg, tp=1, **ENGINE)
    for uid, p, mnt, ex in R.requests(kind, jcfg.d_model, jcfg.vocab):
        eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=mnt,
                            extras=ex))
    want = {r.uid: r.tokens.tolist() for r in eng.run_until_empty()}
    cfg = ModelConfig(**R.config_kw(kind))
    reqs = R.requests(kind, cfg.d_model, cfg.vocab)
    ranks = pool.run(R.serve, cfg, jax.tree.map(np.asarray, jparams), reqs,
                     ENGINE)
    heads = cfg.d_inner // cfg.ssm_headdim
    for out in ranks:
        assert out["streams"] == [want]
        assert out["report"]["tp"] == TP
        ssm = out["state"]["kv"]["ssm"]
        if kind == "mamba1":
            assert ssm[-2] == cfg.d_inner // TP
        else:
            assert ssm[-3] == heads // TP
    assert ranks[0]["report"] == ranks[3]["report"]


def test_tp4_primitives_match_the_unsharded_products(pool):
    """`distributed.tp`'s layers at four ranks: 160 columns give each rank
    40, which 3 chunks do not divide (2 chunks of 20 are taken), put back
    in shard-major order; every rank holds the same gathered bits."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 160)) / 8).astype(np.float32)
    table = rng.standard_normal((96, 64)).astype(np.float32)
    tokens = rng.integers(0, 96, (3, 4))
    ranks = pool.run(R.layers, x, w, table, tokens, 3)
    full = torch.as_tensor(x) @ torch.as_tensor(w)
    tol = dict(rtol=0, atol=1e-5 * float(full.abs().max()))
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["column"],
                                   full[:, r * 40:(r + 1) * 40], **tol)
        for key in ("gather", "gather_whole", "psum"):
            np.testing.assert_allclose(out[key], full, **tol)
            np.testing.assert_array_equal(out[key], ranks[0][key])
        np.testing.assert_array_equal(out["replicated"], x)
        np.testing.assert_array_equal(out["embed"], table[tokens])
    # x's gather and 2 chunk gathers, 2 chunk gathers of the whole input,
    # 2 psum chunks (160 = 2 x 80), the replicate, the lookup and the head
    assert ranks[0]["collectives"] == 3 + 2 + 2 + 1 + 1 + 1


def test_host_mesh_rows_are_model_groups(pool):
    """`make_host_mesh(2)` over four ranks is a (2, 2) mesh whose "model"
    groups are the rows [0, 1] and [2, 3]."""
    got = pool.run(R.host_mesh, 2)
    assert [g[0] for g in got] == [{"data": 2, "model": 2}] * 4
    assert [(g[1], g[2]) for g in got] == [(0, [0, 1]), (1, [0, 1]),
                                           (0, [2, 3]), (1, [2, 3])]
