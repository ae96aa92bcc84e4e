"""Tensor-parallel serving of the SSM, hybrid and MLA families at tp=2
against the JAX package, on the CPU.

The port serves each case in two rank processes (one `RankPool` for the
module, a gloo group between them; `torch_tp_ranks` holds their entry
points), each cutting its shard of the weights bridged from JAX; the JAX
engine serves the same requests at tp=1 in this process. The reference's
own tests (`tests/test_tp_serving.py`: the families' tp=2 parity,
`TestGrainSharded`, `TestTpPagedKv`) hold its tp=2 streams to its tp=1
streams; here the port's tp=2 streams, on both ranks, must equal the JAX
tp=1 engine's token for token for mamba1, mamba2, the hybrid and mla_moe,
for mamba2 at the serve grain 32 and for mla_moe on the paged latent pool
over two drains. Logits are held to the whole-model tolerance (exact bits
are the card's check, `chip_smoke.py` phases 3 and 17).

In this process, with no ranks: each SSM leaf cut by its parts (Mamba1's
in_proj ``[x | z]``, Mamba2's ``[z | x | B C | dt]`` and its conv over
``[x | B C]``), the local decode-state shapes (the hybrid's batch axis
never sharded) and the engine's refusal of a tp that would split an SSD
head or a Mamba1 channel block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro.models.config import ModelConfig as JModelConfig
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh, RankPool
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServingEngine

TP = 2
ENGINE = dict(max_batch=2, max_len=64)
GRAIN = dict(admission="chunked", chunk_tokens=32, ssm_serve_grain=32)
PAGED = dict(admission="chunked", chunk_tokens=16, kv_layout="paged",
             page_size=16)
# case: (kind, the port's engine settings, the JAX tp=1 engine's)
CASES = {
    "mamba1": ("mamba1", {}, {}),
    "mamba2": ("mamba2", {}, {}),
    "hybrid": ("hybrid", {}, {}),
    "mla_moe": ("mla_moe", {}, {}),
    "mamba2-grain32": ("mamba2", GRAIN, GRAIN),
    "mla_moe-paged": ("mla_moe", PAGED, {}),
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
    """(kind, JAX engine settings) -> (numpy parameter tree, the JAX tp=1
    engine's streams), each served once."""
    out = {}

    def get(kind: str, kw: dict):
        key = (kind, tuple(sorted(kw.items())))
        if key not in out:
            jcfg, japi, jparams, tree = _jax(kind)
            eng = JServingEngine(japi, jparams, jcfg, tp=1, **ENGINE, **kw)
            for uid, p, mnt, ex in R.requests(kind, jcfg.d_model,
                                              jcfg.vocab):
                eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=mnt,
                                    extras=ex))
            out[key] = (tree, {r.uid: r.tokens.tolist()
                               for r in eng.run_until_empty()})
        return out[key]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp2_streams_equal_the_jax_engines(case, pool, jax_served):
    """Both ranks' greedy streams equal the JAX tp=1 engine's; each rank
    holds its half of the channels or heads of every sharded leaf and of
    the decode state (the MLA latent cache whole), the report carries
    tp=2 with wire time, and the paged latent pool is released over two
    drains."""
    kind, kw, jkw = CASES[case]
    tree, want = jax_served(kind, jkw)
    cfg = ModelConfig(**R.config_kw(kind))
    reqs = R.requests(kind, cfg.d_model, cfg.vocab)
    drains = 2 if "paged" in case else 1
    ranks = pool.run(R.serve, cfg, tree, reqs, {**ENGINE, **kw}, drains)
    di = cfg.d_inner
    for out in ranks:
        for got in out["streams"]:
            assert got == want, (case, got, want)
        rep = out["report"]
        assert rep["tp"] == TP
        assert rep["collective_wire_s"] > 0.0
        assert 0.0 < rep["overlap_factor"] < 1.0
        assert rep["model_s"] > 0.0
        params, state = out["params"], out["state"]
        assert params["embed.table"] == (cfg.vocab // TP, cfg.d_model)
        if kind == "mamba1":
            assert params["blocks.0.ssm.in_proj"] == (cfg.d_model, di)
            assert state["kv"]["conv"][-1] == di // TP
        elif kind in ("mamba2", "hybrid"):
            ssm = state["cache"]["mamba"]["ssm"] if kind == "hybrid" else (
                state["kv"]["ssm"])
            assert ssm[-3] == di // cfg.ssm_headdim // TP
        else:
            assert params["blocks.0.attn.w_dkv"] == (cfg.d_model,
                                                     cfg.kv_lora_rank)
            if "paging" in out:
                pg = out["paging"]
                assert pg["pool"]["c_kv_pages"][-1] == cfg.kv_lora_rank
                assert pg["min_ref"] >= 0
            else:
                assert state["kv"]["c_kv"][-1] == cfg.kv_lora_rank
    assert ranks[0]["report"] == ranks[1]["report"]
    if "paging" in ranks[0]:
        assert ranks[0]["paging"] == ranks[1]["paging"]


@pytest.mark.parametrize("kind", ["mamba1", "mamba2", "hybrid", "mla_moe"])
def test_tp2_logits_match_jax(kind, pool):
    """One chunk call's whole-vocabulary logits at tp=2, on both ranks,
    against the JAX model's at tp=1 (the whole-model tolerance, 1e-4 of
    the largest logit), the ranks equal to each other bit for bit. Both
    packages' caches are widened to f32: a bf16 MLA latent entry that
    rounds the other way feeds every head's keys and values, which moves
    this config's logits by 3.4e-4 at tp=1 already (with f32 caches the
    port is within 2.2e-6 of JAX)."""
    jcfg, japi, jparams, tree = _jax(kind)
    cfg = ModelConfig(**R.config_kw(kind))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    jstate = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        japi.init_state(jcfg, 2, 64))
    want, _ = japi.prefill_chunk(jparams, toks, np.array([16, 16], np.int32),
                                 jstate, jcfg)
    want = np.asarray(want)
    got = pool.run(R.logits, cfg, tree, toks, True)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def _blocks(t: torch.Tensor, axis: int, rank: int, tp: int, parts) -> list:
    """Rank `rank`'s slices of `t` along `axis`: for each (size, cut) a
    1/tp block of that part, or the part whole."""
    out, lo = [], 0
    for size, cut in parts:
        n = size // tp if cut else size
        out.append(t.narrow(axis, lo + (rank * n if cut else 0), n))
        lo += size
    return out


def _by_hand(cfg) -> dict:
    """{leaf basename: (axis, parts)} of the SSM leaves, written out from
    the blocks' layouts (not from `sharding.axis_parts`)."""
    di, ds = cfg.d_inner, cfg.ssm_state
    if cfg.kind == "mamba1":
        chan = [(di, True)]
        return {"in_proj": (1, [(di, True), (di, True)]),
                "conv_w": (0, chan), "conv_b": (0, chan),
                "x_proj": (None, None), "dt_proj": (1, chan),
                "dt_bias": (0, chan), "A_log": (0, chan), "D": (0, chan),
                "out_proj": (1, [(cfg.d_model, True)])}
    H, bc = di // cfg.ssm_headdim, 2 * cfg.ssm_ngroups * ds
    xbc = [(di, True), (bc, False)]
    heads = [(H, True)]
    return {"in_proj": (1, [(di, True), (di, True), (bc, False),
                            (H, True)]),
            "conv_w": (0, xbc), "conv_b": (0, xbc), "dt_bias": (0, heads),
            "A_log": (0, heads), "D": (0, heads), "norm_scale": (None, None),
            "out_proj": (1, [(cfg.d_model, True)])}


@pytest.mark.parametrize("kind", ["mamba1", "mamba2", "hybrid"])
def test_ssm_leaves_are_cut_by_parts(kind):
    """`shard_params` cuts each SSM leaf of the bridged JAX weights by its
    parts for each rank of a (1, 2) mesh: every rank's leaf is the
    concatenation of its block of each sharded part and each shared part
    (Mamba2's B and C) whole; x_proj and Mamba2's norm scale stay whole."""
    _, _, _, tree = _jax(kind)
    cfg = ModelConfig(**R.config_kw(kind))
    whole = dict(params_from_numpy(tree, cfg, "cpu").named_parameters())
    rules = _by_hand(cfg)
    seen = set()
    for rank in range(TP):
        model = sharding.shard_params(params_from_numpy(tree, cfg, "cpu"),
                                      Mesh(None, rank, TP), cfg=cfg)
        for name, p in model.named_parameters():
            if ".ssm." not in name:
                continue
            leaf = name.rsplit(".", 1)[-1]
            axis, parts = rules[leaf]
            want = whole[name].detach()
            if axis is not None:
                want = torch.cat(_blocks(want, axis, rank, TP, parts), axis)
            np.testing.assert_array_equal(p.detach().numpy(), want.numpy(),
                                          err_msg=name)
            seen.add(leaf)
    assert seen == set(rules)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2", "hybrid", "mla_moe"])
def test_decode_state_is_local(kind, tp):
    """A decode state (and for mla_moe the paged pool) allocated under a
    (1, tp) mesh holds this rank's channels or heads: Mamba1's conv and
    scan state d_inner / tp channels, Mamba2's scan state H / tp heads and
    its conv history its heads' x channels beside the whole B and C, the
    hybrid's KV caches KV / tp heads with every leaf's batch axis whole;
    the MLA latent cache and pool whole. (At tp=4 over 8 query and 4 KV
    heads, as the reference's tp=4 case.)"""
    over = dict(n_heads=8, n_kv_heads=4) if tp == 4 else {}
    cfg = ModelConfig(**R.config_kw(kind, **over))
    api = get_model(cfg)
    sharding.set_mesh(Mesh(None, 0, tp))
    try:
        state = api.init_state(cfg, 2, 16, device="meta")
        pool = (api.init_page_pool(cfg, 5, 8, device="meta")
                if api.init_page_pool is not None else None)
    finally:
        sharding.set_mesh(None)
    L, K, B = cfg.n_layers, cfg.d_conv - 1, 2
    di, ds = cfg.d_inner, cfg.ssm_state
    H, P = di // cfg.ssm_headdim, cfg.ssm_headdim
    bc = 2 * cfg.ssm_ngroups * ds
    if kind == "mamba1":
        want = {"conv": (L, B, K, di // tp), "ssm": (L, B, di // tp, ds)}
        got = {k: tuple(state["kv"][k].shape) for k in want}
    elif kind == "mamba2":
        want = {"conv": (L, B, K, di // tp + bc),
                "ssm": (L, B, H // tp, ds, P)}
        got = {k: tuple(state["kv"][k].shape) for k in want}
    elif kind == "hybrid":
        G, E = L // cfg.attn_every, cfg.attn_every
        cache = state["cache"]
        want = {"conv": (G, E, B, K, di // tp + bc),
                "ssm": (G, E, B, H // tp, ds, P),
                "k": (G, B, 16, cfg.kv_heads // tp, cfg.hd),
                "v": (G, B, 16, cfg.kv_heads // tp, cfg.hd)}
        got = {**{k: tuple(v.shape) for k, v in cache["mamba"].items()},
               **{k: tuple(v.shape) for k, v in cache["attn"].items()}}
    else:
        want = {"c_kv": (L, B, 16, cfg.kv_lora_rank),
                "k_pe": (L, B, 16, cfg.rope_head_dim),
                "c_kv_pages": (L, 5, 8, cfg.kv_lora_rank),
                "k_pe_pages": (L, 5, 8, cfg.rope_head_dim)}
        got = {**{k: tuple(state["kv"][k].shape) for k in ("c_kv", "k_pe")},
               **{k: tuple(v.shape) for k, v in pool.items()}}
    assert got == want


@pytest.mark.parametrize("kind,tp,what", [
    ("mamba1", 3, "d_inner=128"),
    ("mamba2", 16, "ssd_heads=8"),
    ("hybrid", 4, "kv_heads=2"),
], ids=["mamba1-channels", "mamba2-heads", "hybrid-kv-heads"])
def test_engine_refuses_a_split_block(kind, tp, what):
    """A tp that does not divide what the family shards raises ValueError
    naming it: Mamba1's 128 d_inner channels at tp=3, Mamba2's 8 SSD heads
    at tp=16 (which divides its 128 channels: a head would be split), the
    hybrid's 2 KV heads at tp=4 (which divides its SSD heads)."""
    cfg = ModelConfig(**R.config_kw(kind))
    params = get_model(cfg).init(cfg, torch.Generator("cpu").manual_seed(0),
                                 device="cpu")
    with pytest.raises(ValueError, match=f"{what}.*whole heads"):
        ServingEngine(get_model(cfg), params, cfg, device="cpu", tp=tp,
                      mesh=Mesh(None, 0, tp), **ENGINE)
