"""The port's MoE and MLA models against the JAX package's, on the CPU.

The JAX parameters go through `bridge.params_from_numpy`, so both packages
run the same weights; inputs are made from a seed with numpy. The smoke
configs are f32 end to end except the KV (MLA: latent) cache, which both
packages keep in bf16. Tolerances are ROADMAP's: f32 outputs of one layer
1e-5 (scaled by the output's magnitude: the two frameworks sum in different
orders), whole-model logits 1e-4 (a bf16 cache entry may flip by one bf16
step, see `test_torch_model.py`), routing decisions and integer state
exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import gemm_shape_counts as jgemm_shape_counts
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.config import ModelConfig, gemm_shape_counts
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import lm_init

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _cache_close(got, want) -> None:
    """bf16 caches equal but for rare entries one bf16 step apart."""
    got, want = _np(got), _np(want)
    assert (got != want).mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def _pair(jcfg: JModelConfig, seed: int = 0):
    """(port (cfg, api, params), jax (cfg, api, params)): the same weights
    in both packages."""
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(seed), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def smoke(request):
    return _pair(jget_config(request.param, smoke=True))


def _layer(jparams, group: str, i: int = 0):
    return jax.tree.map(lambda a: a[i], jparams["blocks"][group])


# ---------------------------------------------------------------------------
# configs, bridge, init, GEMM counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke_cfg", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_equals_jax_field_by_field(arch, smoke_cfg):
    port = get_config(arch, smoke=smoke_cfg)
    ref = jget_config(arch, smoke=smoke_cfg)
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.hd, port.kv_heads, port.n_params(),
            port.n_active_params()) == (ref.hd, ref.kv_heads, ref.n_params(),
                                        ref.n_active_params())


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_round_trip_of_the_nested_trees(arch, param_dtype):
    """The JAX tree (moe.router, moe.experts, moe.shared_mlp, MLA's
    projections, stacked on L) through the port's module and back."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               param_dtype=param_dtype)
    tree = jax.tree.map(np.asarray,
                        jget_model(jcfg).init(jax.random.key(1), jcfg))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=param_dtype)
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.blocks[0].moe["experts"]["w_gate"].dtype == getattr(
        torch, param_dtype)
    back = params_to_numpy(model)
    flat_in, tdef_in = jax.tree.flatten(tree)
    flat_out, tdef_out = jax.tree.flatten(back)
    assert tdef_in == tdef_out
    for a, b in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_bridge_rejects_a_missing_nested_leaf(smoke):
    (cfg, _, params), _ = smoke
    tree = params_to_numpy(params)
    del tree["blocks"]["moe"]["experts"]["w_up"]
    with pytest.raises(ValueError, match="blocks.moe.experts"):
        params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_init_uses_the_reference_scales(arch):
    """Experts N(0, 1/d) in and N(0, 1/f) out, the router 1/d, MLA's wo
    1/(H hd); seeded."""
    cfg = get_config(arch, smoke=True)
    a = lm_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = lm_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
    blk = a.blocks[0]
    d, f = cfg.d_model, cfg.d_ff_expert
    ex = blk.moe["experts"]
    assert 0.85 < ex["w_up"].std().item() * d ** 0.5 < 1.15
    assert 0.85 < ex["w_down"].std().item() * f ** 0.5 < 1.15
    assert 0.7 < blk.moe["router"]["w"].std().item() * d ** 0.5 < 1.3
    hd_all = cfg.n_heads * cfg.hd
    assert 0.85 < blk.attn["wo"].std().item() * hd_all ** 0.5 < 1.15
    assert torch.equal(blk.ln2["scale"], torch.ones_like(blk.ln2["scale"]))


@pytest.mark.parametrize("smoke_cfg", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_gemm_shape_counts_equal_the_reference(arch, smoke_cfg):
    cfg, jcfg = get_config(arch, smoke=smoke_cfg), jget_config(
        arch, smoke=smoke_cfg)
    for n, head, kv in [(4, None, 2048), (512, 8, 4096), (64, 1, None),
                        (1, None, None)]:
        assert gemm_shape_counts(cfg, n, head_tokens=head, kv_rows=kv) == \
            jgemm_shape_counts(jcfg, n, head_tokens=head, kv_rows=kv)


@pytest.mark.parametrize("kv_cap", [None, 256])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_gemm_fleet_equals_the_reference(arch, kv_cap):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kw in (dict(chunk_tokens=64, lane_width=8), {}):
        assert ops.serving_gemm_fleet(cfg, max_batch=4, max_len=512,
                                      kv_cap=kv_cap, **kw) == \
            jops.serving_gemm_fleet(jcfg, max_batch=4, max_len=512,
                                    kv_cap=kv_cap, **kw)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


def _olmoe(capacity_factor: float):
    return _pair(dataclasses.replace(jget_config("olmoe-1b-7b", smoke=True),
                                     capacity_factor=capacity_factor))


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_moe_ffn_apply_matches_jax(capacity_factor):
    """cf 1.0 binds (capacity 1 slot per row and expert at S = 7, so
    tokens drop); cf 4.0 = E/K never binds. Output and aux loss against
    the JAX package's; the dispatch (expert ids, slots, kept tokens) from
    the same router logits exactly."""
    (cfg, _, params), (jcfg, _, jparams) = _olmoe(capacity_factor)
    B, S, d = 3, 7, cfg.d_model
    x = _rand((B, S, d), 20)
    jp = _layer(jparams, "moe")
    jy, jaux = jmoe.moe_ffn_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn_apply(params.blocks[0].moe, torch.from_numpy(x),
                                 cfg)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)

    logits = x.reshape(B * S, d) @ _np(jp["router"]["w"])
    cap = moe.capacity(cfg, S)
    assert cap == max(1, int(capacity_factor * S * cfg.top_k
                             / cfg.n_experts))
    _, jidx, jslot, jgate, _ = jmoe._local_dispatch(
        jnp.asarray(x.reshape(B * S, d)), jnp.asarray(logits), jcfg, cap, B)
    r = moe.route(torch.from_numpy(logits), cfg, B)
    assert r["idx"].tolist() == np.asarray(jidx).tolist()
    assert r["slot"].tolist() == np.asarray(jslot).tolist()
    assert r["keep"].tolist() == (np.asarray(jgate) != 0).tolist()
    np.testing.assert_allclose(_np(r["gate"]), _np(jgate), **TOL)
    assert (not r["keep"].all()) == (capacity_factor == 1.0)


def test_top_k_breaks_ties_to_the_lower_index_as_jax_does():
    probs = np.array([[0.2, 0.1, 0.2, 0.2, 0.3],
                      [0.1, 0.1, 0.1, 0.1, 0.1],
                      [0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[4, 0, 2], [0, 1, 2],
                                                      [1, 3, 0]]
    np.testing.assert_array_equal(_np(tv), _np(jv))


def test_moe_routing_of_a_row_does_not_depend_on_its_batch():
    """Per-row capacity at a binding cf: a row's output alone equals the
    same row inside a batch of 3."""
    (cfg, _, params), _ = _olmoe(1.0)
    x = torch.from_numpy(_rand((3, 7, cfg.d_model), 21))
    whole, _ = moe.moe_ffn_apply(params.blocks[0].moe, x, cfg)
    alone, _ = moe.moe_ffn_apply(params.blocks[0].moe, x[1:2], cfg)
    torch.testing.assert_close(alone[0], whole[1], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# multi-head latent attention
# ---------------------------------------------------------------------------


def _mla_cfgs():
    base = jget_config("deepseek-v2-236b", smoke=True)
    return [base, dataclasses.replace(base, q_lora_rank=0)]


@pytest.fixture(scope="module", params=[0, 1], ids=["q_lora", "no_q_lora"])
def mla(request):
    return _pair(_mla_cfgs()[request.param])


@pytest.mark.parametrize("layout", ["none", "dense", "paged"])
def test_mla_apply_matches_jax(mla, layout):
    """No cache, a dense latent cache (per-row index, a zero-length row)
    and a paged latent pool (shuffled pages, a dead row on the null
    page): output and written cache against the JAX package's."""
    (cfg, _, params), (jcfg, _, jparams) = mla
    B, S, T = 3, 5, 16
    x = _rand((B, S, cfg.d_model), 30)
    jp = _layer(jparams, "attn")
    tp = params.blocks[0].attn
    if layout == "none":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        jy, _ = jmoe.mla_apply(jp, jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos))
        ty, tc = moe.mla_apply(tp, torch.from_numpy(x), cfg,
                               positions=_t(pos))
        assert tc is None
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        return
    idx = np.array([0, 4, 9], np.int32)
    lens = np.array([5, 2, 0], np.int32)
    pos = idx[:, None] + np.arange(S, dtype=np.int32)[None]
    r, pe = cfg.kv_lora_rank, cfg.rope_head_dim
    if layout == "dense":
        leaves = {"c_kv": _rand((B, T, r), 31), "k_pe": _rand((B, T, pe), 32)}
        jcache = {k: jnp.asarray(v).astype(jnp.bfloat16)
                  for k, v in leaves.items()}
        tcache = {k: torch.from_numpy(v).to(torch.bfloat16)
                  for k, v in leaves.items()}
    else:
        P, PT = 9, 8
        table = np.array([[3, 7], [0, 0], [5, 1]], np.int32)
        leaves = {"c_kv_pages": _rand((P, PT, r), 33),
                  "k_pe_pages": _rand((P, PT, pe), 34)}
        for v in leaves.values():
            v[0] = 0.0                                   # the null page
        jcache = {k: jnp.asarray(v).astype(jnp.bfloat16)
                  for k, v in leaves.items()}
        jcache["table"] = jnp.asarray(table)
        tcache = {k: torch.from_numpy(v).to(torch.bfloat16)
                  for k, v in leaves.items()}
        tcache["table"] = _t(table)
    jy, jc = jmoe.mla_apply(jp, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos), kv_cache=jcache,
                            cache_index=jnp.asarray(idx),
                            seq_lens=jnp.asarray(lens))
    ty, tc = moe.mla_apply(tp, torch.from_numpy(x), cfg, positions=_t(pos),
                           kv_cache=tcache, cache_index=_t(idx),
                           seq_lens=_t(lens))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for k in leaves:
        assert tc[k] is tcache[k]                        # written in place
        _cache_close(tc[k], jc[k])


# ---------------------------------------------------------------------------
# whole-model forwards
# ---------------------------------------------------------------------------


def test_lm_prefill_matches_jax(smoke):
    (cfg, api, params), (jcfg, japi, jparams) = smoke
    toks, lens = _tokens((3, 12), 40), np.array([12, 7, 1], np.int32)
    jl, js = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)}, jcfg,
                          max_len=32)
    tl, ts = api.prefill(params, {"tokens": _t(toks), "lengths": _t(lens)},
                         cfg, max_len=32)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL)
    assert ts["index"].tolist() == lens.tolist()
    for k in ts["kv"]:
        _cache_close(ts["kv"][k], js["kv"][k])
    jl, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, ts = api.prefill(params, {"tokens": _t(toks)}, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL)
    assert int(ts["index"]) == 12


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_chunk_and_decode_match_jax(smoke, layout):
    """Three chunk calls over rows of different lengths (one row zero-
    length throughout, one finishing early), then decode steps at per-row
    positions, through the dense cache or a paged pool (shuffled pages, the
    zero-length row on the null page): logits, index and cache against the
    JAX package's."""
    (cfg, api, params), (jcfg, japi, jparams) = smoke
    W, C, T, n = 4, 8, 8, 6
    if layout == "dense":
        jstate = japi.init_state(jcfg, W, n * T)
        tstate = api.init_state(cfg, W, n * T, device="cpu")
    else:
        table = np.array([[5, 2, 9, 7, 12, 14], [3, 11, 1, 8, 15, 16],
                          [0] * 6, [4, 6, 10, 13, 17, 18]], np.int32)
        pool = api.init_page_pool(cfg, 19, T, device="cpu")
        jpool = japi.init_page_pool(jcfg, 19, T)
        tstate = {"kv": {**pool, "table": _t(table)[None].expand(
                      cfg.n_layers, W, n)},
                  "index": torch.zeros(W, dtype=torch.long)}
        jstate = {"kv": {**jpool, "table": jnp.broadcast_to(
                      jnp.asarray(table)[None], (cfg.n_layers, W, n))},
                  "index": jnp.zeros((W,), jnp.int32)}
    prompts = [_tokens((m,), 50 + m) for m in (20, 5, 0, 13)]
    base = np.zeros(W, np.int32)
    for step in range(3):
        toks = np.zeros((W, C), np.int32)
        lens = np.zeros(W, np.int32)
        for r, p in enumerate(prompts):
            k = min(C, len(p) - base[r])
            toks[r, :k] = p[base[r]:base[r] + k]
            lens[r] = k
        jl, jstate = japi.prefill_chunk(jparams, jnp.asarray(toks),
                                        jnp.asarray(lens), jstate, jcfg)
        tl, tstate = api.prefill_chunk(params, _t(toks), _t(lens), tstate,
                                       cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL,
                                   err_msg=str(step))
        base += lens
    tok = _tokens((W,), 60)
    for step in range(3):
        jl, jstate = japi.decode_step(jparams, jnp.asarray(tok), jstate, jcfg)
        tl, tstate = api.decode_step(params, _t(tok), tstate, cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL,
                                   err_msg=str(step))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tstate["index"].tolist() == np.asarray(jstate["index"]).tolist()
    for k, leaf in tstate["kv"].items():
        if k != "table":
            _cache_close(leaf, jstate["kv"][k])
