"""The port's qwen2-7b model against the JAX package's, on the CPU.

The JAX parameters go through `bridge.params_from_numpy`, so both packages
run the same weights; inputs are made from a seed with numpy. The smoke
config is f32 end to end except the KV cache, which both packages keep in
bf16. Tolerance for f32 outputs of one layer: 1e-5 (the two frameworks sum
in different orders; values are O(1)). Integer state is compared exactly.

Whole-model forwards are held to 1e-4. Both packages round keys and values
to bf16 as they write the cache, and a 1e-7 difference in an f32 key that
sits next to a bf16 rounding boundary flips that cached entry by one bf16
step (2^-8 relative); the logits that read it then move by a few 1e-5. The
tests check that such flips stay rare and one step wide (`_cache_close`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import TransformerLM, lm_init

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cache_close(got, want) -> None:
    """bf16 caches equal but for rare entries one bf16 step apart."""
    got, want = _np(got), _np(want)
    differ = got != want
    assert differ.mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def _to_numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.fixture(scope="module")
def smoke():
    """(port cfg, port api, port params, jax cfg, jax api, jax params)."""
    jcfg = jget_config("qwen2-7b", smoke=True)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = get_config("qwen2-7b", smoke=True)
    params = params_from_numpy(_to_numpy_tree(jparams), cfg, device="cpu")
    return cfg, get_model(cfg), params, jcfg, japi, jparams


# ---------------------------------------------------------------------------
# configs, registry, bridge, init
# ---------------------------------------------------------------------------


DENSE_ARCHS = ("qwen2-7b", "qwen2.5-14b", "codeqwen1.5-7b", "starcoder2-3b")


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_config_equals_jax_field_by_field(smoke_cfg):
    """Every dense config the port serves, full and smoke."""
    for arch in DENSE_ARCHS:
        port = get_config(arch, smoke=smoke_cfg)
        ref = jget_config(arch, smoke=smoke_cfg)
        assert ([f.name for f in dataclasses.fields(port)]
                == [f.name for f in dataclasses.fields(ref)])
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
        assert (port.hd, port.kv_heads, port.n_params()) == \
            (ref.hd, ref.kv_heads, ref.n_params())


def test_the_four_dense_configs_are_ported():
    """The four dense configs and, since the MoE slice, the two MoE ones;
    since the SSM slice, falcon-mamba-7b and zamba2-2.7b; since the
    encdec/vlm slice, seamless-m4t-medium and qwen2-vl-2b: every
    architecture of the JAX package."""
    from repro.configs import list_archs as jlist_archs
    from repro_torch.configs import list_archs

    assert sorted(list_archs()) == sorted(
        DENSE_ARCHS + ("olmoe-1b-7b", "deepseek-v2-236b", "falcon-mamba-7b",
                       "zamba2-2.7b", "seamless-m4t-medium", "qwen2-vl-2b"))
    assert sorted(list_archs()) == sorted(jlist_archs())


@pytest.mark.parametrize("arch,item", [
    ("seamless-m4t-medium", "A6"), ("qwen2-vl-2b", "A6")])
def test_unported_archs_and_kinds_name_their_roadmap_item(arch, item):
    """The last archs and kinds that named a ROADMAP item (A6, encdec/vlm)
    are served since that slice: their configs resolve, their kinds have a
    chunked prefill and an admission, and no name is left unported (an
    unknown arch or kind raises KeyError)."""
    assert get_config(arch).kind == jget_config(arch).kind
    kind = jget_config(arch).kind
    api = get_model(dataclasses.replace(get_config("qwen2-7b", smoke=True),
                                        kind=kind))
    assert api.prefill_chunk is not None and api.admit is not None
    for kind in ("moe", "mla_moe", "mamba1", "mamba2", "hybrid"):
        cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                                  kind=kind)
        assert get_model(cfg).prefill_chunk is not None
    with pytest.raises(KeyError):
        get_config(f"{arch}-{item}")
    with pytest.raises(KeyError):
        get_model(dataclasses.replace(get_config("qwen2-7b", smoke=True),
                                      kind=item))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(param_dtype):
    jcfg = dataclasses.replace(jget_config("qwen2-7b", smoke=True),
                               param_dtype=param_dtype)
    tree = _to_numpy_tree(jget_model(jcfg).init(jax.random.key(1), jcfg))
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              param_dtype=param_dtype)
    model = params_from_numpy(tree, cfg, device="cpu")
    assert model.embed["table"].dtype == getattr(torch, param_dtype)
    back = params_to_numpy(model)
    flat_in, tdef_in = jax.tree.flatten(tree)
    flat_out, tdef_out = jax.tree.flatten(back)
    assert tdef_in == tdef_out
    for a, b in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_bridge_rejects_wrong_shapes_and_keys(smoke):
    cfg, _, params, *_ = smoke
    tree = params_to_numpy(params)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, cfg, device="cpu")
    tree = params_to_numpy(params)
    del tree["blocks"]["mlp"]["w_gate"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tree, cfg, device="cpu")


def test_lm_init_seeded_and_scaled():
    cfg = get_config("qwen2-7b", smoke=True)
    a = lm_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = lm_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    blk = a.blocks[0]
    assert torch.equal(blk.attn["bq"], torch.zeros_like(blk.attn["bq"]))
    assert torch.equal(blk.ln1["scale"], torch.ones_like(blk.ln1["scale"]))
    std = blk.mlp["w_down"].std().item() * np.sqrt(cfg.d_ff)
    assert 0.8 < std < 1.2
    assert not any(p.requires_grad for p in a.parameters())


def test_default_device_is_the_card():
    cfg = get_config("qwen2-7b", smoke=True)
    if torch.cuda.is_available():
        assert TransformerLM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            TransformerLM(cfg)


# ---------------------------------------------------------------------------
# layers against JAX
# ---------------------------------------------------------------------------


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def test_rmsnorm_matches_jax():
    x, s = _rand((2, 5, 64), 0), _rand((64,), 1)
    got = L.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x), 1e-6)
    want = JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    x = _rand((2, 7, 4, 16), 2)
    pos = np.random.default_rng(3).integers(0, 500, (2, 7)).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("index,lens", [
    ([0, 3, 10], [4, 0, 2]),      # per row, a zero-length row
    ([12, 13, 0], [4, 3, 4]),     # window clamped at the cache end
    ([2, 5, 9], None),            # per row, no lengths (decode contract)
    ([2, 14, 20], None),          # a retired row whose index ran past L
    (6, None),                    # scalar index
])
def test_cache_update_matches_jax(index, lens):
    cache = _rand((3, 16, 2, 4), 4)
    upd = _rand((3, 4, 2, 4), 5)
    idx = np.asarray(index, np.int32)
    want = JL.cache_update(jnp.asarray(cache), jnp.asarray(upd),
                           jnp.asarray(idx),
                           None if lens is None else jnp.asarray(lens))
    t_idx = torch.from_numpy(idx) if idx.ndim else int(idx)
    t_cache = torch.from_numpy(cache.copy())
    got = L.cache_update(t_cache, torch.from_numpy(upd), t_idx,
                         None if lens is None else torch.tensor(lens))
    assert got is t_cache                       # written in place
    np.testing.assert_array_equal(_np(got), _np(want))


def test_attention_apply_with_cache_matches_jax(smoke):
    cfg, _, params, jcfg, _, jparams = smoke
    B, S, T = 3, 5, 16
    x = _rand((B, S, cfg.d_model), 6)
    idx = np.array([0, 4, 9], np.int32)
    lens = np.array([5, 2, 0], np.int32)
    pos = idx[:, None] + np.arange(S, dtype=np.int32)[None]
    cache = {k: _rand((B, T, cfg.kv_heads, cfg.hd), 7 + i).astype(
        jnp.bfloat16) for i, k in enumerate("kv")}
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    jy, jc = JL.attention_apply(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
        kv_cache={k: jnp.asarray(v) for k, v in cache.items()},
        cache_index=jnp.asarray(idx), seq_lens=jnp.asarray(lens))
    tc = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in cache.items()}
    ty, tc = L.attention_apply(
        params.blocks[0].attn, torch.from_numpy(x), cfg,
        positions=torch.from_numpy(pos).long(), kv_cache=tc,
        cache_index=torch.from_numpy(idx).long(),
        seq_lens=torch.from_numpy(lens).long())
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for k in "kv":
        _cache_close(tc[k], jc[k])


def test_attention_apply_without_cache_matches_jax(smoke):
    cfg, _, params, jcfg, _, jparams = smoke
    x = _rand((2, 6, cfg.d_model), 9)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["attn"])
    jy, _ = JL.attention_apply(jp, jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos))
    ty, cache = L.attention_apply(params.blocks[1].attn, torch.from_numpy(x),
                                  cfg, positions=torch.from_numpy(pos).long())
    assert cache is None
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)


def test_query_chunked_sdpa_matches_jax():
    """Sq = 2 * Q_CHUNK takes the query-chunked path in both packages."""
    S = 2 * L.Q_CHUNK
    q, k, v = _rand((1, S, 2, 8), 10), _rand((1, S, 1, 8), 11), _rand(
        (1, S, 1, 8), 12)
    got = L._sdpa(*map(torch.from_numpy, (q, k, v)), causal=True)
    want = JL._sdpa(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_swiglu_matches_jax(smoke):
    cfg, _, params, jcfg, _, jparams = smoke
    x = _rand((2, 3, cfg.d_model), 8)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["mlp"])
    np.testing.assert_allclose(
        _np(L.swiglu_apply(params.blocks[1].mlp, torch.from_numpy(x), cfg)),
        _np(JL.swiglu_apply(jp, jnp.asarray(x), jcfg)), **TOL)


def test_slot_state_splice_in_place(smoke):
    cfg, api, *_ = smoke
    axes = L.state_batch_axes(api.init_state(cfg, 1, 8, device="meta"),
                              api.init_state(cfg, 2, 8, device="meta"))
    assert axes == {"kv": {"k": 1, "v": 1}, "index": 0}
    src = api.init_state(cfg, 2, 8, device="cpu")
    src["kv"]["k"].normal_()
    src["index"] += torch.tensor([3, 5])
    dst = api.init_state(cfg, 4, 8, device="cpu")
    out = L.insert_slot_state(dst, L.take_slot_state(src, axes, 1), axes, 2)
    assert out is dst
    assert torch.equal(dst["kv"]["k"][:, 2], src["kv"]["k"][:, 1])
    assert dst["index"].tolist() == [0, 0, 5, 0]
    assert not dst["kv"]["k"][:, [0, 1, 3]].any()


# ---------------------------------------------------------------------------
# whole-model forwards against JAX
# ---------------------------------------------------------------------------


def _tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "codeqwen1.5-7b",
                                  "qwen2.5-14b"])
def test_other_dense_configs_prefill_matches_jax(arch):
    """The GELU FFN without gate (starcoder2), multi-head attention with
    as many KV heads as heads (codeqwen) and qwen2.5-14b's smoke config:
    prefill logits and cache against the JAX package's. Both packages are
    given an f32 KV cache, so nothing is rounded to bf16 on the way and the
    f32 tolerance holds for the whole model (with the default bf16 cache
    one key flipped by a bf16 step moves codeqwen's logits by 2.6e-4)."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as tfm

    jcfg = jget_config(arch, smoke=True)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(2), jcfg)
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    params = params_from_numpy(_to_numpy_tree(jparams), cfg, device="cpu")
    assert ("w_gate" in params.blocks[0].mlp) == cfg.gated_mlp
    toks, lens = _tokens((3, 12), 11), np.array([12, 5, 9], np.int32)
    jl, js = japi.prefill(
        jparams, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens),
                  "cache": jtfm.init_kv_cache(jcfg, 3, 32, jnp.float32)},
        jcfg, max_len=32)
    tl, ts = api.prefill(
        params, {"tokens": _t(toks), "lengths": _t(lens),
                 "cache": tfm.init_kv_cache(cfg, 3, 32, torch.float32,
                                            device="cpu")},
        cfg, max_len=32)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert ts["index"].tolist() == lens.tolist()
    for k in "kv":
        np.testing.assert_allclose(_np(ts["kv"][k]), _np(js["kv"][k]), **TOL)


def test_paged_prefill_chunk_and_decode_match_jax(smoke):
    """Two chunk calls and two decode steps through the paged cache: the
    rows own shuffled pages of one pool, a dead row points at the null
    page; logits, the pool and the index against the JAX package's paged
    forward, and the logits bit-identical to the port's dense forward."""
    cfg, api, params, jcfg, japi, jparams = smoke
    W, C, T, n = 3, 8, 8, 4
    table = np.array([[5, 2, 9, 7], [0, 0, 0, 0], [3, 11, 1, 8]], np.int32)
    pool = api.init_page_pool(cfg, 13, T, device="cpu")
    jpool = jax.tree.map(jnp.asarray, {k: _np(v) for k, v in pool.items()})
    jpool = {k: v.astype(jnp.bfloat16) for k, v in jpool.items()}
    jtable = jnp.broadcast_to(jnp.asarray(table)[None], (cfg.n_layers, W, n))
    tstate = {"kv": {**pool, "table": torch.from_numpy(table).long()[None]
                     .expand(cfg.n_layers, W, n)},
              "index": torch.zeros(W, dtype=torch.long)}
    jstate = {"kv": {**jpool, "table": jtable},
              "index": jnp.zeros((W,), jnp.int32)}
    dstate = api.init_state(cfg, W, n * T, device="cpu")
    prompts = [_tokens((n,), 50 + n) for n in (13, 0, 9)]
    base = np.zeros(W, np.int32)
    for step in range(2):
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
        dl, dstate = api.prefill_chunk(params, _t(toks), _t(lens), dstate,
                                       cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL)
        assert torch.equal(tl[[0, 2]], dl[[0, 2]])
        base += lens
    tok = _tokens((W,), 60)
    for step in range(2):
        jl, jstate = japi.decode_step(jparams, jnp.asarray(tok), jstate, jcfg)
        tl, tstate = api.decode_step(params, _t(tok), tstate, cfg)
        dl, dstate = api.decode_step(params, _t(tok), dstate, cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL)
        assert torch.equal(tl[[0, 2]], dl[[0, 2]])
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tstate["index"].tolist() == np.asarray(jstate["index"]).tolist()
    for k in ("k_pages", "v_pages"):
        _cache_close(tstate["kv"][k], jstate["kv"][k])
        assert not tstate["kv"][k][:, 0].any()       # the null page


def test_lm_prefill_matches_jax(smoke):
    cfg, api, params, jcfg, japi, jparams = smoke
    toks, lens = _tokens((3, 12), 10), np.array([12, 7, 1], np.int32)
    jl, js = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)}, jcfg,
                          max_len=32)
    tl, ts = api.prefill(params, {"tokens": _t(toks), "lengths": _t(lens)},
                         cfg, max_len=32)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL)
    assert ts["index"].tolist() == lens.tolist()
    _cache_close(ts["kv"]["v"], js["kv"]["v"])
    # without lengths: every row is S tokens, scalar index
    jl, js = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, ts = api.prefill(params, {"tokens": _t(toks)}, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL)
    assert int(ts["index"]) == 12


def test_multi_chunk_prefill_and_decode_match_jax(smoke):
    """Three chunk calls over rows of different lengths (one row is zero-
    length in every call, one finishes early and rides along at length 0),
    then decode steps at per-row positions."""
    cfg, api, params, jcfg, japi, jparams = smoke
    W, C, T = 4, 8, 48
    prompts = [_tokens((n,), 20 + n) for n in (20, 5, 0, 13)]
    jstate = japi.init_state(jcfg, W, T)
    tstate = api.init_state(cfg, W, T, device="cpu")
    base = np.zeros(W, np.int32)
    for step in range(3):
        toks = np.zeros((W, C), np.int32)
        lens = np.zeros(W, np.int32)
        for r, p in enumerate(prompts):
            n = min(C, len(p) - base[r])
            toks[r, :n] = p[base[r]:base[r] + n]
            lens[r] = n
        jl, jstate = japi.prefill_chunk(jparams, jnp.asarray(toks),
                                        jnp.asarray(lens), jstate, jcfg)
        tl, tstate = api.prefill_chunk(params, _t(toks), _t(lens), tstate,
                                       cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL,
                                   err_msg=step)
        base += lens
        assert tstate["index"].tolist() == np.asarray(jstate["index"]).tolist()
    for k in "kv":
        _cache_close(tstate["kv"][k], jstate["kv"][k])
    tok = _tokens((W,), 30)
    for step in range(3):
        jl, jstate = japi.decode_step(jparams, jnp.asarray(tok), jstate, jcfg)
        tl, tstate = api.decode_step(params, _t(tok), tstate, cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL_MODEL,
                                   err_msg=step)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tstate["index"].tolist() == np.asarray(jstate["index"]).tolist()


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_logits_equal_single_shot_prefill(smoke, chunk):
    """Inside the port: prompts prefilled chunk by chunk give the logits
    (and the KV cache) of one `lm_prefill` over the whole prompts."""
    cfg, api, params, *_ = smoke
    lens = np.array([13, 6, 16], np.int32)
    toks = _tokens((3, 16), 40)
    T = 32
    whole, wstate = api.prefill(params, {"tokens": _t(toks),
                                         "lengths": _t(lens)}, cfg, max_len=T)
    state = api.init_state(cfg, 3, T, device="cpu")
    last = torch.zeros_like(whole)
    for lo in range(0, 16, chunk):
        n = np.clip(lens - lo, 0, chunk)
        logits, state = api.prefill_chunk(params, _t(toks[:, lo:lo + chunk]),
                                          _t(n), state, cfg)
        done = (n > 0) & (lo + n == lens)
        last[torch.from_numpy(done)] = logits[torch.from_numpy(done)]
    torch.testing.assert_close(last, whole, rtol=1e-6, atol=1e-6)
    assert state["index"].tolist() == lens.tolist()
    for r, n in enumerate(lens):
        assert torch.equal(state["kv"]["k"][:, r, :n],
                           wstate["kv"]["k"][:, r, :n])
