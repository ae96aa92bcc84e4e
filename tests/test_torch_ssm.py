"""The port's SSM and hybrid models against the JAX package's, on the CPU.

The JAX parameters go through `bridge.params_from_numpy`, so both packages
run the same weights; inputs are made from a seed with numpy. Tolerances
are ROADMAP's: one op or block in f32 1e-5 (scaled by the output's
magnitude: the two frameworks sum in different orders, and the port's scan
adds its in-block prefix in step order where JAX runs an associative
scan), whole-model logits 1e-4 (the hybrid's bf16 KV cache may flip an
entry by one bf16 step), integer state exactly. Inside the port two
invariants are bit-exact, as in the reference's own tests
(`tests/test_chunked_prefill.py`): a scan split at a block boundary equals
the whole scan, and a prompt prefilled in chunks leaves the state of one
single-shot prefill.
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
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import gemm_shape_counts as jgemm_shape_counts
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import hybrid, ssm
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.config import ModelConfig, gemm_shape_counts
from repro_torch.models.registry import get_model

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
KINDS = ("mamba1", "mamba2", "hybrid")

# the reference's chunked-prefill test family sizes
BASE = dict(name="ssm-test", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, vocab=128, param_dtype="float32",
            activation_dtype="float32", remat=False)
FAMILY_KW = {
    "mamba1": dict(d_ff=0, ssm_state=8, expand=2, d_conv=4),
    "mamba2": dict(d_ff=0, ssm_state=8, expand=2, d_conv=4,
                   ssm_headdim=16, ssm_ngroups=1),
    "hybrid": dict(d_ff=128, ssm_state=8, expand=2, d_conv=4,
                   ssm_headdim=16, ssm_ngroups=1, attn_every=2),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL) -> None:
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _pair(jcfg: JModelConfig, seed: int = 0):
    """(port (cfg, api, params), jax (cfg, api, params)): the same weights
    in both packages."""
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(seed), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


@pytest.fixture(scope="module")
def families():
    return {kind: _pair(JModelConfig(kind=kind, **{**BASE, **kw}))
            for kind, kw in FAMILY_KW.items()}


# ---------------------------------------------------------------------------
# configs, counts, fleet, registry, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(arch, smoke):
    port, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.d_inner, port.attention_free, port.sub_quadratic,
            port.n_params()) == (ref.d_inner, ref.attention_free,
                                 ref.sub_quadratic, ref.n_params())
    assert arch in list_archs()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_gemm_shape_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kw in ({}, {"head_tokens": 4}, {"head_tokens": 1}):
        for t in (0, 1, 4, 64, 2048):
            assert gemm_shape_counts(cfg, t, **kw) == jgemm_shape_counts(
                jcfg, t, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_family_counts_equal_the_reference(kind):
    jcfg = JModelConfig(kind=kind, **{**BASE, **FAMILY_KW[kind]})
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    for t in (1, 8, 96):
        assert gemm_shape_counts(cfg, t, head_tokens=2) == \
            jgemm_shape_counts(jcfg, t, head_tokens=2)


def test_hybrid_counts_hold_the_ssd_in_proj():
    """The hybrid's SSD in_proj carries B/C and the dt channel (zamba2:
    N = 10448), not mamba1's 2 d_inner, and its 9 shared-attention
    applications with their FFN."""
    cfg = get_config("zamba2-2.7b")
    counts = gemm_shape_counts(cfg, 4)
    assert counts[(4, 10448, 2560)] == 54                 # SSD in_proj
    assert counts[(4, 2560, 5120)] == 54                  # out_proj
    assert counts[(4, 2560, 2560)] == 4 * 9               # Q, K, V, O
    assert counts[(4, 10240, 2560)] == 2 * 9              # gate, up only
    assert counts[(4, 2560, 10240)] == 9                  # FFN down
    assert counts[(4, 32000, 2560)] == 1                  # LM head


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("grain", [8, 16])
@pytest.mark.parametrize("kw", [
    dict(max_batch=4, max_len=512, chunk_tokens=64, lane_width=8),
    dict(max_batch=4, max_len=512),
    dict(max_batch=2, max_len=60, chunk_tokens=64),
])
def test_serving_gemm_fleet_equals_the_reference(arch, grain, kw):
    assert (ops.serving_gemm_fleet(get_config(arch), grain=grain, **kw)
            == jops.serving_gemm_fleet(jget_config(arch), grain=grain, **kw))


@pytest.mark.parametrize("kind", KINDS)
def test_registry_serves_the_family_without_a_page_pool(kind):
    cfg = ModelConfig(kind=kind, **{**BASE, **FAMILY_KW[kind]})
    api = get_model(cfg)
    assert api.init_page_pool is None
    assert api.prefill_chunk is not None and api.init_state is not None
    st = api.init_state(cfg, 3, 16, device="cpu")
    key = "cache" if kind == "hybrid" else "kv"
    assert set(st) == {key, "index"} and st["index"].shape == (3,)


@pytest.mark.parametrize("kind", KINDS)
def test_bridge_round_trip_is_exact(families, kind):
    (cfg, _, params), (_, _, jparams) = families[kind]
    back = params_to_numpy(params)
    want = jax.tree.map(np.asarray, jparams)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    jax.tree.map(np.testing.assert_array_equal, back, want)


def test_bridge_keeps_a_log_and_d_in_f32():
    """Under bf16 parameters the SSM's A_log and D stay float32, as in the
    reference."""
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="bfloat16")
        model = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        blk = model.blocks[0].ssm
        assert blk["A_log"].dtype == blk["D"].dtype == torch.float32
        assert blk["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_follows_the_reference_leaves(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    s = model.blocks[0].ssm
    jparams = jget_model(jget_config(arch, smoke=True)).init(
        jax.random.key(0), jget_config(arch, smoke=True))
    jblk = jax.tree.map(lambda a: np.asarray(a)[0] if np.ndim(a) else a,
                        jparams["blocks"])
    if arch == "zamba2-2.7b":
        jblk = jax.tree.map(lambda a: a[0], jblk)
    for leaf in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(_np(s[leaf]), jblk["ssm"][leaf])
    _close(s["A_log"], jblk["ssm"]["A_log"])    # torch's and XLA's log
    if "norm_scale" in s:
        np.testing.assert_array_equal(_np(s["norm_scale"]),
                                      jblk["ssm"]["norm_scale"])
    conv = _np(s["conv_w"])
    assert abs(conv.std() * np.sqrt(cfg.d_conv) - 1.0) < 0.2


# ---------------------------------------------------------------------------
# conv and scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv_matches_jax(with_history):
    B, S, C, K = 2, 11, 16, 4
    x, w, b = _rand((B, S, C), 0), _rand((C, K), 1), _rand((C,), 2)
    hist = _rand((B, K - 1, C), 3) if with_history else None
    got = ssm.causal_conv(_t(x), _t(w), _t(b),
                          None if hist is None else _t(hist))
    want = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            None if hist is None else jnp.asarray(hist))
    _close(got, want)


def test_conv_history_carries_last_valid_inputs():
    """The reference's oracle: full rows carry their last K-1 inputs,
    zero-length rows their history, partial rows the K-1 inputs ending at
    their last valid position; and the port equals JAX on each."""
    B, K1, S, C = 2, 3, 8, 4
    hist = np.arange(B * K1 * C, dtype=np.float32).reshape(B, K1, C)
    x = 100 + np.arange(B * S * C, dtype=np.float32).reshape(B, S, C)
    for lens in ([S, 0], [5, 2]):
        got = _np(ssm.conv_history(_t(hist), _t(x), torch.tensor(lens)))
        want = np.asarray(jssm.conv_history(jnp.asarray(hist),
                                            jnp.asarray(x),
                                            jnp.asarray(lens, jnp.int32)))
        np.testing.assert_array_equal(got, want)
    out = _np(ssm.conv_history(_t(hist), _t(x), torch.tensor([S, 0])))
    np.testing.assert_array_equal(out[0], x[0, -K1:])
    np.testing.assert_array_equal(out[1], hist[1])


def _mamba1_inputs(S, B=2, di=4, ds=3, seed=0):
    decay = np.exp(-np.abs(_rand((B, S, di, ds), seed)))
    return (decay, _rand((B, S, di, ds), seed + 1),
            _rand((B, S, ds), seed + 2), _rand((B, di, ds), seed + 3))


def _ssd_inputs(S, B=2, H=2, N=4, P=4, seed=1):
    return (_rand((B, S, H, P), seed), -np.abs(_rand((B, S, H), seed + 1)),
            _rand((B, S, N), seed + 2), _rand((B, S, N), seed + 3),
            _rand((B, H, N, P), seed + 4))


@pytest.mark.parametrize("S,chunk", [(48, 8), (21, 8), (5, 8), (40, 16),
                                     (130, 128)])
def test_mamba1_scan_matches_jax(S, chunk):
    args = _mamba1_inputs(S)
    y, h = ssm.mamba1_scan(*map(_t, args), chunk=chunk)
    jy, jh = jssm.mamba1_scan(*map(jnp.asarray, args), chunk=chunk)
    assert y.shape == (2, S, 4)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("S,chunk", [(48, 8), (21, 8), (5, 8), (40, 16)])
def test_ssd_scan_matches_jax(S, chunk):
    args = _ssd_inputs(S)
    y, h = ssm.ssd_scan(*map(_t, args), chunk=chunk)
    jy, jh = jssm.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    assert y.shape == (2, S, 2, 4)
    _close(y, jy)
    _close(h, jh)


def test_mamba1_scan_boundary_split_is_exact():
    decay, inp, C, h0 = map(_t, _mamba1_inputs(48))
    y, h = ssm.mamba1_scan(decay, inp, C, h0, chunk=8)
    y1, h1 = ssm.mamba1_scan(decay[:, :32], inp[:, :32], C[:, :32], h0,
                             chunk=8)
    y2, h2 = ssm.mamba1_scan(decay[:, 32:], inp[:, 32:], C[:, 32:], h1,
                             chunk=8)
    assert torch.equal(h, h2)
    assert torch.equal(y, torch.cat([y1, y2], 1))


def test_mamba1_scan_pads_non_divisible_tail():
    """The identity tail is bit-transparent: the first 16 positions of a
    21-step scan equal a 16-step scan's."""
    decay, inp, C, h0 = map(_t, _mamba1_inputs(21))
    y, _ = ssm.mamba1_scan(decay, inp, C, h0, chunk=8)
    yf, _ = ssm.mamba1_scan(decay[:, :16], inp[:, :16], C[:, :16], h0,
                            chunk=8)
    assert y.shape[1] == 21 and torch.equal(y[:, :16], yf)


def test_ssd_scan_boundary_split_is_exact():
    x, a, Bm, Cm, h0 = map(_t, _ssd_inputs(48))
    y, h = ssm.ssd_scan(x, a, Bm, Cm, h0, chunk=8)
    y1, h1 = ssm.ssd_scan(x[:, :32], a[:, :32], Bm[:, :32], Cm[:, :32], h0,
                          chunk=8)
    y2, h2 = ssm.ssd_scan(x[:, 32:], a[:, 32:], Bm[:, 32:], Cm[:, 32:], h1,
                          chunk=8)
    assert torch.equal(h, h2)
    assert torch.equal(y, torch.cat([y1, y2], 1))


def test_ssd_scan_pads_non_divisible_tail():
    x, a, Bm, Cm, h0 = map(_t, _ssd_inputs(21))
    y, _ = ssm.ssd_scan(x, a, Bm, Cm, h0, chunk=8)
    yf, _ = ssm.ssd_scan(x[:, :16], a[:, :16], Bm[:, :16], Cm[:, :16], h0,
                         chunk=8)
    assert y.shape[1] == 21 and torch.equal(y[:, :16], yf)


def test_scans_do_not_mix_rows():
    """Row 0's outputs and state do not depend on the rows beside it."""
    args = _mamba1_inputs(24, B=3)
    y, h = ssm.mamba1_scan(*map(_t, args), chunk=8)
    y1, h1 = ssm.mamba1_scan(*(_t(a[:1]) for a in args), chunk=8)
    assert torch.equal(y[:1], y1) and torch.equal(h[:1], h1)
    args = _ssd_inputs(24, B=3)
    y, h = ssm.ssd_scan(*map(_t, args), chunk=8)
    y1, h1 = ssm.ssd_scan(*(_t(a[:1]) for a in args), chunk=8)
    assert torch.equal(y[:1], y1) and torch.equal(h[:1], h1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

_BLOCK = {"mamba1": (jssm.mamba1_block_apply, ssm.mamba1_block_apply),
          "mamba2": (jssm.mamba2_block_apply, ssm.mamba2_block_apply)}


def _block_pair(families, kind):
    (cfg, _, params), (jcfg, _, jparams) = families[kind]
    jblk = jax.tree.map(lambda a: a[0], jparams["blocks"])
    return cfg, params.blocks[0], jcfg, jblk


def _layer_cache(kind, cfg, B, seed):
    """A random f32 layer cache (conv history, SSM state) for both
    packages."""
    if kind == "mamba1":
        conv = (B, cfg.d_conv - 1, cfg.d_inner)
        state = (B, cfg.d_inner, cfg.ssm_state)
    else:
        H = cfg.d_inner // cfg.ssm_headdim
        conv = (B, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
        state = (B, H, cfg.ssm_state, cfg.ssm_headdim)
    return {"conv": _rand(conv, seed), "ssm": 0.5 * _rand(state, seed + 1)}


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
@pytest.mark.parametrize("S,cached,lens", [
    (13, False, None),          # no cache: the training path's CHUNK blocks
    (16, True, None),           # a full prefill into a carried state
    (16, True, [16, 9]),        # a right-padded chunk
    (8, True, [0, 5]),          # a zero-length row keeps its state
    (1, True, None),            # one decode step
])
def test_block_matches_jax(families, kind, S, cached, lens):
    cfg, blk, jcfg, jblk = _block_pair(families, kind)
    japply, apply = _BLOCK[kind]
    B = 2
    x = _rand((B, S, cfg.d_model), 5)
    cache = _layer_cache(kind, cfg, B, 7) if cached else None
    seq = None if lens is None else np.asarray(lens, np.int32)
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    got, new, _ = apply(blk, _t(x), cfg, positions=None, cache=tcache,
                        seq_lens=None if seq is None else torch.tensor(lens))
    want, jnew, _ = japply(
        jblk, jnp.asarray(x), jcfg, positions=None,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache),
        seq_lens=None if seq is None else jnp.asarray(seq))
    _close(got, want)
    if cached:
        assert new is tcache            # written in place
        for k in ("conv", "ssm"):
            _close(new[k], jnew[k])
        if lens is not None and 0 in lens:
            r = lens.index(0)
            for k in ("conv", "ssm"):
                np.testing.assert_array_equal(_np(new[k][r]), cache[k][r])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _key(kind):
    return "cache" if kind == "hybrid" else "kv"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _prompts(vocab, B=2, S=21, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)
    return toks, np.array([S, 13][:B], np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_chunk_and_decode_logits_match_jax(families, kind):
    """A right-padded prefill, then a chunk on top of it and two decode
    steps, through both packages: logits at 1e-4, the SSM state at f32
    tolerance, the index exactly."""
    (cfg, api, params), (jcfg, japi, jparams) = families[kind]
    toks, lens = _prompts(cfg.vocab)
    logits, st = api.prefill(params, {"tokens": torch.as_tensor(toks).long(),
                                      "lengths": torch.as_tensor(lens)},
                             cfg, max_len=64)
    jlogits, jst = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                          "lengths": jnp.asarray(lens)},
                                jcfg, max_len=64)
    _close(logits, jlogits, TOL_MODEL)
    ch = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    clens = np.array([8, 3], np.int32)
    logits, st = api.prefill_chunk(params, torch.as_tensor(ch).long(),
                                   torch.as_tensor(clens), st, cfg)
    jlogits, jst = japi.prefill_chunk(jparams, jnp.asarray(ch),
                                      jnp.asarray(clens), jst, jcfg)
    _close(logits, jlogits, TOL_MODEL)
    np.testing.assert_array_equal(st["index"].numpy(),
                                  np.asarray(jst["index"]))
    tok = np.array([5, 9], np.int32)
    for _ in range(2):
        logits, st = api.decode_step(params, torch.as_tensor(tok).long(),
                                     st, cfg)
        jlogits, jst = japi.decode_step(jparams, jnp.asarray(tok), jst, jcfg)
        _close(logits, jlogits, TOL_MODEL)
        tok = np.asarray(jlogits).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(st["index"].numpy(),
                                  np.asarray(jst["index"]))
    mamba = st[_key(kind)]
    jmamba = jst[_key(kind)]
    if kind == "hybrid":
        mamba, jmamba = mamba["mamba"], jmamba["mamba"]
    for got, want in zip(_leaves(mamba), _leaves(
            jax.tree.map(np.asarray, jmamba))):
        _close(got, want, TOL_MODEL)


@pytest.mark.parametrize("kind", KINDS)
def test_unpadded_prefill_matches_jax(families, kind):
    """Without lengths: the logits at S-1 and a scalar index."""
    (cfg, api, params), (jcfg, japi, jparams) = families[kind]
    toks, _ = _prompts(cfg.vocab, S=11)
    logits, st = api.prefill(params, {"tokens": torch.as_tensor(toks).long()},
                             cfg, max_len=32)
    jlogits, jst = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                jcfg, max_len=32)
    _close(logits, jlogits, TOL_MODEL)
    assert int(st["index"]) == int(jst["index"]) == 11


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_state_matches_unchunked_prefill(families, kind):
    """The reference's `test_ssm_state_matches_unchunked_prefill` in the
    port: the conv and scan state after chunked prefill is bit-identical to
    a single-shot prefill's (hybrid: its Mamba2 state; the shared block's
    KV cache holds bucket-dependent pad past each path's written rows)."""
    (cfg, api, params), _ = families[kind]
    p = np.random.default_rng(42).integers(0, cfg.vocab, 21).astype(np.int32)
    n, max_len = len(p), 64
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = p
    _, ref = api.prefill(params, {"tokens": torch.as_tensor(toks).long(),
                                  "lengths": torch.tensor([n])},
                         cfg, max_len=max_len)
    st = api.init_state(cfg, 1, max_len, device="cpu")
    for lo in range(0, n, 8):
        ln = min(8, n - lo)
        ch = np.zeros((1, 8), np.int32)
        ch[0, :ln] = p[lo:lo + ln]
        _, st = api.prefill_chunk(params, torch.as_tensor(ch).long(),
                                  torch.tensor([ln]), st, cfg)
    assert torch.equal(st["index"], ref["index"])
    got, want = st[_key(kind)], ref[_key(kind)]
    if kind == "hybrid":
        got, want = got["mamba"], want["mamba"]
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def smoke_pairs():
    return {arch: _pair(jget_config(arch, smoke=True)) for arch in SSM_ARCHS}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_smoke_configs_logits_match_jax(smoke_pairs, arch):
    """The two configs' smoke variants (falcon-mamba's tied head through
    ``transpose_b``, zamba2's two groups sharing one attention block):
    prefill and decode logits at 1e-4."""
    (cfg, api, params), (jcfg, japi, jparams) = smoke_pairs[arch]
    assert cfg.tie_embeddings == (arch == "falcon-mamba-7b")
    toks, lens = _prompts(cfg.vocab, S=19)
    logits, st = api.prefill(params, {"tokens": torch.as_tensor(toks).long(),
                                      "lengths": torch.as_tensor(lens)},
                             cfg, max_len=32)
    jlogits, jst = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                          "lengths": jnp.asarray(lens)},
                                jcfg, max_len=32)
    _close(logits, jlogits, TOL_MODEL)
    tok = np.asarray(jlogits).argmax(-1).astype(np.int32)
    logits, _ = api.decode_step(params, torch.as_tensor(tok).long(), st, cfg)
    jlogits, _ = japi.decode_step(jparams, jnp.asarray(tok), jst, jcfg)
    _close(logits, jlogits, TOL_MODEL)


def test_hybrid_attention_caches_are_per_application(smoke_pairs):
    """Each application of the shared block writes its own KV cache."""
    (cfg, api, params), _ = smoke_pairs["zamba2-2.7b"]
    toks, lens = _prompts(cfg.vocab)
    _, st = api.prefill(params, {"tokens": torch.as_tensor(toks).long(),
                                 "lengths": torch.as_tensor(lens)},
                        cfg, max_len=32)
    k = st["cache"]["attn"]["k"]
    assert k.shape == (hybrid.n_groups(cfg), 2, 32, cfg.kv_heads, cfg.hd)
    assert k.dtype == torch.bfloat16
    assert not torch.equal(k[0], k[1]) and bool(k[1].abs().sum() > 0)
