"""The port's encoder-decoder model (kind encdec) against the JAX
package's, on the CPU.

The JAX parameters go through `bridge.params_from_numpy`, so both packages
run the same weights; inputs are made from a seed with numpy. Two configs:
seamless-m4t-medium's smoke config (SwiGLU FFN) and `FAMILY_KW`'s encdec
of `tests/test_chunked_prefill.py` (plain GELU FFN, GQA). Both are f32 end
to end except the KV and cross-KV caches, which both packages keep in bf16.
Tolerances are ROADMAP's: f32 outputs of one function 1e-5 (scaled by the
output's magnitude: the two frameworks sum in different orders),
whole-model logits 1e-4 (a bf16 cache entry may flip by one bf16 step),
packed batches and integer state exactly.
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
from repro.models import encdec as jencdec
from repro.models import layers as jL
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import gemm_shape_counts as jgemm_shape_counts
from repro.models.config import kv_cache_bytes as jkv_cache_bytes
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.config import (ModelConfig, gemm_shape_counts,
                                       kv_cache_bytes)
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import head_params

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-medium"
# tests/test_chunked_prefill.py's encdec: GQA, plain GELU FFN
FAMILY = JModelConfig(name="chunk-test", kind="encdec", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, vocab=128,
                      param_dtype="float32", activation_dtype="float32",
                      remat=False, d_ff=128, n_encoder_layers=2,
                      gated_mlp=False)
SRC = (12, 7, 3, 9)          # source frames per row, bucket 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


def _close(got, want, tol=TOL) -> None:
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _cache_close(got, want) -> None:
    """bf16 caches equal but for rare entries one bf16 step apart."""
    got, want = _np(got), _np(want)
    assert (got != want).mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def _pair(jcfg: JModelConfig):
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


@pytest.fixture(scope="module", params=["smoke", "family"])
def pair(request):
    return _pair(jget_config(ARCH, smoke=True) if request.param == "smoke"
                 else FAMILY)


def _extras(d: int) -> list:
    return [{"src_embeds": np.random.default_rng(400 + i).standard_normal(
        (t, d)).astype(np.float32)} for i, t in enumerate(SRC)]


# ---------------------------------------------------------------------------
# config, bridge, head, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_config_equals_jax_field_by_field(smoke_cfg):
    port, ref = get_config(ARCH, smoke=smoke_cfg), jget_config(
        ARCH, smoke=smoke_cfg)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.hd, port.kv_heads, port.n_params()) == (
        ref.hd, ref.kv_heads, ref.n_params())


def test_bridge_round_trip(pair):
    """The encoder and decoder stacks, enc_ln_f, cross_attn and ln_x."""
    (cfg, _, params), (_, _, jparams) = pair
    tree = jax.tree.map(np.asarray, jparams)
    assert set(tree) == {"embed", "encoder", "enc_ln_f", "decoder", "ln_f",
                         "head"}
    back = params_to_numpy(params)
    flat_in, tdef_in = jax.tree.flatten(tree)
    flat_out, tdef_out = jax.tree.flatten(back)
    assert tdef_in == tdef_out
    for a, b in zip(flat_in, flat_out):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_a_missing_decoder_leaf(pair):
    (cfg, _, params), _ = pair
    tree = params_to_numpy(params)
    del tree["decoder"]["cross_attn"]["wk"]
    with pytest.raises(ValueError, match="decoder.cross_attn"):
        params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("vocab,stored", [(256206, 256208), (256, 256),
                                          (13, 16)])
def test_head_rows_are_stored_on_a_multiple_of_8(vocab, stored):
    """seamless-m4t-medium's head (vocab 256206) is a (d, vocab) view of
    (d, 256208) storage: a row stride the GEMM's fast paths take. Only the
    view is a parameter."""
    p = head_params("meta", torch.bfloat16, 8, vocab)
    assert tuple(p["w"].shape) == (8, vocab)
    assert p["w"].stride() == (stored, 1)
    assert list(dict(p.named_parameters())) == ["w"]


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_gemm_counts_and_admission_fleet_equal_the_reference(smoke_cfg):
    """The KV bytes per cached token; the GEMM counts: the decoder's self
    and cross Q/O and self K/V on every call, the encoder and cross-KV over
    `src_tokens` rows at admission; the fleet's admission grid over every
    prefill bucket at pow2 widths through the lane and the full batch."""
    cfg, jcfg = get_config(ARCH, smoke=smoke_cfg), jget_config(
        ARCH, smoke=smoke_cfg)
    for t in (0, 1, 4, 64):
        assert kv_cache_bytes(cfg, t) == jkv_cache_bytes(jcfg, t)
        for kw in ({}, {"head_tokens": 4}, {"src_tokens": 0},
                   {"src_tokens": 200}, {"head_tokens": 0,
                                         "src_tokens": 1024}):
            assert gemm_shape_counts(cfg, t, **kw) == jgemm_shape_counts(
                jcfg, t, **kw)
    for kw in (dict(max_batch=4, max_len=512, chunk_tokens=64,
                    lane_width=8),
               dict(max_batch=4, max_len=512),
               dict(max_batch=2, max_len=64, chunk_tokens=8)):
        assert (ops.serving_gemm_fleet(cfg, **kw)
                == jops.serving_gemm_fleet(jcfg, **kw))
    # one admission of a 200-frame source at bucket 256: the encoder's 6
    # and the decoder's 2 cross-KV GEMMs a layer, no decoder row, no head
    full = get_config(ARCH)
    counts = gemm_shape_counts(full, 0, head_tokens=0, src_tokens=256)
    assert sum(counts.values()) == 12 * 6 + 12 * 2
    assert all(m == 256 for m, _, _ in counts)


# ---------------------------------------------------------------------------
# the encoder and the admission
# ---------------------------------------------------------------------------


def test_non_causal_attention_with_kv_lens_matches_jax(pair):
    """The encoder's attention: non-causal over right-padded keys masked
    per row by `kv_lens`."""
    (cfg, _, params), (jcfg, _, jparams) = pair
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (4, 16))
    lens = np.array(SRC, np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["encoder"]["attn"])
    want, _ = jL.attention_apply(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), causal=False,
                                 kv_lens=jnp.asarray(lens))
    got, _ = L.attention_apply(params.encoder[0].attn, torch.from_numpy(x),
                               cfg, positions=_t(pos), causal=False,
                               kv_lens=_t(lens))
    for r, n in enumerate(SRC):
        _close(got[r, :n], want[r, :n])


def test_encode_matches_jax(pair):
    (cfg, _, params), (jcfg, _, jparams) = pair
    src = np.random.default_rng(8).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)
    lens = np.array(SRC, np.int32)
    want = jencdec.encode(jparams, jnp.asarray(src), jcfg,
                          src_lens=jnp.asarray(lens))
    got = encdec.encode(params, torch.from_numpy(src), cfg,
                        src_lens=_t(lens))
    for r, n in enumerate(SRC):
        _close(got[r, :n], want[r, :n])


def test_pack_admit_equals_the_reference(pair):
    (cfg, api, _), (jcfg, japi, _) = pair
    extras = _extras(cfg.d_model)
    got = api.pack_admit(cfg, extras + [None], 8, 16, device="cpu")
    want = japi.pack_admit(jcfg, extras + [None], 8, 16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert [api.admit_dims(cfg, e) for e in extras] == [
        japi.admit_dims(jcfg, e) for e in extras] == [(0, t) for t in SRC]
    for dims in (api.admit_dims, japi.admit_dims):
        with pytest.raises(ValueError, match="src_embeds"):
            dims(cfg, None)


def _admitted(pair, layout: str = "dense", f32: bool = False):
    """Both packages' states after admitting `SRC`'s sources at width 4,
    bucket 16, max_len 32 (dense, or the paged self-attention KV over
    shuffled pages of 8 tokens beside the dense cross-KV); the caches bf16
    as the engine keeps them, or with `f32` in float32."""
    (cfg, api, params), (jcfg, japi, jparams) = pair
    extras = _extras(cfg.d_model)
    W, ml = 4, 32
    tstate = api.init_state(cfg, W, ml, device="cpu")
    jstate = japi.init_state(jcfg, W, ml)
    if layout == "paged":
        table = np.array([[5, 2, 9, 7], [3, 11, 1, 8], [12, 14, 15, 16],
                          [4, 6, 10, 13]], np.int32)
        pool = api.init_page_pool(cfg, 17, 8, device="cpu")
        jpool = japi.init_page_pool(jcfg, 17, 8)
        tkv, jkv = tstate["kv"], jstate["kv"]
        tstate["kv"] = {**pool, "table": _t(table)[None].expand(
            cfg.n_layers, W, 4), "xk": tkv["xk"], "xv": tkv["xv"]}
        jstate = {**jstate, "kv": {**jpool, "table": jnp.broadcast_to(
            jnp.asarray(table)[None], (cfg.n_layers, W, 4)),
            "xk": jkv["xk"], "xv": jkv["xv"]}}
    if f32:
        tstate["kv"] = {k: v if k == "table" else v.float()
                        for k, v in tstate["kv"].items()}
        jstate = {**jstate, "kv": {k: v if k == "table" else
                                   v.astype(jnp.float32)
                                   for k, v in jstate["kv"].items()}}
    tstate = api.admit(params, api.pack_admit(cfg, extras, W, 16,
                                              device="cpu"), tstate, cfg)
    jstate = japi.admit(jparams, japi.pack_admit(jcfg, extras, W, 16),
                        jstate, jcfg)
    return tstate, jstate


def test_admit_writes_the_cross_kv_as_the_reference(pair):
    """`xk`/`xv` (in place) and `src_len`; the self-attention cache and the
    index are left alone."""
    tstate, jstate = _admitted(pair)
    assert tstate["src_len"].tolist() == np.asarray(
        jstate["src_len"]).tolist() == list(SRC)
    assert tstate["index"].tolist() == [0, 0, 0, 0]
    for k in ("xk", "xv"):
        _cache_close(tstate["kv"][k], jstate["kv"][k])
    for k in ("k", "v"):
        assert not tstate["kv"][k].any()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_chunk_and_decode_after_admission_match_jax(pair, layout):
    """Two decoder chunks over rows of different lengths (one zero-length
    throughout), then decode steps at per-row positions: logits, index,
    src_len and the caches against the JAX package's. The caches are f32
    here: in bf16 a key written and read back in the same call rounds on
    either side of a bf16 step where the two frameworks' f32 sums differ
    in the last bit, which moves seamless's smoke logits past 1e-4 (the
    engine tests hold the bf16 path by exact streams)."""
    (cfg, api, params), (jcfg, japi, jparams) = pair
    tstate, jstate = _admitted(pair, layout, f32=True)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (11, 4, 0, 8)]
    base = np.zeros(4, np.int32)
    for step in range(2):
        toks = np.zeros((4, 8), np.int32)
        lens = np.zeros(4, np.int32)
        for r, p in enumerate(prompts):
            n = min(8, len(p) - base[r])
            toks[r, :n] = p[base[r]:base[r] + n]
            lens[r] = n
        jl, jstate = japi.prefill_chunk(jparams, jnp.asarray(toks),
                                        jnp.asarray(lens), jstate, jcfg)
        tl, tstate = api.prefill_chunk(params, _t(toks), _t(lens), tstate,
                                       cfg)
        _close(tl, jl, TOL_MODEL)
        base += lens
    tok = rng.integers(0, cfg.vocab, 4).astype(np.int32)
    for step in range(3):
        jl, jstate = japi.decode_step(jparams, jnp.asarray(tok), jstate,
                                      jcfg)
        tl, tstate = api.decode_step(params, _t(tok), tstate, cfg)
        _close(tl, jl, TOL_MODEL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for k in ("index", "src_len"):
        assert tstate[k].tolist() == np.asarray(jstate[k]).tolist()
    for k in tstate["kv"]:
        if k != "table":
            _close(tstate["kv"][k], jstate["kv"][k])


def _prefill_batch(cfg):
    """Two sources of 12 and 5 frames zero-padded to 16, prompts of 9 and
    6 tokens."""
    rng = np.random.default_rng(10)
    src = np.zeros((2, 16, cfg.d_model), np.float32)
    src[0, :12] = rng.normal(size=(12, cfg.d_model))
    src[1, :5] = rng.normal(size=(5, cfg.d_model))
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    return src, np.array([12, 5], np.int32), toks, np.array([9, 6], np.int32)


def test_encdec_prefill_matches_jax(pair):
    """`prefill` against the JAX package's: index, and bf16 caches at most
    one bf16 step apart; then the logits of its path (admission plus one
    whole-prompt chunk, the body of both packages' `encdec_prefill`) with
    f32 caches, where no bf16 rounding enters (see
    `test_prefill_chunk_and_decode_after_admission_match_jax`)."""
    (cfg, api, params), (jcfg, japi, jparams) = pair
    src, sl, toks, lens = _prefill_batch(cfg)
    jl, js = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "src_embeds": jnp.asarray(src),
                                    "src_lens": jnp.asarray(sl),
                                    "lengths": jnp.asarray(lens)}, jcfg,
                          max_len=16)
    tl, ts = api.prefill(params, {"tokens": _t(toks),
                                  "src_embeds": torch.from_numpy(src),
                                  "src_lens": _t(sl), "lengths": _t(lens)},
                         cfg, max_len=16)
    assert ts["index"].tolist() == np.asarray(js["index"]).tolist() \
        == lens.tolist()
    for k in ts["kv"]:
        np.testing.assert_allclose(_np(ts["kv"][k]), _np(js["kv"][k]),
                                   rtol=2 ** -7, atol=1e-6)
    jst = jencdec.encdec_admit(
        jparams, {"src_embeds": jnp.asarray(src), "src_len": jnp.asarray(sl)},
        jencdec.encdec_init_state(jcfg, 2, 16, jnp.float32), jcfg)
    jl, js = jencdec.encdec_prefill_chunk(jparams, jnp.asarray(toks),
                                          jnp.asarray(lens), jst, jcfg)
    tst = encdec.encdec_init_state(cfg, 2, 16, device="cpu")
    tst["kv"] = {k: v.float() for k, v in tst["kv"].items()}
    tst = encdec.encdec_admit(
        params, {"src_embeds": torch.from_numpy(src), "src_len": _t(sl)},
        tst, cfg)
    tl, ts = encdec.encdec_prefill_chunk(params, _t(toks), _t(lens), tst,
                                         cfg)
    _close(tl, jl, TOL_MODEL)
    for k in ts["kv"]:
        _close(ts["kv"][k], js["kv"][k])


def test_encdec_prefill_equals_admit_plus_chunks_bit_for_bit(pair):
    """Inside the port, the single-shot prefill and the serving path (the
    source admitted, the prompt in chunks of 4) give the same logits and
    cache bits, and the same decode step."""
    (cfg, api, params), _ = pair
    src, sl, toks, lens = _prefill_batch(cfg)
    logits, ref = api.prefill(params, {
        "tokens": _t(toks), "src_embeds": torch.from_numpy(src),
        "src_lens": _t(sl), "lengths": _t(lens)}, cfg, max_len=16)
    extras = [{"src_embeds": src[b, :sl[b]]} for b in range(2)]
    st = api.admit(params, api.pack_admit(cfg, extras, 2, 16, device="cpu"),
                   api.init_state(cfg, 2, 16, device="cpu"), cfg)
    base = np.zeros(2, np.int32)
    for _ in range(3):
        n = np.minimum(4, lens - base)
        chunk = np.zeros((2, 4), np.int32)
        for r in range(2):
            chunk[r, :n[r]] = toks[r, base[r]:base[r] + n[r]]
        got, st = api.prefill_chunk(params, _t(chunk), _t(n), st, cfg)
        if (n > 0).all():
            last = got
        base += n
    assert torch.equal(got[0], logits[0])       # row 0 ends in chunk 3
    assert torch.equal(last[1], logits[1])      # row 1 in chunk 2
    for k in ref["kv"]:
        assert torch.equal(st["kv"][k], ref["kv"][k]), k
    tok = logits.argmax(-1)
    assert torch.equal(api.decode_step(params, tok, st, cfg)[0],
                       api.decode_step(params, tok, ref, cfg)[0])
