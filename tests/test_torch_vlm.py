"""The port's vision-language model (kind vlm) against the JAX package's,
on the CPU.

The JAX parameters go through `bridge.params_from_numpy`, so both packages
run the same weights; inputs are made from a seed with numpy. The smoke
config is f32 end to end except the KV cache, which both packages keep in
bf16. Tolerances are ROADMAP's: f32 outputs of one function 1e-5 (scaled by
the output's magnitude: the two frameworks sum in different orders),
whole-model logits 1e-4 (a bf16 cache entry may flip by one bf16 step),
packed batches, positions and integer state exactly.
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
from repro.models import layers as jL
from repro.models import vlm as jvlm
from repro.models.config import gemm_shape_counts as jgemm_shape_counts
from repro.models.config import kv_cache_bytes as jkv_cache_bytes
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import vlm
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.config import gemm_shape_counts, kv_cache_bytes
from repro_torch.models.registry import get_model

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen2-vl-2b"
# (grid or None for a text-only row, text tokens) per row of a batch
ROWS = (((4, 4), 6), ((2, 3), 9), (None, 5), ((3, 2), 1))


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


def _extras(d: int) -> list:
    out = []
    for i, (grid, _) in enumerate(ROWS):
        if grid is None:
            out.append(None)
            continue
        rng = np.random.default_rng(300 + i)
        out.append({"patch_embeds": rng.standard_normal(
            (grid[0] * grid[1], d)).astype(np.float32), "grid_hw": grid})
    return out


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config(ARCH, smoke=True)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = get_config(ARCH, smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


# ---------------------------------------------------------------------------
# config, bridge, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_config_equals_jax_field_by_field(smoke_cfg):
    port, ref = get_config(ARCH, smoke=smoke_cfg), jget_config(
        ARCH, smoke=smoke_cfg)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.hd, port.kv_heads, port.n_params()) == (
        ref.hd, ref.kv_heads, ref.n_params())


def test_bridge_round_trip(smoke):
    (cfg, _, params), (_, _, jparams) = smoke
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params)
    flat_in, tdef_in = jax.tree.flatten(tree)
    flat_out, tdef_out = jax.tree.flatten(back)
    assert tdef_in == tdef_out
    for a, b in zip(flat_in, flat_out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_gemm_counts_and_admission_fleet_equal_the_reference(smoke_cfg):
    """The KV bytes per cached token (the patch prefix sits in the KV
    cache); vlm counts as dense; the fleet adds the patch prefix's
    admission grid (no LM head) at every prefill bucket, pow2 widths
    through the lane and the full batch."""
    cfg, jcfg = get_config(ARCH, smoke=smoke_cfg), jget_config(
        ARCH, smoke=smoke_cfg)
    for t in (0, 1, 4, 512, 8192):
        assert kv_cache_bytes(cfg, t) == jkv_cache_bytes(jcfg, t)
        for kw in ({}, {"head_tokens": 4}, {"head_tokens": 0}):
            assert gemm_shape_counts(cfg, t, **kw) == jgemm_shape_counts(
                jcfg, t, **kw)
    for kw in (dict(max_batch=4, max_len=2048, chunk_tokens=64,
                    lane_width=8),
               dict(max_batch=4, max_len=2048),
               dict(max_batch=3, max_len=64, chunk_tokens=16)):
        fleet = ops.serving_gemm_fleet(cfg, **kw)
        assert fleet == jops.serving_gemm_fleet(jcfg, **kw)
    # full 32 x 32 grids admitted 1, 2, 4 and 8 at a time: 1024 rows each
    full_cfg = get_config(ARCH)
    full = set(ops.serving_gemm_fleet(full_cfg, max_batch=4, max_len=2048,
                                      chunk_tokens=64, lane_width=8))
    d = full_cfg.d_model
    assert {(w * 1024, d, d) for w in (1, 2, 4, 8)} <= full


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 2, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 7, 3)).astype(np.int32)
    want = jL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_mrope(torch.from_numpy(x), _t(pos), 1e6, sections)
    _close(got, want)


def test_mrope_of_equal_triples_is_rope():
    """Text tokens carry one id on all three axes: M-RoPE then rotates as
    plain RoPE, bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 5, 2, 16)).astype(np.float32))
    pos = _t(rng.integers(0, 100, (2, 5)))
    assert torch.equal(
        L.apply_mrope(x, pos[..., None].expand(2, 5, 3), 1e4, (4, 2, 2)),
        L.apply_rope(x, pos, 1e4))


@pytest.mark.parametrize("n,grid,text,start", [
    (16, (4, 4), 5, 0), (6, (2, 3), 0, 0), (6, (3, 2), 4, 7),
    (0, (0, 0), 6, 0), (1024, (32, 32), 3, 0)])
def test_build_mrope_positions_equals_the_reference(n, grid, text, start):
    got = vlm.build_mrope_positions(n, grid, text, start)
    want = jvlm.build_mrope_positions(n, grid, text, start)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# admission and the serving forwards
# ---------------------------------------------------------------------------


def test_pack_admit_equals_the_reference(smoke):
    (cfg, api, _), (jcfg, japi, _) = smoke
    extras = _extras(cfg.d_model)
    got = api.pack_admit(cfg, extras, 4, 16, device="cpu")
    want = japi.pack_admit(jcfg, extras, 4, 16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert [api.admit_dims(cfg, e) for e in extras] == [
        japi.admit_dims(jcfg, e) for e in extras] == [(16, 0), (6, 0),
                                                       (0, 0), (6, 0)]


def _admitted(smoke, layout: str = "dense"):
    """Both packages' states after admitting `ROWS`' patch prefixes at
    width 4, bucket 16, max_len 64 (dense, or paged over shuffled pages of
    8 tokens)."""
    (cfg, api, params), (jcfg, japi, jparams) = smoke
    extras = _extras(cfg.d_model)
    W, ml = 4, 64
    if layout == "dense":
        tstate = api.init_state(cfg, W, ml, device="cpu")
        jstate = japi.init_state(jcfg, W, ml)
    else:
        table = np.array([[5, 2, 9, 7, 12, 14, 19, 20],
                          [3, 11, 1, 8, 15, 16, 21, 22],
                          [23, 24, 25, 26, 27, 28, 29, 30],
                          [4, 6, 10, 13, 17, 18, 31, 32]], np.int32)
        pool = api.init_page_pool(cfg, 33, 8, device="cpu")
        jpool = japi.init_page_pool(jcfg, 33, 8)
        zero = np.zeros(W, np.int32)
        tstate = {"kv": {**pool, "table": _t(table)[None].expand(
                      cfg.n_layers, W, 8)},
                  "index": _t(zero), "pos_off": _t(zero)}
        jstate = {"kv": {**jpool, "table": jnp.broadcast_to(
                      jnp.asarray(table)[None], (cfg.n_layers, W, 8))},
                  "index": jnp.asarray(zero), "pos_off": jnp.asarray(zero)}
    tstate = api.admit(params, api.pack_admit(cfg, extras, W, 16,
                                              device="cpu"), tstate, cfg)
    jstate = japi.admit(jparams, japi.pack_admit(jcfg, extras, W, 16),
                        jstate, jcfg)
    return tstate, jstate


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_admit_writes_the_patch_prefix_as_the_reference(smoke, layout):
    """The cache rows the patch prefix writes (in place), the index at the
    prefix length and pos_off = t0 - n_patches."""
    tstate, jstate = _admitted(smoke, layout)
    assert tstate["index"].tolist() == np.asarray(jstate["index"]).tolist() \
        == [16, 6, 0, 6]
    assert tstate["pos_off"].tolist() == np.asarray(
        jstate["pos_off"]).tolist() == [4 - 16, 3 - 6, 0, 3 - 6]
    for k in (("k", "v") if layout == "dense" else ("k_pages", "v_pages")):
        _cache_close(tstate["kv"][k], jstate["kv"][k])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_chunk_and_decode_after_admission_match_jax(smoke, layout):
    """Two text chunks (one row text-only, one finishing early), then
    decode steps at per-row positions: logits, index, pos_off and cache
    against the JAX package's."""
    (cfg, api, params), (jcfg, japi, jparams) = smoke
    tstate, jstate = _admitted(smoke, layout)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for _, n in ROWS]
    base = np.zeros(4, np.int32)
    C = 8
    for step in range(2):
        toks = np.zeros((4, C), np.int32)
        lens = np.zeros(4, np.int32)
        for r, p in enumerate(prompts):
            n = min(C, len(p) - base[r])
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
    for k in ("index", "pos_off"):
        assert tstate[k].tolist() == np.asarray(jstate[k]).tolist()
    for k in (("k", "v") if layout == "dense" else ("k_pages", "v_pages")):
        _cache_close(tstate["kv"][k], jstate["kv"][k])


def _prefill_batch(cfg, n_patch=16, grid=(4, 4), text=7, B=2):
    rng = np.random.default_rng(6)
    pe = rng.normal(size=(B, n_patch, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)
    pos = np.broadcast_to(vlm.build_mrope_positions(n_patch, grid, text),
                          (B, n_patch + text, 3)).copy()
    return pe, toks, pos


def test_vlm_prefill_matches_jax(smoke):
    (cfg, api, params), (jcfg, japi, jparams) = smoke
    pe, toks, pos = _prefill_batch(cfg)
    jl, js = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "patch_embeds": jnp.asarray(pe),
                                    "positions_3d": jnp.asarray(pos)},
                          jcfg, max_len=32)
    tl, ts = api.prefill(params, {"tokens": _t(toks),
                                  "patch_embeds": torch.from_numpy(pe),
                                  "positions_3d": _t(pos)}, cfg, max_len=32)
    _close(tl, jl, TOL_MODEL)
    assert int(ts["index"]) == int(js["index"]) == 23
    assert ts["pos_off"].tolist() == np.asarray(js["pos_off"]).tolist()
    for k in ("k", "v"):
        _cache_close(ts["kv"][k], js["kv"][k])


def test_vlm_prefill_equals_admit_plus_chunks_bit_for_bit(smoke):
    """Inside the port, the single-shot prefill of [patches | text] and the
    serving path (the patch prefix admitted, the text in chunks of 4) give
    the same logits and the same cache bits; the decode step after each
    gives the same logits."""
    (cfg, api, params), _ = smoke
    pe, toks, pos = _prefill_batch(cfg)
    logits, ref = api.prefill(params, {"tokens": _t(toks),
                                       "patch_embeds": torch.from_numpy(pe),
                                       "positions_3d": _t(pos)}, cfg,
                              max_len=32)
    extras = [{"patch_embeds": pe[b], "grid_hw": (4, 4)} for b in range(2)]
    st = api.admit(params, api.pack_admit(cfg, extras, 2, 16, device="cpu"),
                   api.init_state(cfg, 2, 32, device="cpu"), cfg)
    for lo in range(0, 7, 4):
        n = min(4, 7 - lo)
        chunk = torch.zeros((2, 4), dtype=torch.long)
        chunk[:, :n] = _t(toks[:, lo:lo + n])
        got, st = api.prefill_chunk(params, chunk,
                                    torch.full((2,), n), st, cfg)
    assert torch.equal(got, logits)
    for k in ("k", "v"):
        assert torch.equal(st["kv"][k], ref["kv"][k])
    tok = logits.argmax(-1)
    assert torch.equal(api.decode_step(params, tok, st, cfg)[0],
                       api.decode_step(params, tok, ref, cfg)[0])
