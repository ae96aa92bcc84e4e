"""The port engine serving the MoE and MLA-MoE families, against the JAX
engine's streams, on the CPU.

The ports of the JAX package's own serving tests for these families:
`tests/test_moe_capacity.py` (per-row expert capacity keeps a request's
stream independent of its batch, binding or not), `test_paged_kv.py::
TestPagedEngine`'s moe and mla_moe cases (paged equals dense),
`test_serving_engine.py::TestMoEFamilies` (continuous equals wave with
slot refill) and `test_chunked_prefill.py`'s moe and mla_moe families
(chunked equals serial and wave). Each runs the same weights (through
`bridge.params_from_numpy`) in both engines; streams, step counts and
counters must be exactly equal, and the invariant of the original test
must hold inside the port.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from repro.models.config import ModelConfig as JModelConfig
from repro.models.registry import get_model as jget_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig, gemm_shape_counts
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine


def _pair(jcfg: JModelConfig):
    """((cfg, api, params) of the port, (cfg, api, params) of JAX)."""
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


def _serve_both(pair, reqs, **kw) -> tuple[dict, dict]:
    """Serve (uid, prompt, max_new_tokens) requests in the port engine and
    the JAX engine with the same options; returns {uid: Result} of each."""
    (cfg, api, params), (jcfg, japi, jparams) = pair
    out = []
    for eng, req_cls in ((ServingEngine(api, params, cfg, device="cpu",
                                        **kw), Request),
                         (JServingEngine(japi, jparams, jcfg, **kw),
                          JRequest)):
        for uid, p, mnt in reqs:
            eng.submit(req_cls(uid=uid, prompt=p.copy(), max_new_tokens=mnt))
        out.append({r.uid: r for r in eng.run_until_empty()})
    return out[0], out[1]


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid {uid}")
        assert (got[uid].steps, got[uid].n_tokens) == \
            (want[uid].steps, want[uid].n_tokens)


def _streams(results: dict) -> dict:
    return {uid: r.tokens.tolist() for uid, r in results.items()}


# ---------------------------------------------------------------------------
# test_moe_capacity.py: per-row capacity
# ---------------------------------------------------------------------------

VOCAB = 128
PROMPT_LEN = 12
DIVERGENT_SEEDS = (0, 1, 3)


def _capacity_cfg(capacity_factor: float) -> JModelConfig:
    return JModelConfig(
        name="moe-cap-test", kind="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=0, d_ff_expert=64, vocab=VOCAB,
        n_experts=4, top_k=1, capacity_factor=capacity_factor,
        param_dtype="float32", activation_dtype="float32", remat=False)


@pytest.fixture(scope="module")
def moe_binding():
    """cf 1.0 < E/K = 4: capacity binds, per row."""
    return _pair(_capacity_cfg(1.0))


@pytest.fixture(scope="module")
def moe_safe():
    """cf = E/K: capacity never binds for top-k routing."""
    return _pair(_capacity_cfg(4.0))


def _cap_prompt(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, VOCAB, PROMPT_LEN).astype(np.int32)


def _alone_vs_paired(pair, seed: int, mode: str = "wave"):
    a, b = _cap_prompt(seed), _cap_prompt(seed + 100)
    kw = dict(max_batch=2, max_len=64, mode=mode, seed=0)
    alone, jalone = _serve_both(pair, [(0, a, 8)], **kw)
    paired, jpaired = _serve_both(pair, [(0, a, 8), (1, b, 8)], **kw)
    _assert_same(alone, jalone)
    _assert_same(paired, jpaired)
    return alone[0].tokens, paired[0].tokens


def test_binding_capacity_per_row_guarantee(moe_binding):
    """A binding capacity factor drops tokens per row, so a request's
    stream alone equals its stream beside a neighbour, on the seeds that
    diverged under batch-level capacity; both equal the JAX engine's."""
    for seed in DIVERGENT_SEEDS:
        alone, paired = _alone_vs_paired(moe_binding, seed)
        np.testing.assert_array_equal(alone, paired, err_msg=str(seed))


def test_nonbinding_capacity_is_composition_independent(moe_safe):
    for seed in DIVERGENT_SEEDS:
        alone, paired = _alone_vs_paired(moe_safe, seed)
        np.testing.assert_array_equal(alone, paired, err_msg=str(seed))


def test_nonbinding_capacity_continuous_matches_wave(moe_safe):
    reqs = [(i, _cap_prompt(i), 8) for i in DIVERGENT_SEEDS]
    kw = dict(max_batch=2, max_len=64, seed=0)
    wave, jwave = _serve_both(moe_safe, reqs, mode="wave", **kw)
    cont, jcont = _serve_both(moe_safe, reqs, mode="continuous", **kw)
    _assert_same(wave, jwave)
    _assert_same(cont, jcont)
    assert _streams(cont) == _streams(wave)


# ---------------------------------------------------------------------------
# test_paged_kv.py::TestPagedEngine, moe and mla_moe
# ---------------------------------------------------------------------------


def _paged_cfg(kind: str) -> JModelConfig:
    base = dict(name="paged-test", kind=kind, n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                param_dtype="float32", activation_dtype="float32",
                remat=False, n_experts=4, top_k=2, d_ff_expert=64,
                capacity_factor=2.0)
    if kind == "mla_moe":
        base.update(kv_lora_rank=16, rope_head_dim=8)
    return JModelConfig(**base)


def _paged_reqs(vocab: int = 97) -> list:
    rng = np.random.default_rng(42)
    shared = rng.integers(0, vocab, 20)
    out = []
    for i in range(6):
        if i % 2 == 0:
            p = np.concatenate([shared, rng.integers(0, vocab, 5 + i)])
        else:
            p = rng.integers(0, vocab, 10 + i)
        out.append((i, p.astype(np.int32), 6))
    return out


@pytest.mark.parametrize("kind", ["moe", "mla_moe"])
def test_paged_streams_equal_dense_and_the_jax_engine(kind):
    """Paged equals the dense layout inside the port, and each equals the
    JAX engine's."""
    pair = _pair(_paged_cfg(kind))
    kw = dict(max_batch=2, max_len=64, chunk_tokens=16)
    dense, jdense = _serve_both(pair, _paged_reqs(), **kw)
    paged, jpaged = _serve_both(pair, _paged_reqs(), kv_layout="paged",
                                page_size=8, **kw)
    _assert_same(dense, jdense)
    _assert_same(paged, jpaged)
    assert _streams(paged) == _streams(dense)
    (cfg, api, params), _ = pair
    eng = ServingEngine(api, params, cfg, device="cpu", kv_layout="paged",
                        page_size=8, **kw)
    for uid, p, mnt in _paged_reqs():
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=mnt))
    eng.run_until_empty()
    rep = eng.report()["paging"]
    assert rep["peak_in_use"] > 0


# ---------------------------------------------------------------------------
# test_serving_engine.py::TestMoEFamilies
# ---------------------------------------------------------------------------


def _family_cfg(kind: str) -> JModelConfig:
    base = dict(name="fam-test", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, vocab=128, param_dtype="float32",
                activation_dtype="float32", remat=False,
                capacity_factor=16.0, n_experts=4, top_k=2, d_ff_expert=64)
    if kind == "moe":
        return JModelConfig(kind="moe", d_ff=0, **base)
    return JModelConfig(kind="mla_moe", d_ff=128, n_shared_experts=1,
                        kv_lora_rank=16, rope_head_dim=8, **base)


@pytest.fixture(scope="module", params=["moe", "mla_moe"])
def family(request):
    return request.param, _pair(_family_cfg(request.param))


def test_continuous_matches_wave_with_slot_refill(family):
    _, pair = family
    rng = np.random.default_rng(1)
    reqs = [(uid, rng.integers(0, 128, rng.integers(4, 10)).astype(np.int32),
             int(rng.choice([3, 6]))) for uid in range(4)]
    kw = dict(max_batch=2, max_len=32)
    cont, jcont = _serve_both(pair, reqs, mode="continuous", **kw)
    wave, jwave = _serve_both(pair, reqs, mode="wave", **kw)
    _assert_same(cont, jcont)
    _assert_same(wave, jwave)
    for uid, _, mnt in reqs:
        assert cont[uid].n_tokens == mnt
    assert _streams(cont) == _streams(wave)


def _chunk_workload() -> list:
    """Prompt lengths straddle the chunk size (8): 21 needs 3 chunks, 11
    needs 2, 5 and 8 fit one (8 exactly on the bucket edge)."""
    def prompt(seed, n):
        return np.random.default_rng(seed).integers(0, 128, n).astype(
            np.int32)

    return [(0, prompt(10, 21), 5), (1, prompt(11, 5), 4),
            (2, prompt(12, 11), 6), (3, prompt(13, 8), 3)]


def test_chunked_matches_serial_and_wave(family):
    """test_chunked_prefill.py's moe and mla_moe families: chunked
    admission equals single-shot serial prefill and the wave loop inside
    the port; chunked and serial equal the JAX engine's."""
    _, pair = family
    reqs = _chunk_workload()
    kw = dict(max_batch=2, max_len=64, chunk_tokens=8)
    chunked, jchunked = _serve_both(pair, reqs, **kw)
    serial, jserial = _serve_both(pair, reqs, admission="serial", **kw)
    wave, _ = _serve_both(pair, reqs, mode="wave", **kw)
    _assert_same(chunked, jchunked)
    _assert_same(serial, jserial)
    for uid, _, mnt in reqs:
        assert chunked[uid].n_tokens == mnt
    assert _streams(chunked) == _streams(serial) == _streams(wave)


def test_mla_counts_match_traced_projections():
    """MLA serves through its latent fleet (w_uq, w_dkv, w_kpe and the
    cache-wide w_uk/w_uv), never the generic Q/K/V skeleton."""
    cfg = ModelConfig(**dataclasses.asdict(_family_cfg("mla_moe")))
    counts = gemm_shape_counts(cfg, 4, kv_rows=64)
    d, hd, pe = cfg.d_model, cfg.hd, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    assert (4, cfg.n_heads * (hd + pe), d) in counts      # w_uq
    assert (4, r, d) in counts                            # w_dkv
    assert (4, pe, d) in counts                           # w_kpe
    assert counts[(64, cfg.n_heads * hd, r)] == 2 * cfg.n_layers
    assert (4, cfg.kv_heads * hd, d) not in counts        # no K/V proj


def test_engine_energy_prices_the_mla_decompress_at_cache_rows():
    """The engine sizes w_uk/w_uv's rows in its step pricing by the cached
    rows (batch rows x max_len), as the JAX engine does."""
    (cfg, api, params), (jcfg, japi, jparams) = _pair(_family_cfg("mla_moe"))
    eng = ServingEngine(api, params, cfg, device="cpu", max_batch=2,
                        max_len=32, chip="tpu_v5e")
    jeng = JServingEngine(japi, jparams, jcfg, max_batch=2, max_len=32,
                          chip="tpu_v5e")
    for e in (eng, jeng):
        assert e.decode_step_estimate() is not None
    got = eng.decode_step_estimate()
    want = jeng.decode_step_estimate()
    np.testing.assert_allclose(got.energy_j, want.energy_j, rtol=1e-6)
    np.testing.assert_allclose(got.step_s, want.step_s, rtol=1e-6)
