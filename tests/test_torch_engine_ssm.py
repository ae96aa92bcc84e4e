"""The port engine serving the SSM and hybrid families, against the JAX
engine's streams, on the CPU.

The ports of the JAX package's own serving tests for these families:
`tests/test_chunked_prefill.py`'s mamba1, mamba2 and hybrid cases (chunked
equals serial and wave, chunk-size invariance, prompts longer than max_len,
an unaligned max_len bucket) and `tests/test_serving_engine.py::
TestSsmFamilies` (continuous serving with wave parity, budgets not clamped
by max_len for attention-free rows, per-row clamps for hybrid), plus the
engine's `ssm_serve_grain` validation and its refusal of the paged layout
for these kinds. Each runs the same weights (through
`bridge.params_from_numpy`) in both engines; streams, step counts and
token counts must be exactly equal, and the invariant of the original test
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
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine

KINDS = ("mamba1", "mamba2", "hybrid")
BASE = dict(name="ssm-serve-test", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, vocab=128, param_dtype="float32",
            activation_dtype="float32", remat=False)
FAMILY_KW = {
    "mamba1": dict(d_ff=0, ssm_state=8, expand=2, d_conv=4),
    "mamba2": dict(d_ff=0, ssm_state=8, expand=2, d_conv=4,
                   ssm_headdim=16, ssm_ngroups=1),
    "hybrid": dict(d_ff=128, ssm_state=8, expand=2, d_conv=4,
                   ssm_headdim=16, ssm_ngroups=1, attn_every=2),
}


def _pair(jcfg: JModelConfig):
    """((cfg, api, params) of the port, (cfg, api, params) of JAX)."""
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.key(0), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return (cfg, get_model(cfg), params), (jcfg, japi, jparams)


@pytest.fixture(scope="module")
def families():
    return {kind: _pair(JModelConfig(kind=kind, **{**BASE, **kw}))
            for kind, kw in FAMILY_KW.items()}


def prompt(seed: int, n: int, vocab: int = 128) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


# prompt lengths straddle the chunk size (8): 21 needs 3 chunks, 11 needs
# 2, 5 and 8 fit one (8 exactly on the bucket edge)
def workload():
    return [(0, prompt(10, 21), 5), (1, prompt(11, 5), 4),
            (2, prompt(12, 11), 6), (3, prompt(13, 8), 3)]


ENGINE_KW = dict(mode="continuous", admission="chunked", chunk_tokens=8,
                 max_batch=2, max_len=64)


def _engine(pair, port: bool, **kw):
    (cfg, api, params), (jcfg, japi, jparams) = pair
    kw = {**ENGINE_KW, **kw}
    if port:
        return ServingEngine(api, params, cfg, device="cpu", **kw)
    return JServingEngine(japi, jparams, jcfg, **kw)


def _serve(pair, reqs, port: bool = True, **kw):
    eng = _engine(pair, port, **kw)
    req_cls = Request if port else JRequest
    for uid, p, mnt in reqs:
        eng.submit(req_cls(uid=uid, prompt=p.copy(), max_new_tokens=mnt))
    return eng, {r.uid: r for r in eng.run_until_empty()}


def _serve_both(pair, reqs, **kw) -> tuple[dict, dict]:
    """{uid: Result} of the port engine and of the JAX engine, same
    options and requests; their streams and counts must agree."""
    got = _serve(pair, reqs, True, **kw)[1]
    want = _serve(pair, reqs, False, **kw)[1]
    _assert_same(got, want)
    return got, want


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid {uid}")
        assert (got[uid].steps, got[uid].n_tokens) == \
            (want[uid].steps, want[uid].n_tokens)


# ---------------------------------------------------------------------------
# test_chunked_prefill.py: chunked vs serial vs wave, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chunked(families):
    """kind -> ((port engine, {uid: Result}), (JAX engine, {uid:
    Result})) of `workload()` served greedy in the default chunked loop,
    once for the module: the three tests that read that run share it."""
    memo = {}

    def get(kind: str) -> tuple:
        if kind not in memo:
            memo[kind] = tuple(_serve(families[kind], workload(), port)
                               for port in (True, False))
        return memo[kind]

    return get


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("greedy", [True, False])
def test_chunked_serial_and_wave_streams_equal_jax(families, chunked, kind,
                                                   greedy):
    """Greedy and seeded streams in the three loops equal the JAX engine's,
    and, inside the port, chunked equals serial and wave (the reference's
    bit-parity contract)."""
    reqs = workload()
    kw = {} if greedy else dict(greedy=False, seed=7)
    if greedy:
        (_, rc), (_, jc) = chunked(kind)
        _assert_same(rc, jc)
    else:
        rc, _ = _serve_both(families[kind], reqs, admission="chunked", **kw)
    rs, _ = _serve_both(families[kind], reqs, admission="serial", **kw)
    rw, _ = _serve_both(families[kind], reqs, mode="wave", **kw)
    for uid, _, mnt in reqs:
        assert rc[uid].n_tokens == mnt
        np.testing.assert_array_equal(rc[uid].tokens, rs[uid].tokens)
        np.testing.assert_array_equal(rc[uid].tokens, rw[uid].tokens)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_counts_steps_as_jax(chunked, kind):
    (ec, _), (jc, _) = chunked(kind)
    for key in ("chunk_steps", "decode_steps", "generated_tokens",
                "requests", "lane_rebuilds"):
        assert ec.report()[key] == jc.report()[key], key
    assert ec.report()["chunk_steps"] > 0


@pytest.mark.parametrize("kind", ["mamba2", "hybrid"])
def test_chunk_size_invariance(families, chunked, kind):
    """The stream does not depend on the chunk grid (8, 16, whole-prompt
    chunks)."""
    reqs = workload()
    streams = []
    for ct in (8, 16, 64):
        _, r = (chunked(kind)[0] if ct == ENGINE_KW["chunk_tokens"]
                else _serve(families[kind], reqs, chunk_tokens=ct))
        streams.append([r[uid].tokens for uid, _, _ in reqs])
    for other in streams[1:]:
        for a, b in zip(streams[0], other):
            np.testing.assert_array_equal(a, b)


def test_attention_free_long_prompt_exceeds_max_len(families):
    """Chunked admission serves an attention-free prompt longer than
    max_len (no KV bound): the state keeps scanning, as in the wave loop
    and the JAX engine; serial prefill buckets double past max_len."""
    reqs = [(0, prompt(70, 40), 4)]
    rc, _ = _serve_both(families["mamba1"], reqs, max_len=32)
    assert rc[0].n_tokens == 4
    rw, _ = _serve_both(families["mamba1"], reqs, mode="wave", max_len=32)
    rs, _ = _serve_both(families["mamba1"], reqs, admission="serial",
                        max_len=32)
    np.testing.assert_array_equal(rc[0].tokens, rw[0].tokens)
    np.testing.assert_array_equal(rc[0].tokens, rs[0].tokens)
    eng = _engine(families["mamba1"], True, max_len=32)
    assert eng._bucket(40) == 64 and eng._bucket(129) == 256


def test_ssm_long_prompt_with_unaligned_max_len_bucket(families):
    """A prompt longer than a max_len that is not a multiple of 8 keeps its
    chunk boundaries on the grain (the max_len bucket is dropped for
    non-final chunks), so continuous equals wave, and both equal JAX."""
    streams = {}
    for mode in ("continuous", "wave"):
        r, _ = _serve_both(families["mamba1"], [(0, prompt(85, 100), 4)],
                           mode=mode, max_len=60, chunk_tokens=64)
        streams[mode] = r[0].tokens
    np.testing.assert_array_equal(streams["continuous"], streams["wave"])


# ---------------------------------------------------------------------------
# test_serving_engine.py::TestSsmFamilies
# ---------------------------------------------------------------------------

def test_mamba_serves_continuously_with_wave_parity(families):
    reqs = [(uid, prompt(uid, 6), 4) for uid in range(3)]
    outs = {}
    for mode in ("continuous", "wave"):
        eng = _engine(families["mamba1"], True, mode=mode, max_len=32)
        assert eng._continuous_supported()
        outs[mode], _ = _serve_both(families["mamba1"], reqs, mode=mode,
                                    max_len=32)
    for uid, _, mnt in reqs:
        assert outs["continuous"][uid].n_tokens == mnt
        np.testing.assert_array_equal(outs["continuous"][uid].tokens,
                                      outs["wave"][uid].tokens)


@pytest.mark.parametrize("mode", ["wave", "continuous"])
def test_attention_free_budget_not_clamped_by_max_len(families, mode):
    """No KV cache to run out of: neither the prompt-length check nor the
    budget clamp applies to mamba1, even in a padded batch."""
    reqs = [(0, prompt(0, 28), 20), (1, prompt(1, 6), 20)]
    res, _ = _serve_both(families["mamba1"], reqs, mode=mode, max_len=32)
    assert res[0].n_tokens == 20 and res[1].n_tokens == 20


@pytest.mark.parametrize("mode", ["wave", "continuous"])
def test_hybrid_budgets_clamp_per_row(families, mode):
    """Hybrid rows have a KV cache: each row's room is max_len minus its
    own prompt, and a prompt of max_len is refused."""
    reqs = [(0, prompt(0, 28), 20), (1, prompt(1, 6), 20)]
    res, _ = _serve_both(families["hybrid"], reqs, mode=mode, max_len=32)
    assert res[0].n_tokens == 32 - 28 and res[1].n_tokens == 20
    eng = _engine(families["hybrid"], True, mode=mode, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=9, prompt=prompt(9, 32)))


# ---------------------------------------------------------------------------
# ssm_serve_grain and the paged refusal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grain", [4, 12, 24])
def test_ssm_serve_grain_must_be_a_pow2_multiple_of_8(families, grain):
    for port in (True, False):
        with pytest.raises(ValueError, match="power-of-two"):
            _engine(families["mamba2"], port, ssm_serve_grain=grain)


def test_chunk_tokens_must_be_a_multiple_of_the_grain(families):
    for port in (True, False):
        with pytest.raises(ValueError, match="multiple of 16"):
            _engine(families["mamba2"], port, ssm_serve_grain=16,
                    chunk_tokens=8)


def test_max_len_below_the_grain_is_refused_for_chunked_ssm(families):
    for port in (True, False):
        with pytest.raises(ValueError, match="cannot serve"):
            _engine(families["mamba1"], port, ssm_serve_grain=32,
                    chunk_tokens=32, max_len=16)


@pytest.mark.parametrize("kind", KINDS)
def test_wider_grain_streams_equal_jax(families, kind):
    """At grain 16 the config carries the grain, buckets start at 16, and
    chunked, serial and wave streams equal the JAX engine's and each
    other."""
    reqs = workload()
    kw = dict(ssm_serve_grain=16, chunk_tokens=16)
    eng = _engine(families[kind], True, **kw)
    assert eng.cfg.ssm_serve_grain == 16 and eng._chunk_bucket(3) == 16
    rc, _ = _serve_both(families[kind], reqs, **kw)
    rs, _ = _serve_both(families[kind], reqs, admission="serial", **kw)
    rw, _ = _serve_both(families[kind], reqs, mode="wave", **kw)
    for uid, _, _ in reqs:
        np.testing.assert_array_equal(rc[uid].tokens, rs[uid].tokens)
        np.testing.assert_array_equal(rc[uid].tokens, rw[uid].tokens)


@pytest.mark.parametrize("kind", KINDS)
def test_paged_layout_is_refused(families, kind):
    """SSM and hybrid state is O(1) per row: kv_layout='paged' raises, with
    the JAX engine's message."""
    msgs = []
    for port in (True, False):
        with pytest.raises(ValueError, match="unsupported for kind") as err:
            _engine(families[kind], port, kv_layout="paged")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
