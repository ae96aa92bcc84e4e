"""The port engine serving the admit families (encdec, vlm), against the
JAX engine's streams, on the CPU.

The ports of the JAX package's own serving tests for these families:
`tests/test_chunked_prefill.py`'s encdec and vlm cases (chunked equals
serial and wave, chunk-size invariance; `FAMILY_KW`'s sizes and
`family_extras`' inputs, a text-only vlm request among them) and
`tests/test_paged_kv.py::TestPagedEngine::test_bit_parity_with_dense_layout`
(paged equals dense, no prefix hit for an admit family), plus the three
`submit` refusals. Each runs the same weights (through
`bridge.params_from_numpy`) in both engines; streams, step counts, token
counts and the allocator's report must be exactly equal, and the invariant
of the original test must hold inside the port.
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

KINDS = ("encdec", "vlm")
BASE = dict(name="admit-serve-test", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, vocab=128, param_dtype="float32",
            activation_dtype="float32", remat=False)
FAMILY_KW = {
    "encdec": dict(d_ff=128, n_encoder_layers=2, gated_mlp=False),
    "vlm": dict(d_ff=128, qkv_bias=True, mrope=True,
                mrope_sections=(4, 2, 2)),
}


def family_extras(kind: str, d_model: int, uid: int) -> dict | None:
    """`test_chunked_prefill.family_extras`: encdec sources of 6, 9 and 12
    frames (straddling the buckets); vlm grids 4x4, 2x3 and 3x2 and one
    text-only request (uid 2 mod 4)."""
    if kind == "encdec":
        rng = np.random.default_rng(1000 + uid)
        t = 6 + 3 * (uid % 3)
        return {"src_embeds": rng.standard_normal(
            (t, d_model)).astype(np.float32)}
    grid = {0: (4, 4), 1: (2, 3), 2: None, 3: (3, 2)}[uid % 4]
    if grid is None:
        return None
    gh, gw = grid
    rng = np.random.default_rng(2000 + uid)
    return {"patch_embeds": rng.standard_normal(
        (gh * gw, d_model)).astype(np.float32), "grid_hw": grid}


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
    kind, d = pair[0][0].kind, pair[0][0].d_model
    for uid, p, mnt in reqs:
        eng.submit(req_cls(uid=uid, prompt=p.copy(), max_new_tokens=mnt,
                           extras=family_extras(kind, d, uid)))
    return eng, {r.uid: r for r in eng.run_until_empty()}


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"uid {uid}")
        assert (got[uid].steps, got[uid].n_tokens) == \
            (want[uid].steps, want[uid].n_tokens)


def _check_same(eng, got: dict, jeng, want: dict) -> None:
    """The port engine's streams, counts and allocator report equal the
    JAX engine's."""
    _assert_same(got, want)
    for key in ("chunk_steps", "decode_steps", "generated_tokens",
                "requests", "lane_rebuilds"):
        assert eng.report()[key] == jeng.report()[key], key
    assert eng.report().get("paging") == jeng.report().get("paging")


def _serve_both(pair, reqs, **kw) -> tuple:
    """(port engine, {uid: Result}) after checking its streams and counts
    equal the JAX engine's under the same options and requests."""
    eng, got = _serve(pair, reqs, True, **kw)
    jeng, want = _serve(pair, reqs, False, **kw)
    _check_same(eng, got, jeng, want)
    return eng, got


MODES = {
    "chunked": dict(admission="chunked"),
    "serial": dict(admission="serial"),
    "wave": dict(mode="wave"),
    "paged": dict(kv_layout="paged", page_size=8),
}


@pytest.fixture(scope="module")
def runs(families):
    """(kind, mode, port) -> (engine, {uid: Result}) of `workload()` in
    `mode`, served once for the module and read by every test that needs
    that run: priced on the TPU v5e (what the energy test reads; the
    streams and counts do not depend on the chip)."""
    memo = {}

    def get(kind: str, mode: str, port: bool = True) -> tuple:
        if (kind, mode, port) not in memo:
            memo[kind, mode, port] = _serve(families[kind], workload(), port,
                                            chip="tpu_v5e", **MODES[mode])
        return memo[kind, mode, port]

    return get


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_equal_jax_engine(runs, kind, mode):
    """Greedy streams, step and token counts (and the paged allocator's
    report) of every serving mode equal the JAX engine's."""
    eng, got = runs(kind, mode)
    _check_same(eng, got, *runs(kind, mode, False))
    for uid, _, mnt in workload():
        assert got[uid].n_tokens == mnt
    assert eng.report()["admit_calls"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_streams_equal_jax_engine(families, kind):
    """Sampled (seeded Gumbel) streams, chunked and paged."""
    for mode in ("chunked", "paged"):
        _serve_both(families[kind], workload(), greedy=False, seed=7,
                    **MODES[mode])


@pytest.mark.parametrize("kind", KINDS)
def test_every_mode_equals_chunked_inside_the_port(runs, kind):
    """The reference's parity contract inside the port: serial, wave and
    paged streams equal chunked dense ones token for token."""
    _, rc = runs(kind, "chunked")
    for mode in ("serial", "wave", "paged"):
        _, r = runs(kind, mode)
        for uid, _, _ in workload():
            np.testing.assert_array_equal(r[uid].tokens, rc[uid].tokens,
                                          err_msg=f"{mode} uid {uid}")


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_size_invariance(families, runs, kind):
    """The stream does not depend on the chunk grid (8, 16, whole-prompt
    chunks)."""
    streams = []
    for ct in (8, 16, 64):
        _, r = (runs(kind, "chunked") if ct == ENGINE_KW["chunk_tokens"]
                else _serve(families[kind], workload(), chunk_tokens=ct))
        streams.append([r[uid].tokens for uid, _, _ in workload()])
    for other in streams[1:]:
        for a, b in zip(streams[0], other):
            np.testing.assert_array_equal(a, b)


def test_vlm_text_only_request_serves_like_its_dense_twin(families):
    """A vlm request without extras writes no prefix: its M-RoPE triples
    are its index on all three axes, so its stream equals that of a dense
    model of the same weights, alone or beside image requests, and on the
    paged layout it takes no admission call."""
    (cfg, _, params), (jcfg, japi, jparams) = families["vlm"]
    dcfg = dataclasses.replace(cfg, kind="dense", mrope=False)
    dparams = params_from_numpy(jax.tree.map(np.asarray, jparams), dcfg,
                                device="cpu")
    reqs = [(2, prompt(12, 11), 6)]
    twin = ServingEngine(get_model(dcfg), dparams, dcfg, device="cpu",
                         **ENGINE_KW)
    twin.submit(Request(uid=2, prompt=reqs[0][1].copy(), max_new_tokens=6))
    (want,) = twin.run_until_empty()
    _, alone = _serve(families["vlm"], reqs)
    _, beside = _serve(families["vlm"], workload())
    np.testing.assert_array_equal(alone[2].tokens, want.tokens)
    np.testing.assert_array_equal(beside[2].tokens, want.tokens)
    eng, _ = _serve_both(families["vlm"], reqs, **MODES["paged"])
    assert eng.report()["admit_calls"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_paged_admit_families_never_hit_the_prefix_registry(families, kind):
    """`test_paged_kv.py`'s workload shape: requests sharing a 20-token
    prompt prefix. Admit families neither match nor register prefixes, and
    paged equals dense."""
    shared = prompt(5, 20)
    reqs = [(i, np.concatenate([shared, prompt(20 + i, 5 + i)]), 6)
            for i in range(4)]
    eng, paged = _serve_both(families[kind], reqs, **MODES["paged"])
    _, dense = _serve(families[kind], reqs)
    assert eng.report()["paging"]["prefix_hits"] == 0
    for uid in dense:
        np.testing.assert_array_equal(paged[uid].tokens, dense[uid].tokens)


def test_budget_counts_the_patch_prefix(families):
    """A vlm row's budget is max_len minus its patch prefix and prompt, as
    in the JAX engine."""
    eng = _engine(families["vlm"], True, max_len=32)
    req = Request(uid=0, prompt=prompt(0, 10), max_new_tokens=50,
                  extras=family_extras("vlm", 64, 0))       # 16 patches
    assert eng._budget(req) == 32 - 16 - 10
    jeng = _engine(families["vlm"], False, max_len=32)
    jreq = JRequest(uid=0, prompt=prompt(0, 10), max_new_tokens=50,
                    extras=family_extras("vlm", 64, 0))
    assert jeng._budget(jreq) == eng._budget(req)


@pytest.mark.parametrize("case", ["no src_embeds", "prefix + prompt",
                                  "source"])
def test_submit_refuses_what_a_row_cannot_hold(families, case):
    """The three `submit` ValueErrors of the JAX engine: an encdec request
    without source embeddings, a patch prefix plus prompt that leaves no
    decode position, a source longer than max_len."""
    kind = "vlm" if case == "prefix + prompt" else "encdec"
    d = 64
    extras = {
        "no src_embeds": None,
        "prefix + prompt": {"patch_embeds": np.zeros((16, d), np.float32),
                            "grid_hw": (4, 4)},
        "source": {"src_embeds": np.zeros((33, d), np.float32)},
    }[case]
    n = 16 if case == "prefix + prompt" else 4
    match = {"no src_embeds": "src_embeds", "prefix + prompt": "does not fit",
             "source": "cross-KV capacity"}[case]
    for port in (True, False):
        eng = _engine(families[kind], port, max_len=32)
        cls = Request if port else JRequest
        with pytest.raises(ValueError, match=match):
            eng.submit(cls(uid=0, prompt=prompt(0, n), extras=extras))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_energy_and_model_clock_equal_jax_engine(runs, kind, mode):
    """Priced on the same chip (the TPU v5e, where the port's energy model
    is the reference's), every request's joules, J/token and model-clock
    TTFT and the report's model seconds and joules equal the JAX engine's
    to 1e-9 relative: the admission calls (encdec's encoder and cross-KV
    over the source rows, vlm's patch prefix without the head) and encdec's
    cross-KV reads are priced alike."""
    eng, got = runs(kind, mode)
    jeng, want = runs(kind, mode, False)
    _assert_same(got, want)
    for uid, w in want.items():
        g = got[uid]
        for key in ("energy_j", "energy_per_token_j", "ttft_model_s"):
            np.testing.assert_allclose(getattr(g, key), getattr(w, key),
                                       rtol=1e-9, atol=0.0)
        assert 0 < g.prefill_energy_j <= g.energy_j
    prep, jrep = eng.report(), jeng.report()
    for key in ("model_s", "energy_j", "attributed_energy_j",
                "idle_energy_j", "j_per_token"):
        np.testing.assert_allclose(prep[key], jrep[key], rtol=1e-9,
                                   atol=0.0)
