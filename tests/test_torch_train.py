"""The port's training path against the JAX package's, on the CPU: the
loss, every gradient leaf, the optimizer and whole train steps.

Both packages get the same weights (the JAX params through the bridge) and
the same seeded numpy batches; JAX runs its ``xla`` mode on the CPU, as its
own tests do, and the port the kernel's plain version (a CPU tensor), so the
backward graph is the one the card runs: `ops.matmul`'s autograd function.

Tolerances: f32 1e-5 and bf16 2e-2, relative plus absolute, the absolute
part scaled by the larger of 1 and the reference leaf's largest magnitude
(the convention of the kernel tests and `chip_smoke.py`: the two frameworks
sum in different orders, and Adam divides each gradient by its own running
norm, so a leaf whose gradient is near rounding noise, such as the key
bias, whose exact gradient is 0, moves by a few learning-rate steps either
way). Integer state (the optimizer step, ``rng``) is compared exactly.
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
from repro.models import layers as JL
from repro.models.config import gemm_shapes as jgemm_shapes
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models.config import gemm_shapes
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

TOL_F32, TOL_BF16 = 1e-5, 2e-2
ARCHS = ("qwen2-7b", "starcoder2-3b")   # SwiGLU with QKV bias; GELU
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol: float, what: str = "") -> None:
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _tree_close(got: dict, want: dict, tol: float, where: str = "") -> None:
    assert set(got) == set(want), where
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], tol, f"{where}/{k}")
        else:
            _close(got[k], want[k], tol, f"{where}/{k}")


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch: str, bf16: bool = False):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if bf16:
        dt = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
        jcfg, cfg = (dataclasses.replace(jcfg, **dt),
                     dataclasses.replace(cfg, **dt))
    return jcfg, cfg


def _batches(cfg, n: int, B: int = 4, S: int = 16, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _tbatch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax api, jax train state, port cfg, port api)."""
    jcfg, cfg = _cfgs(request.param)
    japi = jget_model(jcfg)
    return (jcfg, japi, jstep.init_train_state(jax.random.key(0), japi,
                                               jcfg),
            cfg, get_model(cfg))


def _port_state(jstate, cfg):
    return bridge.train_state_from_numpy(_to_numpy(jstate), cfg,
                                         device="cpu")


def _grads(api, params, batch, cfg) -> tuple:
    loss, metrics = api.loss(params, _tbatch(batch), cfg)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.detach(), metrics, dict(zip(names, grads))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_its_gradient_match_jax(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(2, 7, 19))).astype(np.float32)
    labels = rng.integers(0, 19, (2, 7)).astype(np.int32)
    mask = ((rng.random((2, 7)) < 0.6).astype(np.float32) if masked
            else None)

    def jloss(x):
        return JL.cross_entropy(x, labels, mask)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    loss, metrics = L.cross_entropy(
        x, torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask))
    (g,) = torch.autograd.grad(loss, [x])
    _close(loss, jl, TOL_F32)
    for k in ("nll", "accuracy"):
        _close(metrics[k], jm[k], TOL_F32, k)
        assert not metrics[k].requires_grad
    _close(g, jg, TOL_F32)


def test_loss_and_every_gradient_leaf_match_jax(pair):
    jcfg, japi, jstate, cfg, api = pair
    batch = _batches(cfg, 1)[0]
    (jl, jm), jg = jax.value_and_grad(japi.loss, has_aux=True)(
        jstate["params"], batch, jcfg)
    state = _port_state(jstate, cfg)
    loss, metrics, grads = _grads(api, state["params"], batch, cfg)
    _close(loss, jl, TOL_F32)
    for k in ("nll", "accuracy", "aux_loss", "loss"):
        _close(metrics[k], jm[k], TOL_F32, k)
    _tree_close(bridge.named_to_numpy(grads, cfg), _to_numpy(jg), TOL_F32,
                "grads")


def test_remat_gives_the_same_bits_as_no_remat():
    """Recomputing each block in the backward changes no bit of the loss or
    of any gradient."""
    jcfg, cfg = _cfgs("qwen2-7b")
    jstate = jstep.init_train_state(jax.random.key(1), jget_model(jcfg), jcfg)
    batch = _batches(cfg, 1, seed=3)[0]
    api = get_model(cfg)
    state = _port_state(jstate, cfg)
    out = [_grads(api, state["params"], batch,
                  dataclasses.replace(cfg, remat=remat))
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for n, g in out[0][2].items():
        assert torch.equal(g, out[1][2][n]), n


@pytest.mark.parametrize("remat", [False, True])
def test_every_gemm_and_both_gradients_go_through_the_kernel(remat,
                                                             monkeypatch):
    """Per train step: every projection and the head once forward (and
    each block's again where the backward recomputes it), then two more
    launches per product: ``da`` with B transposed, ``db`` with A
    transposed. Nothing else multiplies."""
    jcfg, cfg = _cfgs("qwen2-7b")
    cfg = dataclasses.replace(cfg, remat=remat)
    api = get_model(cfg)
    state = _port_state(jstep.init_train_state(
        jax.random.key(0), jget_model(jcfg), jcfg), cfg)
    calls = []
    real = ops.tiled_matmul

    def counting(a, b, c=None, **kw):
        calls.append((bool(kw.get("transpose_a")),
                      bool(kw.get("transpose_b"))))
        return real(a, b, c, **kw)

    monkeypatch.setattr(ops, "tiled_matmul", counting)
    step = tstep.make_train_step(api, cfg, adamw.AdamWConfig(**OPT))
    step(state, _batches(cfg, 1)[0])
    per_block = 4 + 3                     # q, k, v, o; gate, up, down
    fwd = cfg.n_layers * per_block + 1    # and the head
    assert calls.count((False, False)) == fwd + (cfg.n_layers * per_block
                                                  if remat else 0)
    assert calls.count((False, True)) == fwd          # da
    assert calls.count((True, False)) == fwd          # db
    assert len(calls) == 3 * fwd + (cfg.n_layers * per_block if remat else 0)


def test_head_backward_takes_the_f32_cotangent():
    """The LM head multiplies bf16 operands into f32 logits, so its
    cotangent is f32. JAX's gradient multiplies that cotangent as it
    arrives, sums in f32 and rounds once to bf16; so does the port's.
    Rounding the cotangent to bf16 first gives another result: the check
    holds the port to JAX's bits but for rare one-step roundings, which
    the other contract misses by far."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 96)) / 8).astype(np.float32)
    g = rng.normal(size=(16, 96)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: jops.matmul(a, b, out_dtype=jnp.float32),
                     jx, jw)
    jdx, jdw = (_np(np.asarray(t, np.float32)) for t in vjp(jnp.asarray(g)))
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    tw = torch.tensor(w).bfloat16().requires_grad_(True)
    out = ops.matmul(tx, tw, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    dx, dw = torch.autograd.grad(out, [tx, tw], torch.tensor(g))
    assert dx.dtype == dw.dtype == torch.bfloat16

    def one_step_apart(got, want) -> float:
        got = _np(got)
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
        return float((got != want).mean())

    assert one_step_apart(dx, jdx) < 0.02
    assert one_step_apart(dw, jdw) < 0.02
    rounded_first = (torch.tensor(g).bfloat16().float()
                     @ tw.detach().float().T).bfloat16()
    assert (_np(rounded_first) != jdx).mean() > 0.1


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class TestAdamW:
    """The JAX package's `tests/test_runtime.py::TestAdamW` on the port."""

    def _setup(self):
        params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
        grads = {"w": torch.full((4, 4), 0.5), "b": torch.ones((4,))}
        return params, grads, adamw.init_opt_state(params)

    def test_step_moves_params_against_grad(self):
        params, grads, opt = self._setup()
        cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
        new_params, new_opt, metrics = adamw.apply_updates(params, grads,
                                                           opt, cfg)
        assert (new_params["w"] < 1.0).all()
        assert int(new_opt["step"]) == 1
        assert metrics["grad_norm"] > 0

    def test_grad_clip(self):
        params, grads, opt = self._setup()
        grads = {k: g * 1e6 for k, g in grads.items()}
        _, _, metrics = adamw.apply_updates(
            params, grads, opt, adamw.AdamWConfig(grad_clip=1.0,
                                                  warmup_steps=0))
        assert float(metrics["clip_scale"]) < 1e-4

    def test_lr_schedule_shape(self):
        cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                                min_lr_ratio=0.1)
        lrs = [float(adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
               for s in [0, 5, 10, 50, 100]]
        assert lrs[1] == pytest.approx(0.5)
        assert lrs[2] == pytest.approx(1.0, abs=0.01)
        assert lrs[4] == pytest.approx(0.1, abs=0.01)
        assert lrs[3] < lrs[2]

    def test_master_weights_fp32_with_bf16_params(self):
        params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
        opt = adamw.init_opt_state(params)
        assert opt["master"]["w"].dtype == torch.float32
        grads = {"w": torch.full((4, 4), 0.125, dtype=torch.bfloat16)}
        new_params, new_opt, _ = adamw.apply_updates(
            params, grads, opt, adamw.AdamWConfig(warmup_steps=0))
        assert new_params["w"].dtype == torch.bfloat16
        assert new_opt["master"]["w"].dtype == torch.float32

    def test_master_never_aliases_an_f32_param(self):
        params = {"w": torch.ones((4, 4))}
        opt = adamw.init_opt_state(params)
        assert opt["master"]["w"].data_ptr() != params["w"].data_ptr()


def test_lr_at_matches_jax():
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=7, decay_steps=50)
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=7, decay_steps=50)
    for s in [0, 1, 6, 7, 8, 20, 49, 50, 80]:
        _close(adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)),
               jadamw.lr_at(jcfg, jnp.int32(s)), TOL_F32, str(s))


@pytest.mark.parametrize("dtype,clip", [("float32", 1.0), ("float32", 1e3),
                                        ("bfloat16", 1.0)])
def test_apply_updates_matches_jax(dtype, clip):
    """Two AdamW steps, clipped (`grad_clip` 1 against gradient norms of
    about 10) or not, f32 params or bf16 params with f32 master."""
    rng = np.random.default_rng(2)
    shapes = {"w": (8, 6), "b": (6,), "s": (3, 2, 5)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}
    jdt = jnp.dtype(dtype)
    jparams = {k: jnp.asarray(v, jdt) for k, v in init.items()}
    params = {k: torch.tensor(v).to(getattr(torch, dtype))
              for k, v in init.items()}
    jopt, opt = jadamw.init_opt_state(jparams), adamw.init_opt_state(params)
    kw = dict(grad_clip=clip, warmup_steps=1, lr=1e-2)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    for _ in range(2):
        g = {k: (3 * rng.normal(size=s)).astype(np.float32)
             for k, s in shapes.items()}
        jparams, jopt, jm = jadamw.apply_updates(
            jparams, {k: jnp.asarray(v, jdt) for k, v in g.items()}, jopt,
            jcfg)
        params, opt, m = adamw.apply_updates(
            params, {k: torch.tensor(v).to(getattr(torch, dtype))
                     for k, v in g.items()}, opt, cfg)
        for k in ("grad_norm", "lr", "clip_scale"):
            _close(m[k], jm[k], tol, k)
        assert int(opt["step"]) == int(jopt["step"])
        _tree_close({"params": params, **{k: opt[k] for k in
                                          ("master", "m", "v")}},
                    {"params": _to_numpy(jparams),
                     **{k: _to_numpy(jopt[k]) for k in ("master", "m", "v")}},
                    tol)
        assert all(p.dtype == getattr(torch, dtype) for p in params.values())
    if clip == 1.0:
        assert float(m["clip_scale"]) < 1.0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _run_steps(jcfg, cfg, microbatches: int, steps: int = 3, seed: int = 0):
    japi, api = jget_model(jcfg), get_model(cfg)
    jstate = jstep.init_train_state(jax.random.key(seed), japi, jcfg)
    state = _port_state(jstate, cfg)
    jfn = jax.jit(jstep.make_train_step(japi, jcfg,
                                        jadamw.AdamWConfig(**OPT),
                                        microbatches=microbatches))
    fn = tstep.make_train_step(api, cfg, adamw.AdamWConfig(**OPT),
                               microbatches=microbatches)
    out = []
    for batch in _batches(cfg, steps, seed=seed + 7):
        jstate, jm = jfn(jstate, batch)
        state, m = fn(state, batch)
        out.append((m, jm))
    return state, jstate, out


@pytest.mark.parametrize("arch,microbatches", [
    ("qwen2-7b", 1), ("qwen2-7b", 2), ("starcoder2-3b", 1),
    ("starcoder2-3b", 2)])
def test_train_steps_match_jax(arch, microbatches):
    """Three steps: losses, metrics and whole states (params, master, m, v,
    the step and rng)."""
    jcfg, cfg = _cfgs(arch)
    state, jstate, out = _run_steps(jcfg, cfg, microbatches)
    for m, jm in out:
        assert set(m) == set(jm)
        for k in jm:
            _close(m[k], jm[k], TOL_F32, k)
    got = bridge.train_state_to_numpy(state, cfg)
    want = _to_numpy(jstate)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3
    np.testing.assert_array_equal(got["rng"], want["rng"])
    _tree_close(got["params"], want["params"], TOL_F32, "params")
    for k in ("master", "m", "v"):
        _tree_close(got["opt"][k], want["opt"][k], TOL_F32, k)


def test_bf16_train_steps_match_jax():
    """starcoder2-3b's smoke config in bf16, as the full config runs: every
    projection bf16, the head's f32 logits differentiated in f32 (see
    `test_head_backward_takes_the_f32_cotangent`)."""
    jcfg, cfg = _cfgs("starcoder2-3b", bf16=True)
    state, jstate, out = _run_steps(jcfg, cfg, 1)
    for m, jm in out:
        for k in jm:
            _close(m[k], jm[k], TOL_BF16, k)
    assert all(p.dtype == torch.bfloat16
               for p in state["params"].parameters())
    got = bridge.train_state_to_numpy(state, cfg)
    want = _to_numpy(jstate)
    _tree_close(got["params"], want["params"], TOL_BF16, "params")
    for k in ("master", "m", "v"):
        _tree_close(got["opt"][k], want["opt"][k], TOL_BF16, k)


def test_eval_step_matches_jax(pair):
    jcfg, japi, jstate, cfg, api = pair
    batch = _batches(cfg, 1, seed=4)[0]
    jm = jstep.make_eval_step(japi, jcfg)(jstate["params"], batch)
    m = tstep.make_eval_step(api, cfg)(_port_state(jstate, cfg)["params"],
                                       batch)
    for k in jm:
        _close(m[k], jm[k], TOL_F32, k)


def test_serve_steps_are_the_models_forwards(pair):
    jcfg, japi, jstate, cfg, api = pair
    state = _port_state(jstate, cfg)
    prefill, decode = tstep.make_serve_steps(api, cfg)
    toks = torch.as_tensor(_batches(cfg, 1, B=2, S=8)[0]["tokens"])
    logits, st = prefill(state["params"], {"tokens": toks})
    want, _ = api.prefill(state["params"], {"tokens": toks}, cfg)
    assert torch.equal(logits, want)
    nxt, _ = decode(state["params"], logits.argmax(-1), st)
    assert nxt.shape == (2, cfg.vocab)


# ---------------------------------------------------------------------------
# state, registry, fleet
# ---------------------------------------------------------------------------


def test_train_state_carries_over_both_ways(pair):
    jcfg, japi, jstate, cfg, api = pair
    state = _port_state(jstate, cfg)
    assert all(p.requires_grad for p in state["params"].parameters())
    assert state["opt"]["step"].dtype == torch.int32
    assert state["rng"].dtype == torch.uint32
    names = [n for n, _ in state["params"].named_parameters()]
    assert "blocks.1.attn.wq" in names
    for k in ("master", "m", "v"):
        assert list(state["opt"][k]) == names
    back = bridge.train_state_to_numpy(state, cfg)
    want = _to_numpy(jstate)
    np.testing.assert_array_equal(back["rng"], want["rng"])
    _tree_close(back["params"], want["params"], 0.0)
    for k in ("master", "m", "v"):
        _tree_close(back["opt"][k], want["opt"][k], 0.0)


def test_init_train_state_is_trainable_with_its_own_master():
    cfg = get_config("starcoder2-3b", smoke=True)
    state = tstep.init_train_state(torch.Generator().manual_seed(0),
                                   get_model(cfg), cfg, device="cpu")
    params = dict(state["params"].named_parameters())
    assert all(p.requires_grad for p in params.values())
    for n, p in params.items():
        master = state["opt"]["master"][n]
        assert master.dtype == torch.float32
        assert master.data_ptr() != p.data_ptr()
        assert torch.equal(master, p.detach().float())
        assert not state["opt"]["m"][n].any()
    np.testing.assert_array_equal(
        state["rng"].numpy(), np.asarray(jax.random.key_data(
            jax.random.key(0))))
    assert int(state["opt"]["step"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_gemm_shapes_match_jax(arch, smoke):
    for n_tokens in (1, 64, 4096):
        assert gemm_shapes(get_config(arch, smoke=smoke), n_tokens) == \
            jgemm_shapes(jget_config(arch, smoke=smoke), n_tokens)


def test_warm_train_gemms_tunes_the_forward_fleet(monkeypatch):
    cfg = get_config("starcoder2-3b")
    seen = {}

    def warm(shapes, **kw):
        seen.update(shapes=list(shapes), **kw)
        return {}

    monkeypatch.setattr(ops, "warm_gemm_cache", warm)
    assert tstep.warm_train_gemms(cfg, 8, 512) == {}
    assert seen["shapes"] == gemm_shapes(cfg, 8 * 512)
    assert seen["dtype"] == "bfloat16" and seen["objective"] == "runtime"
    assert seen["shapes"] == [(4096, 256, 3072), (4096, 3072, 3072),
                              (4096, 3072, 12288), (4096, 12288, 3072),
                              (4096, 49152, 3072)]
