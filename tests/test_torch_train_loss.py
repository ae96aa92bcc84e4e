"""The other families' training forward and backward against the JAX
package's, on the CPU: each loss, its metrics and every gradient leaf
against `jax.value_and_grad`, and the pieces under them: the SSM scans in
a form autograd can differentiate, the SSD scan's training contractions,
the blocks' no-cache contract, remat, and serving state left alone.

Shared pieces (configs, batches, tolerances) are in
`tests/torch_train_families.py`.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.registry import get_model as jget_model
from repro_torch.models import bridge, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import get_model
from torch_train_families import (FAMILIES, batches, cfgs, close, grads,
                                  jax_state, port_state,
                                  tbatch, to_numpy, tree_close)


def _value_and_grad_case(kind: str, **changes):
    jcfg, cfg = cfgs(kind, **changes)
    japi = jget_model(jcfg)
    jstate = jax_state(jcfg)
    batch = batches(cfg, 1)[0]
    (jl, jm), jg = jax.value_and_grad(japi.loss, has_aux=True)(
        jstate["params"], batch, jcfg)
    state = port_state(jstate, cfg)
    loss, metrics, gs = grads(get_model(cfg), state["params"], batch, cfg)
    close(loss, jl, what="loss")
    assert set(metrics) == set(jm)
    for k in jm:
        close(metrics[k], jm[k], what=k)
        assert not metrics[k].requires_grad
    tree_close(bridge.named_to_numpy(gs, cfg), to_numpy(jg), where="grads")
    return metrics


@pytest.mark.parametrize("kind", FAMILIES)
def test_loss_metrics_and_every_gradient_leaf_match_jax(kind):
    """moe and mla_moe add their load-balancing loss (``aux_loss``); the
    hybrid's shared block gathers its gradient over both groups; encdec's
    cross-attention KV over every decoder layer; vlm masks its patches."""
    metrics = _value_and_grad_case(kind)
    if kind in ("moe", "mla_moe"):
        assert float(metrics["aux_loss"]) > 0.0


def test_dropped_tokens_keep_a_zero_gate_in_the_backward(monkeypatch):
    """At capacity factor 1 the smoke MoE drops tokens (a row's 16 tokens
    pick 2 of 8 experts into 4 slots an expert): the loss and every
    gradient still match JAX's, whose dropped tokens carry no gate."""
    from repro_torch.models import moe

    routes = []
    real = moe.route

    def recording(*args, **kw):
        routes.append(real(*args, **kw))
        return routes[-1]

    monkeypatch.setattr(moe, "route", recording)
    _value_and_grad_case("moe", capacity_factor=1.0)
    assert routes and any(not r["keep"].all() for r in routes)
    for r in routes:
        assert (r["gate"][~r["keep"]] == 0).all()


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


def _in_place_block_prefix(a, b):
    """The serving path's scan as it was written before this form: each
    step written into a preallocated buffer."""
    A, Bc = torch.empty_like(a), torch.empty_like(b)
    A[:, :, 0], Bc[:, :, 0] = a[:, :, 0], b[:, :, 0]
    for t in range(1, a.shape[2]):
        A[:, :, t] = A[:, :, t - 1] * a[:, :, t]
        Bc[:, :, t] = Bc[:, :, t - 1] * a[:, :, t] + b[:, :, t]
    return A, Bc


def _in_place_cumsum(a):
    out = torch.empty_like(a)
    out[:, :, 0] = a[:, :, 0]
    for t in range(1, a.shape[2]):
        out[:, :, t] = out[:, :, t - 1] + a[:, :, t]
    return out


def test_scans_keep_the_serving_bits_and_differentiate():
    """The step lists give the in-place form's bits; the in-place form
    cannot be differentiated (autograd saves a step it then overwrites),
    the lists can, and their gradients match JAX's associative scan."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 3, 9, 4, 5), generator=g)
    b = torch.randn((2, 3, 9, 4, 5), generator=g)
    for got, want in zip(ssm._block_prefix(a, b),
                         _in_place_block_prefix(a, b)):
        assert torch.equal(got, want)
    assert torch.equal(ssm._cumsum_steps(b), _in_place_cumsum(b))
    ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="inplace"):
        sum(t.sum() for t in _in_place_block_prefix(ar, br)).backward()
    # mamba1_scan's gradient against the JAX scan's
    rng = np.random.default_rng(1)
    decay = rng.uniform(0.5, 1.0, (2, 21, 4, 3)).astype(np.float32)
    inp = rng.normal(size=(2, 21, 4, 3)).astype(np.float32)
    C = rng.normal(size=(2, 21, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 4, 3)).astype(np.float32)
    w = rng.normal(size=(2, 21, 4)).astype(np.float32)

    def jloss(d, i, c, h):
        y, hf = jssm.mamba1_scan(d, i, c, h, chunk=8)
        return (y * w).sum() + (hf ** 2).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(decay, inp, C, h0)
    ts = [torch.tensor(v, requires_grad=True) for v in (decay, inp, C, h0)]
    y, hf = ssm.mamba1_scan(*ts, chunk=8)
    ((y * torch.tensor(w)).sum() + (hf ** 2).sum()).backward()
    for t, want in zip(ts, jg):
        close(t.grad, want)


@pytest.mark.parametrize("S,chunk", [(48, 8), (21, 8), (40, 16)])
def test_ssd_scan_training_contractions_match_jax_and_serving(S, chunk):
    """Without a cache the SSD scan contracts with einsums (no temporary
    the size of the product); its outputs and its gradients match JAX's,
    and its outputs the serving form's to f32 rounding."""
    rng = np.random.default_rng(2)
    args = (rng.normal(size=(2, S, 3, 4)),
            -rng.uniform(0.0, 0.5, (2, S, 3)),
            rng.normal(size=(2, S, 5)), rng.normal(size=(2, S, 5)),
            rng.normal(size=(2, 3, 5, 4)))
    args = [np.asarray(v, np.float32) for v in args]
    w = rng.normal(size=(2, S, 3, 4)).astype(np.float32)

    def jloss(*xs):
        y, h = jssm.ssd_scan(*xs, chunk=chunk)
        return (y * w).sum() + (h ** 2).sum()

    jl, jg = jax.value_and_grad(jloss, argnums=tuple(range(5)))(*args)
    ts = [torch.tensor(v, requires_grad=True) for v in args]
    y, h = ssm.ssd_scan(*ts, chunk=chunk, rowwise=False)
    loss = (y * torch.tensor(w)).sum() + (h ** 2).sum()
    loss.backward()
    close(loss, jl)
    for t, want in zip(ts, jg):
        close(t.grad, want)
    ys, hs = ssm.ssd_scan(*(torch.tensor(v) for v in args), chunk=chunk)
    close(y, ys)
    close(h, hs)


# ---------------------------------------------------------------------------
# blocks, remat, serving state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["moe", "mla_moe", "mamba1", "mamba2"])
def test_lm_blocks_without_a_cache_return_no_cache_and_their_aux(kind):
    """`lm_loss` takes (x, None, aux) from every LM kind's block."""
    jcfg, cfg = cfgs(kind)
    params = port_state(jax_state(jcfg), cfg)["params"]
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    pos = torch.arange(8).expand(2, 8)
    out, cache, aux = tfm.block_apply(cfg)(params.blocks[0], x, cfg,
                                           positions=pos)
    assert out.shape == x.shape and cache is None
    if kind in ("moe", "mla_moe"):
        assert aux.shape == () and aux.item() > 0.0
    else:
        assert aux == 0.0


@pytest.mark.parametrize("kind", ["moe", "hybrid", "encdec", "vlm"])
def test_remat_gives_the_same_bits_as_no_remat(kind):
    """Recomputing each unit (a block; hybrid's group; encdec's encoder and
    decoder layers) changes no bit of the loss or of any gradient."""
    jcfg, cfg = cfgs(kind)
    params = port_state(jax_state(jcfg, seed=1), cfg)["params"]
    batch = batches(cfg, 1, seed=3)[0]
    api = get_model(cfg)
    out = [grads(api, params, batch, dataclasses.replace(cfg, remat=remat))
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for n, g in out[0][2].items():
        assert torch.equal(g, out[1][2][n]), n


def _serving_state(api, params, cfg):
    """A decode state after a 2-row, 5-token chunk (admitted first for the
    modality families)."""
    B = 2
    state = api.init_state(cfg, B, 16, device="cpu")
    rng = np.random.default_rng(4)
    if cfg.kind == "encdec":
        extras = [{"src_embeds": rng.normal(size=(6, cfg.d_model))}] * B
        state = api.admit(params, api.pack_admit(cfg, extras, B, 8,
                                                 device="cpu"), state, cfg)
    elif cfg.kind == "vlm":
        extras = [{"patch_embeds": rng.normal(size=(4, cfg.d_model)),
                   "grid_hw": (2, 2)}] * B
        state = api.admit(params, api.pack_admit(cfg, extras, B, 4,
                                                 device="cpu"), state, cfg)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, 5)))
    _, state = api.prefill_chunk(params, tokens, torch.full((B,), 5), state,
                                 cfg)
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("kind", FAMILIES)
def test_a_loss_and_its_backward_leave_a_serving_state_alone(kind):
    """The training forward writes no cache: a serving state built before
    it holds the same bits after the loss and its backward."""
    jcfg, cfg = cfgs(kind)
    params = port_state(jax_state(jcfg), cfg)["params"]
    api = get_model(cfg)
    state = _serving_state(api, params, cfg)
    before = [t.clone() for t in _leaves(state)]
    loss, _ = api.loss(params, tbatch(batches(cfg, 1)[0]), cfg)
    loss.backward()
    after = _leaves(state)
    assert len(after) == len(before)
    for b, a in zip(before, after):
        assert torch.equal(a, b)
    assert any(t.abs().sum() > 0 for t in after if t.is_floating_point())
