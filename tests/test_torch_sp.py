"""Megatron sequence parallelism (``cfg.sequence_parallel`` in psum mode)
against the JAX package at tp=1, on the CPU.

The port trains in rank processes (one `RankPool` of four gloo ranks for
the module: a (1, 4) mesh or two copies of a (1, 2) one; their entry
points are `tests/torch_sp_ranks.py`), each rank holding its shard of the
weights bridged from JAX and running the residual stream and the norms
on its 1/tp of the sequence. For the dense (qwen2-7b: GQA whose 2 KV
heads stay whole at tp=4), moe (olmoe-1b-7b under both ``moe_impl``s),
mla_moe (deepseek-v2-236b), vlm (qwen2-vl-2b, its patch prefix in the
sequence) and hybrid (zamba2-2.7b: only the shared block takes SP) smoke
configs, f32: the loss, its metrics and every gradient leaf after the
train step's reductions (the leaves "model" does not cut summed over
"model") against `jax.value_and_grad` at tp=1, with the f32 tolerance of
`torch_train_families.close` (1e-5, the absolute part scaled by
max(1, max|reference leaf|)). The SP step is held to the port's own
psum step without SP, and a prefill whose sequence tp does not divide
runs without SP.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import torch_sp_ranks as R
from repro.models.registry import get_model as jget_model
from repro.train import step as jstep
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import RankPool
from repro_torch.models.registry import get_model
from torch_train_families import OPT, batches, cfgs, close, to_numpy

# case -> (kind, config changes)
CASES = {"dense": ("dense", {}),
         "moe-spmd": ("moe", {}),
         "moe-shard_map": ("moe", {"moe_impl": "shard_map"}),
         "mla_moe": ("mla_moe", {}),
         "vlm": ("vlm", {}),
         "hybrid": ("hybrid", {})}


def _cfgs(case: str) -> tuple:
    """(JAX config, port config with SP) of `case` at smoke size."""
    kind, changes = CASES[case]
    if kind == "dense":
        from repro.configs import get_config as jget_config
        from repro_torch.configs import get_config

        jcfg = jget_config("qwen2-7b", smoke=True)
        cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                                  **changes)
    else:
        jcfg, cfg = cfgs(kind, **changes)
    return jcfg, dataclasses.replace(cfg, sequence_parallel=True)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def reference():
    """{kind: the JAX package's tp=1 numbers}, each made once, jitted:
    the weights (numpy), one batch's loss, metrics and gradients (by the
    port's names). At tp=1 both ``moe_impl``s are the dense path."""
    from repro_torch.models import bridge

    out = {}

    def get(case: str) -> dict:
        kind = CASES[case][0]
        if kind in out:
            return out[kind]
        jcfg, cfg = _cfgs(case)
        japi = jget_model(jcfg)
        jstate = jax.jit(lambda key: jstep.init_train_state(
            key, japi, jcfg))(jax.random.key(0))
        batch = batches(cfg, 1)[0]
        (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                               static_argnums=2)(jstate["params"], batch,
                                                 jcfg)
        out[kind] = {"tree": to_numpy(jstate["params"]), "batch": batch,
                     "loss": float(jl),
                     "metrics": {k: float(v) for k, v in jm.items()},
                     "grads": bridge.named_from_numpy(to_numpy(jg), cfg,
                                                      "cpu")}
        return out[kind]

    return get


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_loss_and_every_gradient_leaf_match_jax(case, tp, pool,
                                                   reference):
    """Every rank's loss and metrics and every reduced gradient leaf
    under SP equal `jax.value_and_grad`'s at tp=1; the step ran under SP
    (tp divides the 16 tokens, the vlm's 32 with its patches), posted
    reduce-scatters, and every leaf "model" leaves whole has one gradient
    on every rank after the sum."""
    _, cfg = _cfgs(case)
    ref = reference(case)
    ranks = pool.run(R.loss_and_grads, (1, tp), cfg, ref["tree"],
                     ref["batch"])
    for out in ranks:
        assert out["sp"]
        assert out["posted"]["reduce-scatter"]["calls"] > 0
        close(out["loss"], ref["loss"], what="loss")
        assert set(out["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            close(out["metrics"][k], v, what=k)
        assert set(out["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)
    whole = ranks[0]["whole_leaves"]
    assert "blocks.0.ln1.scale" in whole or "shared_attn.ln1.scale" in whole
    for out in ranks[1:]:
        for n, g in whole.items():
            np.testing.assert_allclose(out["whole_leaves"][n], g,
                                       rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("kind", ["dense", "moe", "mla_moe", "vlm",
                                  "hybrid", "mamba1", "encdec"])
def test_sequence_partial_names_the_leaves_the_sp_blocks_use_whole(kind):
    """The leaves summed over "model" under SP: every leaf "model" does
    not cut for the stack kinds (norms, the router, ``ln_f``), the
    hybrid's shared block's alone, none for the kinds that ignore the
    flag; none without the flag."""
    if kind == "dense":
        _, cfg = _cfgs("dense")
    else:
        cfg = dataclasses.replace(cfgs(kind)[1], sequence_parallel=True)
    whole = get_model(cfg).init(cfg, None, device="meta")
    axes = sharding.param_axes(whole, 2, "psum", cfg)
    got = sharding.sequence_partial(axes, cfg)
    assert all(axes[n] is None for n in got)
    if kind in ("mamba1", "encdec"):
        assert got == set()
    elif kind == "hybrid":
        assert got and all(n.startswith("shared_attn.") for n in got)
        assert "shared_attn.ln1.scale" in got and "ln_f.scale" not in got
    else:
        assert {"ln_f.scale", "blocks.0.ln1.scale",
                "blocks.1.ln2.scale"} <= got
        assert got == {n for n, ax in axes.items() if ax is None}
        if kind in ("moe", "mla_moe"):
            assert "blocks.0.moe.router.w" in got
    off = dataclasses.replace(cfg, sequence_parallel=False)
    assert sharding.sequence_partial(axes, off) == set()


def test_sp_steps_match_the_psum_steps_without_sp(pool, reference):
    """Two steps of `make_train_step` at tp=2 under SP against two
    without it, from the same weights (the dense config; the MoE kinds'
    steps under SP are held in `tests/test_torch_ep_data.py`): every
    step's metrics and the whole final params, master, m and v."""
    _, cfg = _cfgs("dense")
    ref = reference("dense")
    steps = batches(cfg, 2, seed=7)
    sp = pool.run(R.train_steps, (1, 2), cfg, ref["tree"], steps, OPT)[0]
    plain = pool.run(R.train_steps, (1, 2),
                     dataclasses.replace(cfg, sequence_parallel=False),
                     ref["tree"], steps, OPT)[0]
    for got, want in zip(sp["metrics"], plain["metrics"]):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=k)
    assert set(sp["state"]) == set(plain["state"])
    for k, want in plain["state"].items():
        close(sp["state"][k], want, what=k)


@pytest.mark.parametrize("S", [15, 16])
def test_a_prefill_tp_does_not_divide_runs_without_sp(S, pool, reference):
    """The psum-mode prefill (the dry-run rank's) of 15 tokens at tp=2
    runs without SP: no reduce-scatter, the row-parallel sums
    all-reduced; of 16 tokens under SP. Both give tp=1's last logits
    within 1e-5."""
    _, cfg = _cfgs("dense")
    ref = reference("dense")
    tokens = np.asarray(ref["batch"]["tokens"])[:, :S]
    one = pool.run(R.prefill_logits, (1, 1), cfg, ref["tree"], tokens)[0]
    for out in pool.run(R.prefill_logits, (1, 2), cfg, ref["tree"], tokens):
        assert out["sp"] == (S % 2 == 0)
        assert ("reduce-scatter" in out["posted"]) == out["sp"]
        close(out["logits"], one["logits"], what="logits")
