"""Training under tensor parallelism (psum mode) against the JAX package
at tp=1, on the CPU.

The port trains in rank processes (one `RankPool` of four gloo ranks for
the module: a tp=4 mesh, or two copies of a tp=2 mesh; their entry points
are `tests/torch_tp_train_ranks.py`), each rank holding its shard of the
weights bridged from JAX. The dense (qwen2-7b: biases, GQA whose 2 KV
heads stay whole at tp=4; starcoder2-3b), MoE (olmoe-1b-7b, under both
``moe_impl``s) and MLA (deepseek-v2-236b) smoke configs, f32: the loss,
its metrics and every gathered gradient leaf against
`jax.value_and_grad`, and three steps of `make_train_step` against
``jax.jit(make_train_step)``, at the f32 tolerance with its absolute
part scaled by max(1, max|reference leaf|); every leaf "model" leaves
whole has the same gradient bits on every rank. The explicit
expert-parallel MoE (`moe_ffn_shard_map`) is held at (data 2, model 2),
where its aux loss is each data shard's own, to the reference's on a
four-device ``AxisType.Auto`` mesh in a subprocess.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_tp_train_ranks as R
from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.launch.mesh import RankPool
from repro_torch.models import bridge
from torch_train_families import OPT, batches, close, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"qwen2-7b": ("qwen2-7b", "spmd"),
         "starcoder2-3b": ("starcoder2-3b", "spmd"),
         "olmoe-spmd": ("olmoe-1b-7b", "spmd"),
         "olmoe-shard_map": ("olmoe-1b-7b", "shard_map"),
         "deepseek-spmd": ("deepseek-v2-236b", "spmd"),
         "deepseek-shard_map": ("deepseek-v2-236b", "shard_map")}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def reference():
    """{arch: the JAX package's tp=1 numbers}, each made once, jitted:
    the weights (numpy), one batch's loss, metrics and gradients (by the
    port's names), and three train steps' metrics and final state (by
    flat checkpoint key). At tp=1 both ``moe_impl``s are the dense
    path."""
    out = {}

    def get(arch: str) -> dict:
        if arch in out:
            return out[arch]
        jcfg = jget_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        japi = jget_model(jcfg)
        jstate = jax.jit(lambda key: jstep.init_train_state(
            key, japi, jcfg))(jax.random.key(0))
        batch = batches(cfg, 1)[0]
        (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                               static_argnums=2)(jstate["params"], batch,
                                                 jcfg)
        steps = batches(cfg, 3, seed=7)
        tree = to_numpy(jstate["params"])
        jfn = jax.jit(jstep.make_train_step(japi, jcfg,
                                            jadamw.AdamWConfig(**OPT)))
        metrics = []
        for b in steps:
            jstate, m = jfn(jstate, b)
            metrics.append({k: float(v) for k, v in m.items()})
        final = to_numpy(jstate)
        flat = {f"params__{n}": t for n, t in bridge.named_from_numpy(
            final["params"], cfg, "cpu").items()}
        for k in ("master", "m", "v"):
            flat.update({f"opt__{k}__{n}": t for n, t in
                         bridge.named_from_numpy(final["opt"][k], cfg,
                                                 "cpu").items()})
        out[arch] = {
            "tree": tree, "batch": batch, "loss": float(jl),
            "metrics": {k: float(v) for k, v in jm.items()},
            "grads": bridge.named_from_numpy(to_numpy(jg), cfg, "cpu"),
            "steps": steps, "step_metrics": metrics, "final": flat}
        return out[arch]

    return get


def _cfg(case: str):
    arch, impl = CASES[case]
    return dataclasses.replace(get_config(arch, smoke=True), moe_impl=impl)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_leaf_match_jax(case, tp, pool,
                                                reference):
    """Every rank's loss and metrics and the gathered gradient of every
    leaf equal `jax.value_and_grad`'s at tp=1; the leaves "model" keeps
    whole (norms, the router, MLA's w_dq/w_dkv/w_kpe, qwen2's wk, wv, bk
    and bv at tp=4) have one gradient, bit for bit, on every rank."""
    cfg = _cfg(case)
    ref = reference(CASES[case][0])
    ranks = pool.run(R.loss_and_grads, (1, tp), cfg, ref["tree"],
                     ref["batch"])
    for out in ranks:
        close(out["loss"], ref["loss"], what="loss")
        assert set(out["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            close(out["metrics"][k], v, what=k)
        assert set(out["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)
    whole = ranks[0]["whole_leaves"]
    assert whole and "ln_f.scale" in whole
    if case == "qwen2-7b" and tp == 4:
        assert {"blocks.0.attn.wk", "blocks.0.attn.bv"} <= set(whole)
    for out in ranks[1:]:
        for n, g in whole.items():
            np.testing.assert_array_equal(out["whole_leaves"][n], g,
                                          err_msg=n)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_train_steps_match_jax(case, tp, pool, reference):
    """Three steps of `make_train_step` on the tp mesh against
    ``jax.jit(make_train_step)`` at tp=1: each step's metrics (loss, the
    global grad norm, lr, clip scale, aux), then the whole gathered
    params, master, m and v."""
    cfg = _cfg(case)
    ref = reference(CASES[case][0])
    out = pool.run(R.train_steps, (1, tp), cfg, ref["tree"], ref["steps"],
                   OPT)[0]
    assert out["step"] == 3
    for got, want in zip(out["metrics"], ref["step_metrics"]):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=k)
    assert set(out["state"]) >= set(ref["final"])
    for k, want in ref["final"].items():
        close(out["state"][k], want, what=k)


def test_remat_recomputes_its_blocks_collectives_in_autograds_thread(
        pool, reference):
    """With remat, the backward recomputes each block; on the card
    autograd runs the backward in a device thread of its own, where the
    thread's mesh is not installed. A backward run in another thread must
    still give tp=1's gradients at tp=2: the recomputation makes each
    block's first row-parallel all-reduce again (the second lies past the
    block's last saved tensor), so per layer three collectives (two block
    entries and the recomputed one) and the head's entry."""
    cfg = dataclasses.replace(_cfg("qwen2-7b"), remat=True)
    ref = reference("qwen2-7b")
    ranks = pool.run(R.loss_and_grads, (1, 2), cfg, ref["tree"],
                     ref["batch"], True)
    for out in ranks:
        close(out["loss"], ref["loss"], what="loss")
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)
        assert out["backward_collectives"] == 3 * cfg.n_layers + 1


# the reference's explicit expert-parallel MoE at (data 2, model 2): its
# output, aux loss and the gradients of sum(out * cot) + aux, saved to
# an .npz (run with four forced host devices)
_JAX_SHARD_MAP = """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed.sharding import set_mesh_rules
    from repro.models import moe

    z = np.load(sys.argv[1])
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              moe_impl="shard_map")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    set_mesh_rules(mesh)
    p = {"router": {"w": jnp.asarray(z["router"])},
         "experts": {k: jnp.asarray(z[k])
                     for k in ("w_gate", "w_up", "w_down")}}
    cot = jnp.asarray(z["cot"])

    def f(p, x):
        out, aux = moe.moe_ffn(p, x, cfg)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(z["x"]))
    np.savez(sys.argv[2], out=out, aux=aux, gx=gx, router=gp["router"]["w"],
             **{k: gp["experts"][k] for k in ("w_gate", "w_up", "w_down")})
"""


def test_moe_shard_map_matches_the_references_at_2x2(pool, tmp_path):
    """`moe_ffn_shard_map` on a (data 2, model 2) mesh (tokens on "data",
    experts on "model", the partial outputs summed over "model") against
    the reference's on the same mesh: the output rows, the aux loss (each
    data shard's own, averaged: not the dense path's), and the gradients
    of ``sum(out * cot) + aux`` for the input, the router (summed over
    "model" by the reference's shard_map) and the experts."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    rng = np.random.default_rng(3)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    arrays = {"x": rng.normal(size=(4, 16, d)).astype(np.float32),
              "cot": rng.normal(size=(4, 16, d)).astype(np.float32),
              "router": (rng.normal(size=(d, E)) / 8).astype(np.float32),
              "w_gate": (rng.normal(size=(E, d, f)) / 8).astype(np.float32),
              "w_up": (rng.normal(size=(E, d, f)) / 8).astype(np.float32),
              "w_down": (rng.normal(size=(E, f, d)) / 11).astype(np.float32)}
    src, dst = tmp_path / "in.npz", tmp_path / "ref.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(_JAX_SHARD_MAP), str(src),
                          str(dst)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = dict(np.load(dst))
    ranks = pool.run(R.moe_shard_map, (2, 2), cfg, arrays)
    for out in ranks:
        for k in ("out", "aux", "gx", "router", "w_gate", "w_up", "w_down"):
            close(out[k], want[k], what=k)
    dense = pool.run(R.moe_shard_map, (1, 1), cfg, arrays)[0]
    assert abs(dense["aux"] - float(want["aux"])) > 1e-6
