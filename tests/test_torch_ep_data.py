"""Experts over "data" (``moe_expert_axis="data"``) against the JAX package
at tp=1, on the CPU.

The port trains in rank processes (one `RankPool` of four gloo ranks for
the module: a (2, 2) mesh or two copies of a (2, 1) one; their entry
points are `tests/torch_sp_ranks.py`). Each rank holds E/data experts,
each with its d_ff/tp block, and sends its rows' dispatch slots to the
experts' owners by an all-to-all over "data". For the olmoe-1b-7b and
deepseek-v2-236b smoke configs (f32), with and without sequence
parallelism: the loss, the aux loss (the whole batch's, as the
reference's dense dispatch computes it) and every gradient leaf against
`jax.value_and_grad` at tp=1, with the f32 tolerance of
`torch_train_families.close`; the expert leaves are not summed over
"data" (their gradient is whole after the exchange's backward), and the
step equals the port's step with the experts over "model".
"""

from __future__ import annotations

import dataclasses

import jax
import pytest

import torch_sp_ranks as R
from repro.models.registry import get_model as jget_model
from repro.train import step as jstep
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import RankPool, make_dry_mesh
from repro_torch.models.registry import get_model
from repro_torch.train.step import train_config
from torch_train_families import OPT, batches, cfgs, close, to_numpy

KINDS = ("moe", "mla_moe")
EXPERTS = ("w_gate", "w_up", "w_down")


def _cfgs(kind: str, sp: bool = False) -> tuple:
    jcfg, cfg = cfgs(kind)
    return jcfg, dataclasses.replace(cfg, moe_expert_axis="data",
                                     sequence_parallel=sp)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def reference():
    """{kind: the JAX package's tp=1 numbers}, each made once, jitted."""
    from repro_torch.models import bridge

    out = {}

    def get(kind: str) -> dict:
        if kind in out:
            return out[kind]
        jcfg, cfg = _cfgs(kind)
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


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_ep_data_loss_aux_and_gradients_match_jax(kind, shape, sp, pool,
                                                  reference):
    """Every rank's loss, aux loss and metrics and every gradient leaf
    (gathered over "data" and "model") equal `jax.value_and_grad`'s at
    tp=1; the rank holds E/data experts of d_ff/tp each; its expert
    leaves are the ones cut over "data"; it posted the all-to-alls; SP
    ran where tp > 1."""
    _, cfg = _cfgs(kind, sp)
    ref = reference(kind)
    data, tp = shape
    E, F = cfg.n_experts, cfg.d_ff_expert
    for out in pool.run(R.loss_and_grads, shape, cfg, ref["tree"],
                        ref["batch"]):
        close(out["loss"], ref["loss"], what="loss")
        assert set(out["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            close(out["metrics"][k], v, what=k)
        assert set(out["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)
        assert out["local"]["blocks.0.moe.experts.w_gate"] == (
            E // data, cfg.d_model, F // tp)
        assert out["local"]["blocks.1.moe.experts.w_down"] == (
            E // data, F // tp, cfg.d_model)
        assert out["data_cut"] == sorted(
            f"blocks.{i}.moe.experts.{w}" for i in range(cfg.n_layers)
            for w in EXPERTS)
        assert out["posted"]["all-to-all"]["calls"] == 4 * cfg.n_layers
        assert out["sp"] == (sp and tp > 1)


@pytest.mark.parametrize("kind", KINDS)
def test_ep_data_steps_match_the_experts_over_model(kind, pool, reference):
    """Two steps of `make_train_step` at (2, 2) with the experts over
    "data" and SP, ZeRO-1 on (which leaves the expert leaves' state cut
    with them), against two with the experts over "model": every step's
    metrics and the whole final params, master, m and v."""
    _, cfg = _cfgs(kind, sp=True)
    ref = reference(kind)
    steps = batches(cfg, 2, seed=7)
    ep = pool.run(R.train_steps, (2, 2), cfg, ref["tree"], steps, OPT,
                  True)[0]
    tp = pool.run(R.train_steps, (2, 2),
                  dataclasses.replace(cfg, moe_expert_axis="model",
                                      sequence_parallel=False),
                  ref["tree"], steps, OPT, True)[0]
    for got, want in zip(ep["metrics"], tp["metrics"]):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=k)
    assert set(ep["state"]) == set(tp["state"])
    for k, want in tp["state"].items():
        close(ep["state"][k], want, what=k)


def test_layout_cuts_experts_over_data_and_d_ff_over_model():
    """On a (2, 2) mesh the layout puts an expert leaf's E on "data"
    (`expert_axes`) and its d_ff on "model" (`param_axes`), keeps FSDP
    and ZeRO-1 off it, and refuses an E "data" does not divide."""
    _, cfg = _cfgs("moe")
    mesh = make_dry_mesh((2, 2))
    tcfg = train_config(cfg, mesh, check=False)
    whole = get_model(cfg).init(tcfg, None, device="meta")
    layout = sharding.train_layout(whole, mesh, tcfg, zero1=True)
    for w, ax in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        name = f"blocks.0.moe.experts.{w}"
        assert layout.axes[name] == ax
        assert layout.experts[name] == 0 and layout.fsdp[name] is None
        assert layout.zero1[name] is None
    assert layout.experts["blocks.0.moe.router.w"] is None
    assert layout.data_cut() == {n for n, ax in layout.experts.items()
                                 if ax is not None}
    with pytest.raises(ValueError, match="n_experts"):
        train_config(dataclasses.replace(cfg, n_experts=6),
                     make_dry_mesh((4, 1)))


def test_the_launcher_trains_with_sequence_parallelism(tmp_path):
    """``python -m repro_torch.launch.train --tp 2 --dp 2
    --sequence-parallel`` (four CPU ranks, a MoE kind) logs the losses and
    grad norms of the same run without the flag."""
    from repro_torch.launch import train as launch

    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--tp",
            "2", "--dp", "2", "--steps", "2", "--batch", "4", "--seq", "32",
            "--log-every", "1", "--ckpt-every", "10"]
    runs = []
    for extra in ([], ["--sequence-parallel"]):
        _, summary = launch.main(argv + extra + [
            "--ckpt-dir", str(tmp_path / str(len(extra)))], log_fn=None)
        runs.append(summary)
    for k in ("loss_curve", "grad_norms"):
        close(runs[1][k], runs[0][k], what=k)
