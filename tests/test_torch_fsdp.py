"""FSDP training against the JAX package at tp=1, on the CPU.

The smoke configs of the three models the reference trains with FSDP by
default (qwen2.5-14b, falcon-mamba-7b, deepseek-v2-236b; their smoke
configs leave it off, so both packages' are given ``fsdp=True`` through
``dataclasses.replace``), and for the loss and gradients also those of the
hybrid (zamba2-2.7b) and the encoder-decoder (seamless-m4t-medium), train on a (data 2, model 1) and a (2, 2) mesh
of gloo ranks (one `RankPool` of four for the module; entry points in
`torch_mesh_ranks.py` and `torch_tp_train_ranks.py`). Each leaf the
reference's rules put on "data" is cut to the rank's block, gathered
before use and its gradient reduce-scattered (`distributed.fsdp`). The
loss and every gathered gradient leaf equal `jax.value_and_grad`'s, three
steps of `make_train_step` equal ``jax.jit(make_train_step)``'s (metrics,
then the whole params, master, m and v), f32 at ROADMAP's 1e-5 with its
absolute part scaled by max(1, max|reference leaf|); a checkpoint saved
under FSDP at (2, 2) and restored at (1, 1) gives the reference's third
step.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as M
import torch_tp_train_ranks as R
from repro.configs import get_config as jget_config
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.distributed import tp as TP
from repro_torch.launch.mesh import RankPool
from repro_torch.models import bridge
from torch_train_families import OPT, batches, close, to_numpy

ARCHS = ("qwen2.5-14b", "falcon-mamba-7b", "deepseek-v2-236b")
# the families with block loops of their own (the hybrid's groups, the
# encoder-decoder's two stacks), trained under FSDP as well
FAMILIES = ("zamba2-2.7b", "seamless-m4t-medium")
SHAPES = [(2, 1), (2, 2)]


def _cfgs(arch: str) -> tuple:
    return (dataclasses.replace(jget_config(arch, smoke=True), fsdp=True),
            dataclasses.replace(get_config(arch, smoke=True), fsdp=True))


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def reference():
    """{arch: the JAX package's tp=1 numbers}, made once each, jitted:
    the weights, one batch's loss and gradients (by the port's names),
    and but for `FAMILIES` three steps' metrics and final state (by flat
    checkpoint key)."""
    out = {}

    def get(arch: str) -> dict:
        if arch in out:
            return out[arch]
        jcfg, cfg = _cfgs(arch)
        japi = jget_model(jcfg)
        jstate = jax.jit(lambda key: jstep.init_train_state(
            key, japi, jcfg))(jax.random.key(0))
        batch = batches(cfg, 1)[0]
        (jl, _), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                              static_argnums=2)(jstate["params"], batch,
                                                jcfg)
        tree = to_numpy(jstate["params"])
        out[arch] = {
            "tree": tree, "batch": batch, "loss": float(jl),
            "grads": bridge.named_from_numpy(to_numpy(jg), cfg, "cpu")}
        if arch in FAMILIES:
            return out[arch]
        steps = batches(cfg, 3, seed=7)
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
        out[arch].update(steps=steps, step_metrics=metrics, final=flat)
        return out[arch]

    return get


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_loss_and_every_gradient_leaf_match_jax(arch, shape, pool,
                                                reference):
    """Every rank's loss and the gathered gradient of every leaf equal
    `jax.value_and_grad`'s at tp=1; the embedding, the head and each
    block's projections are cut over "data" (their local leading or
    trailing axis half the whole), in the hybrid's shared block and the
    encoder-decoder's two stacks too."""
    _, cfg = _cfgs(arch)
    ref = reference(arch)
    ranks = pool.run(M.fsdp_loss_and_grads, shape, cfg, ref["tree"],
                     ref["batch"])
    for out in ranks:
        close(out["loss"], ref["loss"], what="loss")
        assert set(out["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            close(out["grads"][n], g, what=n)
    cut = ranks[0]["cut"]
    assert "embed.table" in cut and any(".ssm.in_proj" in n or
                                        ".w_dkv" in n or ".mlp.w_up" in n
                                        for n in cut)
    if arch in FAMILIES:
        assert any(n.startswith(("shared_attn.", "encoder.")) for n in cut)
    for n in cut:
        whole = ref["grads"][n].shape
        local = ranks[0]["local"][n]
        assert any(w == 2 * l for w, l in zip(whole, local)), n


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, shape, pool, reference):
    """Three steps of `make_train_step` under FSDP against
    ``jax.jit(make_train_step)`` at tp=1: each step's metrics (the global
    grad norm summing the cut leaves' squares over "data"), then the whole
    gathered params, master, m and v."""
    _, cfg = _cfgs(arch)
    ref = reference(arch)
    out = pool.run(R.train_steps, shape, cfg, ref["tree"], ref["steps"],
                   OPT)[0]
    assert out["step"] == 3
    for got, want in zip(out["metrics"], ref["step_metrics"]):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=k)
    for k, want in ref["final"].items():
        close(out["state"][k], want, what=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_under_fsdp_restores_at_1x1(arch, pool, reference,
                                               tmp_path):
    """Two steps at (2, 2) under FSDP, a whole-leaf checkpoint (each cut
    leaf and its state gathered over "data" and "model"), restored on a
    (1, 1) mesh: the third step there equals the reference's third."""
    _, cfg = _cfgs(arch)
    ref = reference(arch)
    ranks = pool.run(M.fsdp_save_then_resume, (2, 2), cfg, ref["tree"],
                     ref["steps"], OPT, str(tmp_path / arch))
    for out in ranks:
        assert out["step"] == 3
        for k, want in ref["step_metrics"][-1].items():
            close(out["metrics"][k], want, what=k)
        for k, want in ref["final"].items():
            close(out["state"][k], want, what=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_rows_rounds_a_repeated_rows_cotangent_sum_once(dtype):
    """`tp.take_rows` (the embedding lookup) looks up ``table[idx]``, and
    its backward sums each row's cotangents in f32 and rounds once: with
    Zipf-drawn ids (a few rows looked up hundreds of times), every row of
    the gradient is the f64 sum rounded to `dtype`, where bf16 indexing's
    own backward, adding them one at a time in bf16, is further off (the
    embedding gradient's 1.9% norm gap on the card, PERF.md); in f32 the
    sum is f32's own."""
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, 65) ** 1.1
    idx = torch.as_tensor(rng.choice(64, size=(4, 256), p=p / p.sum()))
    table = torch.randn((64, 16), generator=torch.Generator().manual_seed(1)
                        ).to(dtype).requires_grad_(True)
    g = torch.randn((4, 256, 16), generator=torch.Generator().manual_seed(2)
                    ).to(dtype)
    out = TP.take_rows(table, idx)
    assert torch.equal(out, table[idx])
    got, = torch.autograd.grad(out, table, g)
    want = torch.zeros((64, 16), dtype=torch.float64).index_add_(
        0, idx.reshape(-1), g.reshape(-1, 16).double())
    err = (got.double() - want.to(dtype).double()).abs().max().item()
    # f32: the sum itself in f32, some 300 unit addends a frequent row
    assert err <= (1e-5 if dtype == torch.float32 else 0.0)
    if dtype == torch.bfloat16:
        plain, = torch.autograd.grad(table[idx], table, g)
        assert (plain.double() - want).abs().max() > (
            got.double() - want).abs().max()
