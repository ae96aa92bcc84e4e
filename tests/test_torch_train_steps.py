"""The other families' train steps against the JAX package's, on the CPU:
three steps of `make_train_step` against ``jax.jit(make_train_step)``
(losses, metrics and whole states), microbatching, the eval step, and the
train state carried both ways through the bridge and a checkpoint.

Shared pieces (configs, batches, tolerances) are in
`tests/torch_train_families.py`. AdamW's eps is 1e-5 here, not its default
1e-8: its update g / (|g| + eps) turns the two frameworks' f32 rounding of
a gradient entry near eps (entries of 1e-7 clip to about 1e-9 at these
smoke gradients' norms of 10-40) into state differences up to lr x (the
rounding) / eps, and at 1e-8 one entry in about 1e5 of the moe, mla_moe
and hybrid states lands 1-6e-5 from JAX's after one step, past the f32
tolerance; at 1e-5 the bound is 1e-7. The gradients themselves are held
at the f32 tolerance in `tests/test_torch_train_loss.py`.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import bridge
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.models.registry import get_model
from torch_train_families import (FAMILIES, OPT, batches, cfgs, close,
                                  jax_state, port_state, to_numpy,
                                  tree_close)


@pytest.mark.parametrize("kind,microbatches", [
    *((kind, 1) for kind in FAMILIES), ("hybrid", 2)])
def test_three_train_steps_match_jax(kind, microbatches):
    """Three steps: losses and metrics each step, then whole states
    (params, master, m, v, the step and rng). With microbatches the batch
    is cut on its leading axis, every leaf of it: vlm's patches, positions
    and loss mask, encdec's source frames."""
    jcfg, cfg = cfgs(kind)
    japi, api = jget_model(jcfg), get_model(cfg)
    jstate = jax_state(jcfg)
    state = port_state(jstate, cfg)
    jfn = jax.jit(jstep.make_train_step(japi, jcfg, jadamw.AdamWConfig(**OPT),
                                        microbatches=microbatches))
    fn = tstep.make_train_step(api, cfg, adamw.AdamWConfig(**OPT),
                               microbatches=microbatches)
    for batch in batches(cfg, 3, seed=7):
        jstate, jm = jfn(jstate, batch)
        state, m = fn(state, batch)
        assert set(m) == set(jm)
        for k in jm:
            close(m[k], jm[k], what=k)
    got = bridge.train_state_to_numpy(state, cfg)
    want = to_numpy(jstate)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3
    np.testing.assert_array_equal(got["rng"], want["rng"])
    tree_close(got["params"], want["params"], where="params")
    for k in ("master", "m", "v"):
        tree_close(got["opt"][k], want["opt"][k], where=k)


@pytest.mark.parametrize("kind", FAMILIES)
def test_eval_step_matches_jax(kind):
    jcfg, cfg = cfgs(kind)
    jstate = jax_state(jcfg)
    batch = batches(cfg, 1, seed=4)[0]
    jm = jstep.make_eval_step(jget_model(jcfg), jcfg)(jstate["params"], batch)
    m = tstep.make_eval_step(get_model(cfg), cfg)(
        port_state(jstate, cfg)["params"], batch)
    assert set(m) == set(jm)
    for k in jm:
        close(m[k], jm[k], what=k)


@pytest.mark.parametrize("kind", FAMILIES)
def test_train_state_carries_over_both_ways(kind):
    """Every leaf, the SSM's f32 A_log and D, the experts, the hybrid's
    (groups, attn_every) stacks and shared block, the encoder: the JAX
    train state into the port and back, bit for bit."""
    jcfg, cfg = cfgs(kind)
    jstate = jax_state(jcfg)
    state = port_state(jstate, cfg)
    params = dict(state["params"].named_parameters())
    assert all(p.requires_grad for p in params.values())
    for k in ("master", "m", "v"):
        assert list(state["opt"][k]) == list(params)
    back = bridge.train_state_to_numpy(state, cfg)
    want = to_numpy(jstate)
    np.testing.assert_array_equal(back["rng"], want["rng"])
    tree_close(back["params"], want["params"], 0.0)
    for k in ("master", "m", "v"):
        tree_close(back["opt"][k], want["opt"][k], 0.0)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_a_bf16_family_state_checkpoints_bit_for_bit(arch, tmp_path):
    """A bf16 train state after one step (the SSM's f32 leaves, a tied
    head, the encoder) saved and restored into a fresh state: every leaf's
    bits and dtype."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    api = get_model(cfg)
    state = tstep.init_train_state(torch.Generator().manual_seed(0), api,
                                   cfg, device="cpu")
    if cfg.kind == "encdec":
        batch = batches(cfg, 1, B=2, S=16)[0]
    else:
        batch = SyntheticLMDataset(DataConfig(
            seq_len=16, global_batch=2, vocab=cfg.vocab)).batch_at(0)
    state, _ = tstep.make_train_step(api, cfg, adamw.AdamWConfig(**OPT))(
        state, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    fresh = tstep.init_train_state(torch.Generator().manual_seed(1), api,
                                   cfg, device="cpu")
    back, _ = mgr.restore(into=fresh)
    got = dict(back["params"].named_parameters())
    for n, p in state["params"].named_parameters():
        assert got[n].dtype == p.dtype and torch.equal(got[n], p), n
        for k in ("master", "m", "v"):
            assert torch.equal(back["opt"][k][n], state["opt"][k][n]), (k, n)
    if cfg.kind != "encdec":
        assert got["blocks.0.ssm.A_log"].dtype == torch.float32
    assert int(back["opt"]["step"]) == 1
