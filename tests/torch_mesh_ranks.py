"""Rank entry points of the mesh dry-run's and FSDP's CPU tests
(`test_torch_dryrun_mesh.py`, `test_torch_fsdp.py`).

Not a test file: the tests import it by name, and `launch.mesh.RankPool`
runs its functions in rank processes, which import this module and
`repro_torch`, never JAX. Each function takes the pool's mesh first and
builds the (data, model) mesh its `shape` names (`torch_tp_train_ranks.
mesh_of`), returning picklable data.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.configs import get_config, input_specs
from repro_torch.distributed import sharding
from repro_torch.distributed import tp as TP
from repro_torch.launch import dryrun
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, global_norm
from repro_torch.train import step as tstep
from torch_tp_train_ranks import _layout, _np, _state, mesh_of


def real_inputs(specs: dict, cfg, seed: int = 0) -> dict:
    """CPU tensors for a tree of `configs.common.Spec`: token ids below
    the vocab, each decode position and source length half the cache, M-RoPE
    positions below the sequence, zero caches and offsets, unit loss
    masks, normal floats elsewhere."""
    g = torch.Generator().manual_seed(seed)

    def make(name, sp):
        if isinstance(sp, dict):
            return {k: make(k, v) for k, v in sp.items()}
        if name in ("tokens", "labels", "token"):
            return torch.randint(0, cfg.vocab, sp.shape, generator=g,
                                 dtype=sp.dtype)
        if name in ("index", "src_len"):
            return torch.full(sp.shape, 32, dtype=sp.dtype)
        if name == "positions_3d":
            return torch.randint(0, 32, sp.shape, generator=g,
                                 dtype=sp.dtype)
        if name == "loss_mask":
            return torch.ones(sp.shape, dtype=sp.dtype)
        if not sp.dtype.is_floating_point or name in ("pos_off",):
            return torch.zeros(sp.shape, dtype=sp.dtype)
        if name in ("patch_embeds", "src_embeds"):
            return torch.randn(sp.shape, generator=g).to(sp.dtype)
        return torch.zeros(sp.shape, dtype=sp.dtype)

    return {k: make(k, v) for k, v in specs.items()}


def smoke_cfg(arch: str, changes: dict):
    return dataclasses.replace(get_config(arch, smoke=True), **changes)


def posted(_, shape, arch: str, cell: str, changes: dict) -> dict:
    """One call of the dry-run's smoke cell `cell` of `arch` (with the
    config `changes`) for real on the mesh of `shape`: this rank's
    parameters cut from seeded weights, its rows of seeded inputs, the
    collective counters set to 0 just before the step and read just
    after. Returns {op: {"calls", "bytes"}}."""
    mesh = mesh_of(shape)
    cfg = smoke_cfg(arch, changes)
    specs = input_specs(arch, cell, smoke=True)
    local, _ = dryrun.local_specs(cell, mesh, specs, cfg)
    fn, args, _ = dryrun.build_cell(
        arch, cell, mesh, cfg=cfg, specs=specs, device="cpu",
        generator=torch.Generator().manual_seed(0),
        inputs=real_inputs(local, cfg))
    TP.reset_collectives()
    fn(*args)
    return {k: dict(v) for k, v in TP.collectives.by_op.items()}


def logits_and_loss(_, shape, arch: str, changes: dict, batch: dict
                    ) -> dict:
    """The dry-run rank's prefill logits (its step, `dryrun.build_cell`,
    from seeded weights) of `batch`'s tokens and the training loss of
    `batch` on the same shards, on the mesh of `shape` (no `check_tp`:
    heads tp does not divide stay whole on every rank)."""
    mesh = mesh_of(shape)
    cfg = smoke_cfg(arch, changes)
    rows = tstep._data_rows({k: torch.as_tensor(v) for k, v in
                             batch.items()}, mesh)
    specs = {"tokens": input_specs(arch, "prefill_32k", smoke=True)["tokens"]}
    fn, (params, _), _ = dryrun.build_cell(
        arch, "prefill_32k", mesh, cfg=cfg, specs=specs, device="cpu",
        generator=torch.Generator().manual_seed(0),
        inputs={"tokens": rows["tokens"]})
    logits = fn(params, {"tokens": rows["tokens"]})
    rcfg = tstep.train_config(cfg, mesh, check=False)
    sharding.set_mesh(mesh)
    try:
        with torch.no_grad():
            loss, _ = get_model(cfg).loss(params, rows, rcfg)
    finally:
        sharding.set_mesh(None)
    return {"logits": _np(logits), "loss": float(loss),
            "whole": {n: tuple(p.shape) for n, p in params.named_parameters()
                      if n.endswith("attn.wq")}}


def fsdp_loss_and_grads(_, shape, cfg, tree: dict, batch: dict) -> dict:
    """One loss and backward of the global `batch` on the mesh of `shape`
    under FSDP: the loss, every gradient leaf whole (each rank's block
    gathered over "data" and "model"), the global norm, and the local
    shapes of the parameters."""
    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree)
    tcfg = tstep.train_config(cfg, mesh)
    params = state["params"]
    names = [n for n, _ in params.named_parameters()]
    rows = tstep._data_rows({k: torch.as_tensor(v) for k, v in
                             batch.items()}, mesh)
    layout = _layout(mesh, cfg)
    sharding.set_mesh(mesh)
    try:
        loss, metrics, grads = tstep._value_and_grad(
            get_model(cfg), params, names, rows, tcfg)
        tstep.reduce_gradients(grads, layout, mesh)
        norm = float(global_norm(grads, mesh, layout.sharded(),
                                 layout.data_cut()))
        whole = layout.gather({f"params__{n}": g for n, g in grads.items()})
    finally:
        sharding.set_mesh(None)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k.split("__", 1)[1]: _np(v) for k, v in whole.items()},
            "grad_norm": norm,
            "local": {n: tuple(p.shape) for n, p in params.named_parameters()},
            "cut": sorted(layout.data_cut())}


def fsdp_save_then_resume(_, shape, cfg, tree: dict, batches: list,
                          opt: dict, ckpt_dir: str) -> dict:
    """Train all but the last of `batches` on the mesh of `shape` under
    FSDP and save (whole leaves), then restore the checkpoint on a (1, 1)
    mesh and take the last step there: that step's metrics and the whole
    state after it."""
    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree)
    fn = tstep.make_train_step(get_model(cfg), cfg, AdamWConfig(**opt),
                               mesh=mesh)
    for b in batches[:-1]:
        state, _ = fn(state, b)
    CheckpointManager(ckpt_dir, layout=_layout(mesh, cfg)).save(
        len(batches) - 1, state, blocking=True)
    one = mesh_of((1, 1))
    fresh = _state(one, cfg, tree)
    mgr = CheckpointManager(ckpt_dir, layout=_layout(one, cfg))
    fresh, _ = mgr.restore(mgr.latest_step(), into=fresh)
    fn1 = tstep.make_train_step(get_model(cfg), cfg, AdamWConfig(**opt),
                                mesh=one)
    fresh, m = fn1(fresh, batches[-1])
    whole = _layout(one, cfg).gather(_flatten(fresh))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {k: _np(v) for k, v in whole.items() if k != "rng"},
            "step": int(fresh["opt"]["step"])}



def reduce_scatter_block(_, seed: int) -> dict:
    """`tp._reduce_scatter_` over the "data" group of a (4, 1) mesh: this
    rank's block, its whole input and what was counted."""
    mesh = mesh_of((4, 1))
    g = torch.Generator().manual_seed(seed + mesh.data_rank)
    x = torch.randn((6, 8, 3), generator=g)
    TP.reset_collectives()
    block = TP._reduce_scatter_(x.clone(), 1, mesh.data_group, mesh.data)
    return {"block": block.numpy(), "whole": x.numpy(),
            "by_op": {k: dict(v) for k, v in TP.collectives.by_op.items()}}
