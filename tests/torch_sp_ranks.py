"""Rank entry points of the sequence-parallel and experts-over-"data" CPU
tests (`test_torch_sp.py`, `test_torch_ep_data.py`).

Not a test file: the tests import it by name, and `launch.mesh.RankPool`
runs its functions in rank processes, which import this module and
`repro_torch`, never JAX. Each function takes the pool's mesh first and
ignores it for the (data, model) `shape` it names (a pool of four ranks
holds a (2, 2) or (1, 4) mesh, or two copies of a (2, 1) or (1, 2) one)
and returns picklable data: whole leaves as numpy, gathered from the
ranks' shards over "model" and "data" (`sharding.TrainLayout.gather`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tp as TP
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep
from torch_tp_train_ranks import mesh_of


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _state(mesh, cfg, tree: dict, zero1: bool = False) -> dict:
    params = params_from_numpy(tree, cfg, device="cpu")
    return tstep.shard_state(params, get_model(cfg), cfg, mesh, zero1)


def _layout(mesh, cfg, zero1: bool = False):
    tcfg = tstep.train_config(cfg, mesh)
    return sharding.train_layout(get_model(cfg).init(tcfg, None,
                                                     device="meta"),
                                 mesh, tcfg, zero1)


def loss_and_grads(_, shape, cfg, tree: dict, batch: dict) -> dict:
    """One loss and backward of the global `batch` on the mesh of
    `shape`, reduced as the train step reduces it
    (`train.step.reduce_gradients`): the loss and its metrics, every
    gradient leaf whole, whether the step ran under sequence
    parallelism, this rank's local shape of each leaf, its own gradient
    of each leaf "model" leaves whole, and the collectives it posted by
    op."""
    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree)
    tcfg = tstep.train_config(cfg, mesh)
    params = state["params"]
    names = [n for n, _ in params.named_parameters()]
    rows = tstep._data_rows({k: torch.as_tensor(v) for k, v in
                             batch.items()}, mesh)
    sharding.set_mesh(mesh)
    TP.reset_collectives()
    try:
        loss, metrics, grads = tstep._value_and_grad(
            get_model(cfg), params, names, rows, tcfg)
        sp = TP.sequence_parallel(tcfg, rows["labels"].shape[1])
        layout = _layout(mesh, cfg)
        tstep.reduce_gradients(grads, layout, mesh, sp)
        posted = {op: dict(v) for op, v in TP.collectives.by_op.items()}
        whole = layout.gather({f"params__{n}": g for n, g in grads.items()})
    finally:
        sharding.set_mesh(None)
    return {"loss": float(loss), "sp": sp, "posted": posted,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k.partition("__")[2]: _np(g)
                      for k, g in whole.items()},
            "local": {n: tuple(p.shape) for n, p in
                      params.named_parameters()},
            "data_cut": sorted(layout.data_cut()),
            "whole_leaves": {n: _np(grads[n]) for n in names
                             if layout.axes[n] is None}}


def train_steps(_, shape, cfg, tree: dict, batches: list, opt: dict,
                zero1: bool = False) -> dict:
    """`len(batches)` steps of `make_train_step` on the mesh of `shape`:
    each step's metrics and the whole final params, master, m and v."""
    from repro_torch.checkpoint.manager import _flatten

    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree, zero1)
    fn = tstep.make_train_step(get_model(cfg), cfg, AdamWConfig(**opt),
                               mesh=mesh, zero1=zero1)
    metrics = []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = _layout(mesh, cfg, zero1).gather(_flatten(state))
    return {"metrics": metrics,
            "state": {k: _np(v) for k, v in whole.items()
                      if k.startswith(("params__", "opt__"))
                      and v.dim() > 0}}


def prefill_logits(_, shape, cfg, tree: dict, tokens: np.ndarray) -> dict:
    """The psum-mode prefill's last logits of `tokens` on the mesh of
    `shape` (the dry-run rank's serving step, on real ranks), with an f32
    KV cache (a bf16 entry rounding the other way after the row-parallel
    sum moves the logits past the f32 tolerance), and whether the stack
    ran under sequence parallelism (a dense-kind `cfg`)."""
    from repro_torch.models.transformer import init_kv_cache

    mesh = mesh_of(shape)
    api = get_model(cfg)
    tcfg = tstep.train_config(cfg, mesh)
    params = params_from_numpy(tree, cfg, device="cpu")
    sharding.shard_params(params, mesh, "psum",
                          whole=api.init(tcfg, None, device="meta"),
                          cfg=tcfg)
    tok = torch.as_tensor(tokens)
    sharding.set_mesh(mesh)
    TP.reset_collectives()
    try:
        cache = init_kv_cache(tcfg, tok.shape[0], tok.shape[1],
                              torch.float32, device="cpu")
        logits, _ = api.prefill(params, {"tokens": tok, "cache": cache},
                                tcfg)
        posted = {op: dict(v) for op, v in TP.collectives.by_op.items()}
        sp = TP.sequence_parallel(tcfg, tok.shape[1])
    finally:
        sharding.set_mesh(None)
    return {"logits": _np(logits), "posted": posted, "sp": sp}
