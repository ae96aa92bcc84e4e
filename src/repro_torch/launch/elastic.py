"""Elastic re-meshing: resume a run on another number of ranks, the JAX
package's `repro.launch.elastic`.

When ranks die, the scheduler restarts the job with whatever survives;
this module picks the best (data, model) factorisation of the new world
(`best_mesh_for`) and restores the latest checkpoint onto it
(`resume_elastic`). A checkpoint under a mesh holds whole leaves
(`checkpoint.manager.CheckpointManager(layout=)`), so any rank of any
mesh cuts its own shard of them.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh, make_host_mesh


def world_size() -> int:
    """The ranks of the initialised default group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def best_mesh_for(n_devices: int | None = None, *,
                  prefer_model: int = 16) -> Mesh:
    """The (data, model) mesh of `n_devices` ranks (default: the process
    group's world, which it must equal): the largest model-parallel
    degree <= `prefer_model` that divides the world, the rest on "data".
    Every rank calls it (`launch.mesh.make_host_mesh`)."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}")
    model = next(m for m in range(min(prefer_model, n), 0, -1) if n % m == 0)
    return make_host_mesh(model, n // model)


def resume_elastic(ckpt_dir: str, model, cfg, *, prefer_model: int = 16,
                   device: str | torch.device = "cuda",
                   zero1: bool = False) -> tuple:
    """(mesh, state, step): the latest checkpoint under `ckpt_dir`
    restored onto the current world's `best_mesh_for` mesh, this rank's
    shard of every leaf on `device` (its optimizer state cut over "data"
    where `zero1`); (mesh, None, 0) where there is none. Every rank calls
    it."""
    from repro_torch.train.step import shard_state, train_config

    mesh = best_mesh_for(prefer_model=prefer_model)
    tcfg = train_config(cfg, mesh)
    layout = sharding.train_layout(model.init(tcfg, None, device="meta"),
                                   mesh, tcfg, zero1)
    mgr = CheckpointManager(ckpt_dir, layout=layout)
    step = mgr.latest_step()
    if step is None:
        return mesh, None, 0
    params = model.init(cfg, None, device="meta").to_empty(
        device=resolve_device(device))
    state = shard_state(params, model, cfg, mesh, zero1)
    state, _ = mgr.restore(step, into=state)
    return mesh, state, step
