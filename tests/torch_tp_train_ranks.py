"""Rank entry points of the tensor-parallel training CPU tests
(`test_torch_tp_train.py`, `test_torch_tp_zero1.py`,
`test_torch_elastic.py`, `test_torch_compress.py`).

Not a test file: the tests import it by name, and `launch.mesh.RankPool`
runs its functions in rank processes, which import this module and
`repro_torch`, never JAX. Each function takes the pool's mesh first (and
ignores it where it names its own (data, model) `shape`: a pool of four
ranks holds two copies of a tp=2 mesh, or one (2, 2) mesh) and returns
picklable data: whole leaves as numpy, gathered from the ranks' shards.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.distributed import sharding
from repro_torch.distributed import tp as TP
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, global_norm
from repro_torch.train import step as tstep


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def mesh_of(shape: tuple[int, int]):
    """The (data, model) mesh of `shape` over the pool's ranks."""
    data, tp = shape
    return make_host_mesh(tp, data)


def _state(mesh, cfg, tree: dict, zero1: bool = False) -> dict:
    """A fresh train state of the bridged weights `tree`, this rank's
    shard of it on `mesh`."""
    params = params_from_numpy(tree, cfg, device="cpu")
    return tstep.shard_state(params, get_model(cfg), cfg, mesh, zero1)


def _layout(mesh, cfg, zero1: bool = False):
    tcfg = tstep.train_config(cfg, mesh)
    return sharding.train_layout(get_model(cfg).init(tcfg, None,
                                                     device="meta"),
                                 mesh, tcfg, zero1)


def _grad_in_thread(loss, leaves) -> list:
    """`torch.autograd.grad` run in a thread of its own, where no mesh is
    installed, as autograd runs a CUDA backward in its device thread."""
    import threading

    out = {}

    def run():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves)
        except BaseException as exc:          # re-raised in the caller
            out["error"] = exc

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


def loss_and_grads(_, shape, cfg, tree: dict, batch: dict,
                   backward_thread: bool = False) -> dict:
    """One loss and backward of the global `batch` on the mesh of `shape`:
    the loss, its metrics, every gradient leaf whole (summed over "data",
    gathered over "model"), and this rank's own gradient of each leaf
    that "model" leaves whole (bit identity across ranks). With
    `backward_thread` the backward runs in another thread
    (`_grad_in_thread`), and the collectives it makes are counted."""
    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree)
    tcfg = tstep.train_config(cfg, mesh)
    params = state["params"]
    names = [n for n, _ in params.named_parameters()]
    rows = tstep._data_rows({k: torch.as_tensor(v) for k, v in
                             batch.items()}, mesh)
    sharding.set_mesh(mesh)
    try:
        if backward_thread:
            loss, metrics = get_model(cfg).loss(params, rows, tcfg)
            calls = TP.collectives.calls
            grads = dict(zip(names, _grad_in_thread(
                loss, list(params.parameters()))))
            calls = TP.collectives.calls - calls
            loss = loss.detach()
        else:
            loss, metrics, grads = tstep._value_and_grad(
                get_model(cfg), params, names, rows, tcfg)
            calls = None
        layout = _layout(mesh, cfg)
        tstep.reduce_gradients(grads, layout, mesh)
        whole = sharding.gather_params(grads, mesh, layout.axes, tcfg)
        norm = float(global_norm(grads, mesh, layout.sharded()))
    finally:
        sharding.set_mesh(None)
    return {"loss": float(loss), "backward_collectives": calls,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: _np(g) for n, g in whole.items()},
            "grad_norm": norm,
            "whole_leaves": {n: _np(grads[n]) for n in names
                             if layout.axes[n] is None},
            "whole_parts": {n: [_np(g.narrow(ax, lo, size)) for lo, size
                                in sharding.whole_spans(parts)]
                            for n, (ax, parts) in
                            layout.whole_parts().items()
                            for g in (grads[n],)}}


def train_steps(_, shape, cfg, tree: dict, batches: list, opt: dict,
                zero1: bool = False) -> dict:
    """`len(batches)` steps of `make_train_step` on the mesh of `shape`
    from the bridged weights `tree`: each step's metrics, and the whole
    final state (params, master, m, v by name; the step), with each rank's
    local f32 state sizes."""
    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree, zero1)
    fn = tstep.make_train_step(get_model(cfg), cfg, AdamWConfig(**opt),
                               mesh=mesh, zero1=zero1)
    metrics = []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    local = {k: {n: tuple(t.shape) for n, t in state["opt"][k].items()}
             for k in ("master", "m", "v")}
    whole = _layout(mesh, cfg, zero1).gather(_flatten(state))
    return {"metrics": metrics, "local": local,
            "params_local": {n: tuple(p.shape) for n, p in
                             state["params"].named_parameters()},
            "state": {k: _np(v) for k, v in whole.items()
                      if k != "rng"},
            "step": int(state["opt"]["step"])}


def save_state(_, shape, cfg, tree: dict, batches: list, opt: dict,
               ckpt_dir: str, step: int) -> int:
    """Train `batches` on the mesh of `shape` from the bridged `tree`,
    then save the state at `step` under `ckpt_dir` (whole leaves, written
    by rank 0). Returns the number of files rank 0's save wrote."""
    mesh = mesh_of(shape)
    state = _state(mesh, cfg, tree)
    fn = tstep.make_train_step(get_model(cfg), cfg, AdamWConfig(**opt),
                               mesh=mesh)
    for b in batches:
        state, _ = fn(state, b)
    mgr = CheckpointManager(ckpt_dir, layout=_layout(mesh, cfg))
    mgr.save(step, state, blocking=True)
    return mgr.latest_step()


def resume_loss(_, ckpt_dir: str, cfg, batch: dict, prefer_model: int
                ) -> dict:
    """`launch.elastic.resume_elastic` on the pool's whole world: the
    mesh's shape, the restored step, the loss of `batch` on the restored
    state, and the whole restored params."""
    from repro_torch.launch.elastic import resume_elastic

    mesh, state, step = resume_elastic(ckpt_dir, get_model(cfg), cfg,
                                       prefer_model=prefer_model,
                                       device="cpu")
    tcfg = tstep.train_config(cfg, mesh)
    sharding.set_mesh(mesh)
    try:
        with torch.no_grad():
            loss, _ = get_model(cfg).loss(
                state["params"], tstep._data_rows(
                    {k: torch.as_tensor(v) for k, v in batch.items()},
                    mesh), tcfg)
        whole = _layout(mesh, cfg).gather(_flatten(state))
    finally:
        sharding.set_mesh(None)
    return {"shape": mesh.shape, "step": step, "loss": float(loss),
            "state": {k: _np(v) for k, v in whole.items() if k != "rng"}}


def compressed_mean(_, xs: list, noises: list, residuals: list | None
                    ) -> dict:
    """`compressed_psum` over "data" of a (2, 1) mesh: rank r's tensor
    ``xs[r]`` with its noise and residual; returns the mean, the new
    residual and this rank's quantised tensor and scale."""
    from repro_torch.distributed.compress import _quantize, compressed_psum

    mesh = mesh_of((len(xs), 1))
    r = mesh.data_rank
    x = torch.as_tensor(xs[r])
    res = None if residuals is None else torch.as_tensor(residuals[r])
    noise = torch.as_tensor(noises[r])
    mean, new_res = compressed_psum(x, mesh, "data", res, noise=noise)
    q, scale = _quantize(x if res is None else x + res, noise=noise)
    return {"mean": mean.numpy(), "residual": new_res.numpy(),
            "q": q.numpy(), "scale": float(scale)}


def moe_shard_map(_, shape, cfg, arrays: dict) -> dict:
    """`moe.moe_ffn` under ``moe_impl="shard_map"`` on the mesh of
    `shape` (a (1, 1) mesh: the dense path) for the global input
    ``arrays["x"]`` (B, S, d), the router ``arrays["router"]`` and the
    experts (E-sharded here): the whole output (gathered over "data"), the
    aux loss, and the gradients of ``sum(out * cot) + aux`` for the input
    (whole) and the weights (summed over "data", the experts gathered over
    "model")."""
    import dataclasses

    from repro_torch.models import moe

    mesh = mesh_of(shape)
    tcfg = dataclasses.replace(tstep.train_config(cfg, mesh),
                               moe_impl="shard_map")
    rows = tstep._data_rows({k: torch.as_tensor(arrays[k])
                             for k in ("x", "cot")}, mesh)
    x = rows["x"].clone().requires_grad_(True)
    e_loc = cfg.n_experts // mesh.tp
    experts = {k: torch.as_tensor(arrays[k]).narrow(
        0, mesh.rank * e_loc, e_loc).clone().requires_grad_(True)
        for k in ("w_gate", "w_up", "w_down")}
    router = torch.as_tensor(arrays["router"]).clone().requires_grad_(True)
    p = {"router": {"w": router}, "experts": experts}
    sharding.set_mesh(mesh if mesh.tp * mesh.data > 1 else None)
    try:
        out, aux = moe.moe_ffn(p, x, tcfg)
        loss = (out * rows["cot"]).sum() + aux
        leaves = [x, router, *experts.values()]
        gx, gr, *ge = torch.autograd.grad(loss, leaves)
        for g in (gr, *ge):
            TP.all_reduce_data(g, mesh)
        if mesh.tp > 1:
            ge = [TP._gather(g, 0, mesh) for g in ge]
        if mesh.data > 1:
            out, gx = (TP._gather(t.detach(), 0, mesh, mesh.data_group,
                                  mesh.data) for t in (out, gx))
    finally:
        sharding.set_mesh(None)
    return {"out": _np(out), "aux": float(aux), "gx": _np(gx),
            "router": _np(gr),
            **{k: _np(g) for k, g in zip(("w_gate", "w_up", "w_down"), ge)}}


def block_grads(mesh, arrays: dict, device: str = "cpu") -> dict:
    """A column-parallel product, GELU and a row-parallel product (the
    dense FFN in psum mode) on this rank's shards of ``arrays`` ("x" (M,
    d), "w_up" (d, f), "w_down" (f, d), "cot" (M, d); bf16 on `device`):
    ``sum(y * cot)``'s gradients of x (whole) and of both weights
    (gathered over "model"), as f32 numpy, and this rank's launches per
    GEMM path. On one rank (no mesh) the same through the plain
    products."""
    import torch.nn.functional as F

    from repro_torch.kernels.tiled_matmul import tiled_matmul

    def put(name):
        return torch.as_tensor(arrays[name]).to(device, torch.bfloat16)

    tp, r = mesh.tp, mesh.rank
    f = arrays["w_up"].shape[1]
    x = put("x").requires_grad_(True)
    up = put("w_up")[:, r * f // tp:(r + 1) * f // tp].contiguous()
    down = put("w_down")[r * f // tp:(r + 1) * f // tp].contiguous()
    up.requires_grad_(True)
    down.requires_grad_(True)
    before = dict(tiled_matmul.launches_by_path)
    sharding.set_mesh(mesh if tp > 1 else None)
    try:
        xe = TP.copy_to_model(x) if tp > 1 else x
        h = TP.column_parallel(xe, up, f)
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
        y = TP.row_parallel(h, down) if tp > 1 else ops.matmul(h, down)
        loss = (y.float() * put("cot").float()).sum()
        gx, gu, gd = torch.autograd.grad(loss, [x, up, down])
        if tp > 1:
            gu, gd = TP._gather(gu, 1, mesh), TP._gather(gd, 0, mesh)
    finally:
        sharding.set_mesh(None)
    launches = {p: tiled_matmul.launches_by_path[p] - n
                for p, n in before.items()}
    return {"y": _np(y.cpu()), "gx": _np(gx.cpu()), "w_up": _np(gu.cpu()),
            "w_down": _np(gd.cpu()), "launches": launches}
