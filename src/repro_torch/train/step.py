"""Train and serve step builders: the JAX package's `repro.train.step`.

`make_train_step(model, cfg, opt_cfg)` returns a (state, batch) -> (state,
metrics) function with microbatch gradient accumulation. The state is
``{"params": module, "opt": {"step", "master", "m", "v"}, "rng"}``; where
JAX donates it and returns a new one, the port updates it in place and
returns it. Every GEMM of the forward and of the backward is a launch of
the hand-written kernel (`kernels.ops.matmul`'s autograd function).

On a ("data", "model") mesh (`launch.mesh`; one process per rank) the
step is the reference's under its mesh, written out: the config takes
explicit collectives in psum mode (`train_config`), each rank holds its
shard of the state (`init_train_state(mesh=)`), the global batch is cut
over "data" (each data rank its rows), the loss is the whole batch's
(`layers.cross_entropy`'s global mean), and each data rank's gradient
(its tokens' share of the global loss's) is summed over "data" in the
gradient's dtype before the update, which cuts the optimizer state over
"data" where ``zero1`` (ZeRO-1). Tensor parallelism trains every kind
where tp divides what the kind shards (`sharding.check_tp`, the rule the
serving engine shares); before the update, the gradient of each part a
rank holds whole in a leaf cut by parts (Mamba2's B and C) is summed
over "model" (`reduce_gradients`). With ``cfg.fsdp`` on a mesh of more
than one data rank, FSDP cuts each leaf the reference's rules put on
"data" to this rank's block (`sharding.cut_over_data`), with its
optimizer state; the block loops gather it before use
(`distributed.fsdp`) and the backward reduce-scatters its gradient, so the
step sums only the other leaves' over "data" (and FSDP's over "pod").
The batch and the gradients go over both data-parallel axes, "pod" and
"data" (`launch.mesh.dp_axes`). Under ``moe_expert_axis="data"`` the
experts are cut over "data" as their E (`sharding.expert_axes`): each
rank's expert gradients are whole over "data" after the token exchange's
backward, so they are summed over "pod" only, like FSDP's. Under
``sequence_parallel`` (where it runs: `tp.sequence_parallel` of the
batch's sequence) the gradient of each leaf "model" does not cut in the
blocks that take it is each rank's share of it (the norms, the router,
``ln_f``, a head or block tp does not divide: `sharding.sequence_partial`)
and is summed over "model" first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed import tp as TP
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state

State = dict[str, Any]


def train_config(cfg: ModelConfig, mesh=None, check: bool = True
                 ) -> ModelConfig:
    """`cfg` as a train step on `mesh` runs it: explicit collectives in
    psum mode where the "model" axis has more than one rank (raising
    ValueError, naming the quantity, where tp does not divide what the
    kind shards: `sharding.check_tp`, unless not `check`: the dry-run's
    rank then holds such leaves whole), else `cfg` as it is."""
    tp = sharding.model_size(mesh)
    if check and getattr(cfg, "moe_expert_axis", "model") == "data" and \
            mesh is not None and cfg.n_experts % mesh.data:
        raise ValueError(f"experts over 'data' need n_experts="
                         f"{cfg.n_experts} divisible by the data axis, "
                         f"{mesh.data}")
    if tp == 1:
        return cfg
    if check:
        sharding.check_tp(cfg, tp, "psum")
    return dataclasses.replace(cfg, tp_collectives="explicit",
                               tp_reduce="psum")


def init_train_state(generator: torch.Generator, model, cfg: ModelConfig, *,
                     device: str | torch.device = "cuda", mesh=None,
                     zero1: bool = False, check: bool = True) -> State:
    """Random params from `generator` (on `device`), made trainable, with a
    fresh optimizer state and the JAX package's ``rng`` leaf (the key data
    of ``jax.random.key(0)``: two zero uint32 words), carried unchanged.
    On `mesh` every rank draws the whole model from the same generator
    state and keeps its shard (`shard_state`), so the weights are tp=1's.
    `check` as in `train_config`."""
    params = model.init(cfg, generator, device=device)
    return shard_state(params, model, cfg, mesh, zero1, check)


def shard_state(params, model, cfg: ModelConfig, mesh=None,
                zero1: bool = False, check: bool = True) -> State:
    """A fresh train state of whole `params` (a module; cut in place to
    `mesh`'s rank's shards in psum mode, `sharding.shard_params`, and over
    "data" where ``cfg.fsdp``, `sharding.cut_over_data`, and its experts'
    E over "data" under ``moe_expert_axis="data"``), made trainable, its
    optimizer state cut over "data" where `zero1`."""
    layout = None
    if mesh is not None:
        cfg = train_config(cfg, mesh, check)
        whole = model.init(cfg, None, device="meta")
        sharding.shard_params(params, mesh, "psum", whole=whole, cfg=cfg)
        layout = sharding.train_layout(whole, mesh, cfg, zero1)
        sharding.cut_over_data(params, layout.fsdp, mesh)
        sharding.cut_experts_over_data(params, layout.experts, mesh)
    for p in params.parameters():
        p.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(params, layout and layout.zero1, mesh),
            "rng": torch.zeros(2, dtype=torch.uint32,
                               device=next(params.parameters()).device)}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(model, params, names, batch, cfg):
    loss, metrics = model.loss(params, batch, cfg)
    leaves = [p for _, p in params.named_parameters()]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip(names, grads))


def reduce_gradients(grads: dict, layout, mesh, sp: bool = False) -> None:
    """The step's reductions of this rank's gradients, in place, before
    the update: under sequence parallelism (`sp`: the step ran under it)
    the leaves whose gradient is each rank's share (`TrainLayout.
    sp_partial`) summed over "model" (`tp.sum_over_model`), the parts a
    rank holds whole in a leaf cut by parts summed over "model" (each
    rank's is its heads' share: `tp.sum_whole_parts`), then every leaf
    summed over the data-parallel axes, but a leaf cut over "data" (by
    FSDP, whose backward reduce-scattered it there, or an expert whose
    tokens came to it by all-to-all) only over "pod"."""
    cut = layout.data_cut() if layout is not None else set()
    if layout is not None:
        if sp:
            TP.sum_over_model(grads, layout.sp_partial, mesh)
        TP.sum_whole_parts(grads, layout.whole_parts(), mesh)
    for name, g in grads.items():
        if name in cut:
            TP.all_reduce_pod(g, mesh)
        else:
            TP.all_reduce_data(g, mesh)


def _data_rows(batch: dict, mesh) -> dict:
    """This data rank's rows of the global batch (every leaf cut on its
    leading axis over the data-parallel axes)."""
    if mesh is None or mesh.dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.dp:
            raise ValueError(f"batch leaf {k} of {v.shape[0]} rows does not "
                             f"split over {mesh.dp} data ranks")
        n = v.shape[0] // mesh.dp
        out[k] = v[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]
    return out


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, *, mesh=None,
                    zero1: bool = False, local_batch: bool = False,
                    check: bool = True) -> Callable:
    """The train step of `model` (a `ModelApi` whose `loss` is ported).
    With `microbatches` > 1 the batch's leading axis is cut into that many
    splits whose gradients are summed in f32 and averaged, as the JAX
    package's scan does; the metrics are the last split's. On `mesh` (a
    state from `init_train_state(mesh=, zero1=)`, the same `zero1`) the
    step runs as the module docstring says; the mesh is installed
    (`sharding.set_mesh`) for the step's duration. With `local_batch` the
    batch given is this data rank's rows already (the dry-run's); `check`
    as in `train_config`."""
    layout = None
    if mesh is not None:
        cfg = train_config(cfg, mesh, check)
        layout = sharding.train_layout(model.init(cfg, None, device="meta"),
                                       mesh, cfg, zero1)
    sharded = layout.sharded() if layout else {}
    data_cut = layout.data_cut() if layout else set()

    def grads_of(params, names, batch):
        if microbatches == 1:
            return _value_and_grad(model, params, names, batch, cfg)
        grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for n, p in params.named_parameters()}
        loss = 0.0
        for i in range(microbatches):
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                               *v.shape[1:])[i]
                  for k, v in batch.items()}
            l, metrics, g = _value_and_grad(model, params, names, mb, cfg)
            for n in names:
                grads[n] += g[n]
            loss = loss + l
            del g
        return (loss / microbatches, metrics,
                {n: g / microbatches for n, g in grads.items()})

    def train_step(state: State, batch: dict) -> tuple[State, dict]:
        params = state["params"]
        names = [n for n, _ in params.named_parameters()]
        batch = _to_device(batch, next(params.parameters()).device)
        prev = sharding.current_mesh()
        sharding.set_mesh(mesh)
        try:
            rows = batch if local_batch else _data_rows(batch, mesh)
            loss, metrics, grads = grads_of(params, names, rows)
            reduce_gradients(grads, layout, mesh, TP.sequence_parallel(
                cfg, rows["labels"].shape[1]))
            _, opt, opt_metrics = apply_updates(
                params, grads, state["opt"], opt_cfg, mesh=mesh,
                sharded=sharded, zero1=layout and layout.zero1,
                data_cut=data_cut)
        finally:
            sharding.set_mesh(prev)
        del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        state["opt"] = opt
        return state, metrics

    return train_step


def make_eval_step(model, cfg: ModelConfig) -> Callable:
    """(params, batch) -> the loss's metrics, no gradient."""

    @torch.no_grad()
    def eval_step(params, batch):
        batch = _to_device(batch, next(params.parameters()).device)
        _, metrics = model.loss(params, batch, cfg)
        return metrics

    return eval_step


def warm_train_gemms(cfg: ModelConfig, batch_size: int, seq_len: int, *,
                     objective: str = "runtime",
                     chip: str | None = None) -> dict:
    """Pre-tune the forward GEMM fleet of a train step over batch_size *
    seq_len rows (`config.gemm_shapes`) in one `ops.warm_gemm_cache` call,
    so `matmul` launches those shapes at their tuned tiles. Only forward
    shapes, as in the JAX package: the backward's transposed layouts take
    the kernel's general path, which has one tile. Returns {shape:
    BlockConfig} ({} if no tuner is available: `plan` then picks)."""
    from repro_torch.kernels import ops
    from repro_torch.models.config import gemm_shapes

    fleet = gemm_shapes(cfg, batch_size * seq_len)
    return ops.warm_gemm_cache(fleet, dtype=cfg.activation_dtype,
                               objective=objective, chip=chip)


def make_serve_steps(model, cfg: ModelConfig):
    """(prefill_fn, decode_fn) of `model` (a `ModelApi`)."""

    def prefill(params, batch):
        return model.prefill(params, batch, cfg)

    def decode(params, token, state):
        return model.decode_step(params, token, state, cfg)

    return prefill, decode
