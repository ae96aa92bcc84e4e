"""Train and serve step builders: the JAX package's `repro.train.step`.

`make_train_step(model, cfg, opt_cfg)` returns a (state, batch) -> (state,
metrics) function with microbatch gradient accumulation. The state is
``{"params": module, "opt": {"step", "master", "m", "v"}, "rng"}``; where
JAX donates it and returns a new one, the port updates it in place and
returns it. Every GEMM of the forward and of the backward is a launch of
the hand-written kernel (`kernels.ops.matmul`'s autograd function).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state

State = dict[str, Any]


def init_train_state(generator: torch.Generator, model, cfg: ModelConfig, *,
                     device: str | torch.device = "cuda") -> State:
    """Random params from `generator` (on `device`), made trainable, with a
    fresh optimizer state and the JAX package's ``rng`` leaf (the key data
    of ``jax.random.key(0)``: two zero uint32 words), carried unchanged."""
    params = model.init(cfg, generator, device=device)
    for p in params.parameters():
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params),
            "rng": torch.zeros(2, dtype=torch.uint32,
                               device=next(params.parameters()).device)}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(model, params, names, batch, cfg):
    loss, metrics = model.loss(params, batch, cfg)
    leaves = [p for _, p in params.named_parameters()]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip(names, grads))


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """The train step of `model` (a `ModelApi` whose `loss` is ported).
    With `microbatches` > 1 the batch's leading axis is cut into that many
    splits whose gradients are summed in f32 and averaged, as the JAX
    package's scan does; the metrics are the last split's."""

    def train_step(state: State, batch: dict) -> tuple[State, dict]:
        params = state["params"]
        names = [n for n, _ in params.named_parameters()]
        batch = _to_device(batch, next(params.parameters()).device)
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(model, params, names,
                                                   batch, cfg)
        else:
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
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss / microbatches
        _, opt, opt_metrics = apply_updates(params, grads, state["opt"],
                                            opt_cfg)
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
