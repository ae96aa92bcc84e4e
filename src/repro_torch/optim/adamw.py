"""AdamW with f32 master weights, the JAX package's `repro.optim.adamw`.

Params may live in bf16; the optimizer keeps f32 master copies and moments,
keyed by the parameter's name in the module (``blocks.3.attn.wq``), so they
are per layer where the JAX package stacks them on a leading L axis. Where
the JAX package returns new trees, `apply_updates` updates the moments and
the master copies in place and copies the master back into the params in
place: at full size the optimizer state is three f32 copies of the model,
and a functional update would hold a fourth. (ZeRO-1 sharding of the state,
the reference's `zero1_shardings`, comes with tensor parallelism, ROADMAP
A7.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay, in f32 on the step's device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def named_params(params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a name -> tensor mapping as is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> dict:
    """Step 0, f32 master copies (cloned, so an f32 param never aliases its
    master) and zero moments, keyed as `named_params`."""
    named = named_params(params)
    dev = next(iter(named.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": {n: p.detach().float().clone() for n, p in named.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()},
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The f32 L2 norm over every leaf."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree.values()]).sum())


@torch.no_grad()
def apply_updates(params, grads: Mapping[str, torch.Tensor], opt_state: dict,
                  cfg: AdamWConfig) -> tuple:
    """One AdamW step: the gradients (any float dtype, keyed as the
    params) clipped to ``cfg.grad_clip`` by their global norm, moments with
    bias correction, decoupled weight decay on the f32 master, the params
    cast back from the master. Moments, master and params are updated in
    place; returns (params, opt_state with ``step + 1``, metrics: grad_norm,
    lr, clip_scale)."""
    named = named_params(params)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in named.items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        master = opt_state["master"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat, vhat = m / bc1, v / bc2
        master.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * master))
        p.copy_(master)
    opt_state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return params, opt_state, metrics
