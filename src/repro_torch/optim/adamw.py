"""AdamW with f32 master weights, the JAX package's `repro.optim.adamw`.

Params may live in bf16; the optimizer keeps f32 master copies and moments,
keyed by the parameter's name in the module (``blocks.3.attn.wq``), so they
are per layer where the JAX package stacks them on a leading L axis. Where
the JAX package returns new trees, `apply_updates` updates the moments and
the master copies in place and copies the master back into the params in
place: at full size the optimizer state is three f32 copies of the model,
and a functional update would hold a fourth.

On a mesh (`launch.mesh`) each rank holds its shards' state. The global
norm sums the squares of the leaves "model" shards over the "model" group,
those FSDP cuts over "data" over the "data" group, and counts every whole
leaf once, so the clip scale is the same on every rank (a leaf cut by
parts counts the parts it holds whole once). A leaf FSDP cuts keeps its
state cut with it, so ZeRO-1 leaves it alone.
ZeRO-1 (the reference's `zero1_shardings`; `zero1` below, from
`distributed.sharding.zero1_axes`) cuts master, m and v further over
"data": each data rank updates its block of a leaf, an elementwise update
whose bits are the whole leaf's, and the updated params are all-gathered
over "data" in the param dtype.
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


def init_opt_state(params, zero1: dict | None = None, mesh=None) -> dict:
    """Step 0, f32 master copies (cloned, so an f32 param never aliases its
    master) and zero moments, keyed as `named_params`; with `zero1`
    ({name: axis or None}) each leaf's state is this data rank's block of
    it on that axis (`sharding.data_block`)."""
    from repro_torch.distributed.sharding import data_block

    named = named_params(params)
    dev = next(iter(named.values())).device
    zero1 = zero1 or {}
    master = {n: data_block(p.detach().float(), zero1.get(n), mesh).clone()
              for n, p in named.items()}
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": master,
        "m": {n: torch.zeros_like(t) for n, t in master.items()},
        "v": {n: torch.zeros_like(t) for n, t in master.items()},
    }


def global_norm(tree: Mapping[str, torch.Tensor], mesh=None,
                sharded: Mapping | None = None,
                data_cut=()) -> torch.Tensor:
    """The f32 L2 norm over every leaf; on a mesh whose "model" axis has
    more than one rank, or with leaves cut over "data", of the whole
    leaves: the squares of the leaves named in `sharded` (this rank's
    shards) summed over "model", those of the leaves in `data_cut`
    (FSDP's) over "data", every other leaf (whole, the same on every rank)
    counted once. `sharded` maps each such name to None, or to (axis,
    parts at this rank's sizes) for a leaf cut by parts that holds some
    whole (`sharding.TrainLayout.sharded`): its cut parts are summed over
    "model" and its whole parts counted once."""
    cut_d = set(data_cut) if mesh is not None and mesh.data > 1 else set()
    if mesh is None or (mesh.tp == 1 and not cut_d):
        return torch.sqrt(torch.stack(
            [x.float().square().sum() for x in tree.values()]).sum())
    from repro_torch.distributed import tp as TP
    from repro_torch.distributed.sharding import whole_spans

    spec = sharded or {}
    zero = torch.zeros((), dtype=torch.float32,
                       device=next(iter(tree.values())).device)
    # (summed over "model", counted once) x (summed over "data" or not)
    part, whole, part_d, whole_d = zero, zero, zero, zero
    for n, x in tree.items():
        sq = x.float().square()
        d = n in cut_d
        if n not in spec:
            if d:
                whole_d = whole_d + sq.sum()
            else:
                whole = whole + sq.sum()
            continue
        if spec[n] is not None:
            axis, parts = spec[n]
            for lo, size in whole_spans(parts):
                block = sq.narrow(axis, lo, size)
                if d:
                    whole_d = whole_d + block.sum()
                else:
                    whole = whole + block.sum()
                block.zero_()        # what is left is the cut parts
        if d:
            part_d = part_d + sq.sum()
        else:
            part = part + sq.sum()
    if cut_d:
        both = TP._all_reduce_(torch.stack([part_d, whole_d]),
                               mesh.data_group)
        part, whole = part + both[0], whole + both[1]
    if mesh.tp > 1:
        part = TP.all_reduce(part.reshape(1), mesh)[0]
    return torch.sqrt(part + whole)


@torch.no_grad()
def apply_updates(params, grads: Mapping[str, torch.Tensor], opt_state: dict,
                  cfg: AdamWConfig, *, mesh=None,
                  sharded: Mapping | None = None,
                  zero1: dict | None = None, data_cut=()) -> tuple:
    """One AdamW step: the gradients (any float dtype, keyed as the
    params) clipped to ``cfg.grad_clip`` by their global norm, moments with
    bias correction, decoupled weight decay on the f32 master, the params
    cast back from the master. Moments, master and params are updated in
    place; returns (params, opt_state with ``step + 1``, metrics: grad_norm,
    lr, clip_scale). On `mesh`, `sharded` names the leaves "model" shards
    and `data_cut` those FSDP cuts over "data" (`global_norm`; a leaf cut
    over "data", its state and its gradient are this rank's blocks), and
    `zero1` ({name: axis or None}) the leaves whose state is this data
    rank's block of a whole leaf: their update runs on that block of the
    gradient and the params are all-gathered over "data"."""
    named = named_params(params)
    zero1 = zero1 or {}
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, mesh, sharded, data_cut)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in named.items():
        ax = zero1.get(name) if mesh is not None and mesh.data > 1 else None
        g = grads[name]
        if ax is not None:
            n = g.shape[ax] // mesh.data
            g = g.narrow(ax, mesh.data_rank * n, n)
        g = g.float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        master = opt_state["master"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat, vhat = m / bc1, v / bc2
        master.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * master))
        if ax is None:
            p.copy_(master)
        else:
            from repro_torch.distributed import tp as TP

            p.copy_(TP._gather(master.to(p.dtype), ax, mesh,
                               group=mesh.data_group, n=mesh.data))
    opt_state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return params, opt_state, metrics
