"""Move parameters between the JAX package's pytree and the port's module.

The JAX tree is nested dicts with ``blocks`` leaves stacked on a leading L
axis (hybrid: on (n_groups, attn_every), beside its unstacked
``shared_attn`` block; encdec: ``encoder`` and ``decoder`` stacks beside
``enc_ln_f``; vlm: the dense tree). The bridge takes it as numpy arrays (the caller
converts JAX arrays, so the port never sees JAX) and unstacks it per layer.
A block's groups may nest (the MoE FFN's ``moe.router``, ``moe.experts``,
``moe.shared_mlp``): a `nn.ParameterDict` is a group of leaves, a
`nn.ModuleDict` a group of groups.

The bridged module is whole; under tensor parallelism each rank cuts its
shard of it (`distributed.sharding.shard_params`, which the tp serving
engine calls), so a test's path is bridge, then shard.

The train state carries over too (`train_state_from_numpy`,
`train_state_to_numpy`): the optimizer's master, m and v trees, stacked in
JAX, are dicts keyed by parameter name in the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import TransformerLM


def _module(cfg: ModelConfig, device) -> nn.Module:
    """An uninitialised module of `cfg`'s kind on `device`."""
    return {"hybrid": HybridLM, "encdec": EncDecLM}.get(
        cfg.kind, TransformerLM)(cfg, device)


def _top_level(model: nn.Module) -> dict:
    top = {"embed": model.embed, "ln_f": model.ln_f}
    if model.head is not None:
        top["head"] = model.head
    if isinstance(model, EncDecLM):
        top["enc_ln_f"] = model.enc_ln_f
    return top


def _stacks(model: nn.Module) -> dict:
    """The block lists the JAX tree stacks on a leading L axis."""
    if isinstance(model, EncDecLM):
        return {"encoder": model.encoder, "decoder": model.decoder}
    return {"blocks": model.blocks}


def _shared_blocks(model: nn.Module) -> dict:
    """Unstacked blocks at the top level: hybrid's ``shared_attn``."""
    return ({"shared_attn": model.shared_attn}
            if isinstance(model, HybridLM) else {})


def _map(fn, tree):
    """`fn` applied to every leaf of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(np.asarray(tree))


def _block_groups(blk: nn.Module) -> dict:
    """The block's top-level groups (ln1, attn, ln2, mlp or moe)."""
    return dict(blk.named_children())


def _put(dst: torch.Tensor, arr, where: str) -> None:
    src = torch.from_numpy(np.array(arr, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {tuple(src.shape)}, expected "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _check_keys(got, want, where: str) -> None:
    if set(got) != set(want):
        raise ValueError(f"{where}: keys {sorted(got)}, expected "
                         f"{sorted(want)}")


def _load(group: nn.Module, tree: dict, i: int | None, where: str) -> None:
    """Fill `group` (leaves or nested groups) from `tree`, taking layer `i`
    of each stacked leaf (the whole leaf when `i` is None)."""
    _check_keys(tree, dict(group.items()), where)
    for name, sub in group.items():
        if isinstance(sub, nn.Module):
            _load(sub, tree[name], i, f"{where}.{name}")
        else:
            leaf = tree[name] if i is None else tree[name][i]
            _put(sub, leaf, f"{where}.{name}" + ("" if i is None
                                                else f"[{i}]"))


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> nn.Module:
    """The JAX parameter tree (numpy leaves) as a `TransformerLM` (a
    `HybridLM` for kind hybrid, an `EncDecLM` for encdec) on `device`, each
    leaf cast to its parameter's dtype (``cfg.param_dtype``; the SSM's
    A_log and D stay float32)."""
    model = _module(cfg, device)
    top, shared, stacks = (_top_level(model), _shared_blocks(model),
                           _stacks(model))
    _check_keys(tree, list(top) + list(shared) + list(stacks), "params")
    for key, group in top.items():
        _load(group, tree[key], None, key)
    for key, blk in shared.items():
        _check_keys(tree[key], _block_groups(blk), key)
        for g, group in _block_groups(blk).items():
            _load(group, tree[key][g], None, f"{key}.{g}")
    for key, stack in stacks.items():
        blocks = tree[key]
        if isinstance(model, HybridLM):
            blocks = _map(lambda a: a.reshape(-1, *a.shape[2:]), blocks)
        _check_keys(blocks, _block_groups(stack[0]), key)
        for i, blk in enumerate(stack):
            for g, group in _block_groups(blk).items():
                _load(group, blocks[g], i, f"{key}.{g}")
    return model


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _dump(groups: list[nn.Module]) -> dict:
    """One group's tree, each leaf stacked over `groups` (the same group of
    every layer) on a leading axis."""
    out = {}
    for name, sub in groups[0].items():
        if isinstance(sub, nn.Module):
            out[name] = _dump([g[name] for g in groups])
        else:
            out[name] = np.stack([_np32(g[name]) for g in groups])
    return out


def params_to_numpy(model: nn.Module) -> dict:
    """The inverse of `params_from_numpy`: float32 numpy leaves, each
    stack of blocks on a leading L axis (hybrid: (n_groups,
    attn_every))."""
    tree = {key: {n: _np32(p) for n, p in group.items()}
            for key, group in _top_level(model).items()}
    for key, blk in _shared_blocks(model).items():
        tree[key] = _map(lambda a: a[0], {
            g: _dump([group]) for g, group in _block_groups(blk).items()})
    for key, stack in _stacks(model).items():
        tree[key] = {g: _dump([_block_groups(blk)[g] for blk in stack])
                     for g in _block_groups(stack[0])}
    if isinstance(model, HybridLM):
        tree["blocks"] = _map(
            lambda a: a.reshape(*model.group_shape, *a.shape[1:]),
            tree["blocks"])
    return tree


def _f32(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, param_dtype="float32")


def named_from_numpy(tree: dict, cfg: ModelConfig,
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
    """A tree of the JAX parameter tree's structure (an optimizer's master,
    m or v, or a gradient tree) as f32 tensors keyed by the port's
    parameter names."""
    model = params_from_numpy(tree, _f32(cfg), device)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def named_to_numpy(named: dict, cfg: ModelConfig) -> dict:
    """The inverse of `named_from_numpy`: f32 numpy leaves in the JAX
    tree's structure."""
    model = _module(_f32(cfg), "cpu")
    for n, p in model.named_parameters():
        p.copy_(named[n].detach().float().cpu())
    return params_to_numpy(model)


def train_state_from_numpy(tree: dict, cfg: ModelConfig,
                           device: str | torch.device = "cuda") -> dict:
    """The JAX train state ``{"params", "opt": {"step", "master", "m",
    "v"}, "rng"}`` (numpy leaves) as the port's (`train.step`): the params
    module (trainable), the optimizer trees by parameter name in f32, the
    step an int32 scalar and ``rng`` uint32 words, all on `device`."""
    params = params_from_numpy(tree["params"], cfg, device)
    for p in params.parameters():
        p.requires_grad_(True)
    dev = next(params.parameters()).device
    opt = tree["opt"]
    return {
        "params": params,
        "opt": {"step": torch.tensor(int(np.asarray(opt["step"])),
                                     dtype=torch.int32, device=dev),
                **{k: named_from_numpy(opt[k], cfg, dev)
                   for k in ("master", "m", "v")}},
        "rng": torch.from_numpy(np.asarray(tree["rng"], np.uint32)
                                .copy()).to(dev),
    }


def train_state_to_numpy(state: dict, cfg: ModelConfig) -> dict:
    """The inverse of `train_state_from_numpy`: the JAX train state's tree
    with f32 numpy leaves (the step int32, ``rng`` uint32)."""
    opt = state["opt"]
    return {
        "params": params_to_numpy(state["params"]),
        "opt": {"step": np.asarray(int(opt["step"]), np.int32),
                **{k: named_to_numpy(opt[k], cfg)
                   for k in ("master", "m", "v")}},
        "rng": state["rng"].cpu().numpy().astype(np.uint32),
    }
