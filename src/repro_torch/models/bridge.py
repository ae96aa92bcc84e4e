"""Move parameters between the JAX package's pytree and the port's module.

The JAX tree is nested dicts with ``blocks`` leaves stacked on a leading L
axis. The bridge takes it as numpy arrays (the caller converts JAX arrays,
so the port never sees JAX) and unstacks it per layer. A block's groups may
nest (the MoE FFN's ``moe.router``, ``moe.experts``, ``moe.shared_mlp``):
a `nn.ParameterDict` is a group of leaves, a `nn.ModuleDict` a group of
groups.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM


def _top_level(model: TransformerLM) -> dict:
    top = {"embed": model.embed, "ln_f": model.ln_f}
    if model.head is not None:
        top["head"] = model.head
    return top


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
                      device: str | torch.device = "cuda") -> TransformerLM:
    """The JAX parameter tree (numpy leaves) as a `TransformerLM` on
    `device`, each leaf cast to ``cfg.param_dtype``."""
    model = TransformerLM(cfg, device)
    top = _top_level(model)
    _check_keys(tree, list(top) + ["blocks"], "params")
    for key, group in top.items():
        _load(group, tree[key], None, key)
    groups = _block_groups(model.blocks[0])
    _check_keys(tree["blocks"], groups, "blocks")
    for i, blk in enumerate(model.blocks):
        for g, group in _block_groups(blk).items():
            _load(group, tree["blocks"][g], i, f"blocks.{g}")
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


def params_to_numpy(model: TransformerLM) -> dict:
    """The inverse of `params_from_numpy`: float32 numpy leaves, ``blocks``
    stacked on a leading L axis."""
    tree = {key: {n: _np32(p) for n, p in group.items()}
            for key, group in _top_level(model).items()}
    tree["blocks"] = {
        g: _dump([_block_groups(blk)[g] for blk in model.blocks])
        for g in _block_groups(model.blocks[0])}
    return tree
