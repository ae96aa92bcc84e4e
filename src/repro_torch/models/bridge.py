"""Move parameters between the JAX package's pytree and the port's module.

The JAX tree is nested dicts with ``blocks`` leaves stacked on a leading L
axis. The bridge takes it as numpy arrays (the caller converts JAX arrays,
so the port never sees JAX) and unstacks it per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import TransformerLM

_GROUPS = ("ln1", "attn", "ln2", "mlp")


def _top_level(model: TransformerLM) -> dict:
    top = {"embed": model.embed, "ln_f": model.ln_f}
    if model.head is not None:
        top["head"] = model.head
    return top


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


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> TransformerLM:
    """The JAX parameter tree (numpy leaves) as a `TransformerLM` on
    `device`, each leaf cast to ``cfg.param_dtype``."""
    model = TransformerLM(cfg, device)
    top = _top_level(model)
    _check_keys(tree, list(top) + ["blocks"], "params")
    for key, group in top.items():
        _check_keys(tree[key], group, key)
        for name, p in group.items():
            _put(p, tree[key][name], f"{key}.{name}")
    _check_keys(tree["blocks"], _GROUPS, "blocks")
    for i, blk in enumerate(model.blocks):
        for g in _GROUPS:
            group = getattr(blk, g)
            _check_keys(tree["blocks"][g], group, f"blocks.{g}")
            for name, p in group.items():
                _put(p, tree["blocks"][g][name][i], f"blocks.{g}.{name}[{i}]")
    return model


def params_to_numpy(model: TransformerLM) -> dict:
    """The inverse of `params_from_numpy`: float32 numpy leaves, ``blocks``
    stacked on a leading L axis."""

    def np32(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    tree = {key: {n: np32(p) for n, p in group.items()}
            for key, group in _top_level(model).items()}
    tree["blocks"] = {
        g: {n: np.stack([np32(getattr(blk, g)[n]) for blk in model.blocks])
            for n in getattr(model.blocks[0], g)}
        for g in _GROUPS}
    return tree
