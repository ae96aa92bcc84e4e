"""FSDP: the leaves cut over "data" gathered whole before use, a block at
a time.

The reference's FSDP (``cfg.fsdp``) puts a parameter's non-"model" axis on
"data" as well (`distributed.sharding.fsdp_axes`) and lets GSPMD
all-gather it where it is used. The port's rank holds that block of the
leaf (`sharding.cut_over_data`, which marks the parameter with its axis)
and the block loops gather it explicitly: `gathered` gives a block's
parameters as the block functions read them (``blk.attn["wq"]``), each
leaf cut over "data" all-gathered over "data" (`tp.gather_from_data`,
whose backward reduce-scatters the gradient to this rank's block), and
`leaf` does so for one parameter (the embedding, the head). Every family's
block loop calls `gathered` inside the function `remat` recomputes, so the
backward's recomputation gathers again and no gathered leaf outlives its
block.
"""

from __future__ import annotations

import types

from torch import nn

from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import current_mesh, fsdp_leaf_axis


def leaf(p, mesh=None):
    """The whole of the parameter `p` along its "data" axis: gathered
    where FSDP cut it, `p` itself otherwise."""
    ax = fsdp_leaf_axis(p)
    if ax is None:
        return p
    return TP.gather_from_data(p, ax, mesh or current_mesh())


def _view(m: nn.Module):
    if isinstance(m, nn.ParameterDict):
        return {k: leaf(p) for k, p in m.items()}
    if isinstance(m, nn.ModuleDict):
        return {k: _view(c) for k, c in m.items()}
    return types.SimpleNamespace(
        **{k: _view(c) for k, c in m.named_children()},
        **{k: leaf(p) for k, p in m.named_parameters(recurse=False)})


def gathered(module: nn.Module):
    """`module` (a block, or a part of one) with each of its leaves cut
    over "data" gathered whole, as a tree of namespaces and dicts the
    block functions read as they read the module; `module` itself where
    FSDP cut none (``fsdp_cut``, set by `sharding.cut_over_data`)."""
    if not getattr(module, "fsdp_cut", False):
        return module
    return _view(module)
