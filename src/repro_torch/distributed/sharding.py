"""Which axis of each parameter and decode-state leaf a tensor-parallel
rank holds a shard of, and the cutting of a rank's local copy.

The counterpart of the JAX package's `repro.distributed.sharding` for the
port's SPMD idiom: one process per rank, each holding only its own shard,
with explicit collectives (`distributed.tp`). The rules are the
reference's, copied whole: `PARAM_RULES` maps a leaf's path to logical
names for its trailing axes, `GATHER_PARAM_RULES` flips the row-parallel
weights to column sharding in gather mode (the serving engine's), and
`SERVING_STATE_AXES` names the head axis of each decode-state leaf. On a
serving mesh, (1, tp) over ("data", "model"), only "model" (and "expert",
which rides it) shards anything; an axis that tp does not divide stays
whole (`sanitize_spec`), as the reference's jit shardings demand.

Where the reference returns `PartitionSpec`s for GSPMD to place, the port
needs the one sharded axis per leaf (`param_axes`, `state_axis`) and cuts
each rank's contiguous local copy (`shard_params`): a shard never reaches
the GEMM as a strided view of the whole.

The reference is global: GSPMD may cut a concatenated leaf in one
contiguous block and still computes the whole function. The port is
local, and there such a block is the wrong function: Mamba1's `in_proj`
is ``[x | z]`` and Mamba2's ``[z | x B C | dt]`` with B and C shared by
every head. So a leaf's sharded axis is cut by its parts (`axis_parts`,
from the config): a rank holds its block of each sharded part and the
whole of each shared one, side by side. Decode state follows the same
parts, on the axis that carries heads or channels, never the batch
(`state_axis`).

Training (psum mode) takes `PARAM_RULES` as they are: ``wo`` and
``w_down`` row-sharded. A rank holds whole heads: a head-carrying
attention leaf is cut only where tp divides its heads (`HEAD_LEAVES`;
GQA's ``wk``/``wv`` stay whole where tp does not divide the KV heads, and
each rank then uses its query heads' KV heads). `gather_params` is the
inverse of the cut (whole leaves from the ranks' shards: the checkpoint,
elastic resume and the tests need it), `zero1_axes` the reference's
`zero1_shardings` (the optimizer's f32 state cut further over "data", on
another axis than the one cut by parts, so never across a part), and
`TrainLayout` both for a flat training state (`whole_parts`: the parts a
rank holds whole, whose gradients the train step sums over "model").
What a rank holds whole blocks of, by kind, is one rule for serving and
training (`tp_divides`, `check_tp`).

On a (data, model) or (pod, data, model) mesh (the dry-run's, and FSDP's
on real ranks) the reference's `_logical_to_mesh` is copied whole
(`logical_to_mesh`): `mesh_spec` is its sanitised `PartitionSpec` of a
leaf, each axis checked against its own size, `reference_shape` the local
shape it gives. The port's rank takes its "model" axis from `leaf_axis`
(whole heads) and its "data" axis from the same rules (`fsdp_axes`: a
leaf FSDP cuts over "data", which `distributed.fsdp` gathers before
use). Under ``moe_expert_axis="data"`` (psum mode) the experts follow the
reference's ``expert`` and ``tp_if_ep_data`` names: E over "data"
(`expert_axes`; the tokens come to them by an all-to-all, never the
weights) and d_ff over "model" (`leaf_axis`), and FSDP's
``fsdp_or_tp`` leaves them alone. Under sequence parallelism the
gradient of every leaf "model" does not cut, in the blocks that take it,
is each rank's share (`sequence_partial`), summed over "model" by the
train step.

`set_mesh`/`current_mesh` hold the mesh on the thread, as the reference's
`set_mesh_rules`/`current_mesh` do: the serving engine installs its own
before every call (`ServingEngine._activate`), and the model code reads
it where a cache is allocated (`local_state_shape`) or a projection is
sharded (`distributed.tp`).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import threading

import torch

_STATE = threading.local()


def set_mesh(mesh) -> None:
    """Install `mesh` (a `launch.mesh.Mesh`, or None for one chip) as the
    thread's current mesh."""
    _STATE.mesh = mesh


def current_mesh():
    """The thread's current mesh, or None."""
    return getattr(_STATE, "mesh", None)


def model_size(mesh=None) -> int:
    """The size of the "model" axis of `mesh` (default: the current mesh);
    1 without one."""
    mesh = mesh if mesh is not None else current_mesh()
    return 1 if mesh is None else int(mesh.shape["model"])


# ---------------------------------------------------------------------------
# Parameter partitioning: path-pattern -> logical axes for the *trailing*
# dims. First match wins. (The reference's tables, whole.)
# ---------------------------------------------------------------------------

PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # embeddings / heads
    ("*embed/table", ("model", "fsdp")),          # (vocab, d)
    ("*head/w", ("fsdp", "model")),               # (d, vocab)
    # attention (incl. stacked (L, ...) leaves — trailing dims matched)
    ("*attn/wq", ("fsdp", "model")),
    ("*attn/wk", ("fsdp", "model")),
    ("*attn/wv", ("fsdp", "model")),
    ("*attn/wo", ("model", "fsdp")),
    ("*attn/b?", ("model",)),
    # MLA projections
    ("*attn/w_dkv", ("fsdp", None)),              # (d, kv_lora)
    ("*attn/w_kpe", ("fsdp", None)),
    ("*attn/w_uk", (None, "model")),              # (kv_lora, H*hd)
    ("*attn/w_uv", (None, "model")),
    ("*attn/w_dq", ("fsdp", None)),
    ("*attn/w_uq", (None, "model")),
    # dense MLP
    ("*mlp/w_gate", ("fsdp", "model")),
    ("*mlp/w_up", ("fsdp", "model")),
    ("*mlp/w_down", ("model", "fsdp")),
    # MoE experts: expert axis -> EP mesh axis; remaining dims -> TP/fsdp
    ("*experts/w_gate", ("expert", "fsdp_or_tp", "tp_if_ep_data")),
    ("*experts/w_up", ("expert", "fsdp_or_tp", "tp_if_ep_data")),
    ("*experts/w_down", ("expert", "tp_if_ep_data", "fsdp_or_tp")),
    ("*router/w", ("fsdp", None)),                 # (d, E)
    ("*shared_mlp/w_gate", ("fsdp", "model")),
    ("*shared_mlp/w_up", ("fsdp", "model")),
    ("*shared_mlp/w_down", ("model", "fsdp")),
    # SSM (mamba1/mamba2)
    ("*ssm/in_proj", ("fsdp", "model")),           # (d, 2*di) / (d, proj)
    ("*ssm/conv_w", ("model", None)),              # (channels, d_conv)
    ("*ssm/conv_b", ("model",)),
    ("*ssm/x_proj", ("model", None)),              # (di, dt_rank + 2*ds)
    ("*ssm/dt_proj", (None, "model")),             # (dt_rank, di)
    ("*ssm/dt_bias", ("model",)),
    ("*ssm/A_log", ("model", None)),               # (di, ds) or (H,)
    ("*ssm/D", ("model",)),
    ("*ssm/out_proj", ("model", "fsdp")),          # (di, d)
    ("*ssm/norm_scale", ("model",)),
    # norms and everything else: replicated
    ("*scale", (None,)),
    ("*", ()),
]

# Gather-mode TP (the serving engine's bit-stable mode, cfg.tp_reduce ==
# "gather"): row-parallel weights flip to COLUMN sharding (the full
# contraction stays on one rank — see distributed.tp.row_parallel_gather)
# and no weight leaves a contracting dim sharded. Checked before
# PARAM_RULES; first match wins.
GATHER_PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    ("*attn/wo", (None, "model")),
    ("*mlp/w_down", (None, "model")),
    ("*shared_mlp/w_down", (None, "model")),
    ("*ssm/out_proj", (None, "model")),
    ("*ssm/x_proj", (None, None)),   # tiny; contracts the sharded di
    # (the port's) Mamba2's gated RMSNorm takes its mean over the whole
    # d_inner, so its input is gathered first and its scale stays whole
    ("*ssm/norm_scale", (None,)),
]


def _match(path: str, tp_reduce: str = "psum") -> tuple[str | None, ...]:
    """The logical names of the trailing axes of the leaf at `path`
    ("/"-separated)."""
    if tp_reduce == "gather":
        for pat, spec in GATHER_PARAM_RULES:
            if fnmatch.fnmatch(path, pat):
                return spec
    for pat, spec in PARAM_RULES:
        if fnmatch.fnmatch(path, pat):
            return spec
    return ()


def axis_size(mesh_shape: dict, ax) -> int:
    """The ranks of mesh axis `ax` (a name, a tuple of names or None) of a
    mesh of `mesh_shape` ({axis name: size})."""
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= mesh_shape[a]
        return n
    return mesh_shape[ax]


def logical_to_mesh(name: str | None, axis_names: tuple, fsdp: bool = False,
                    expert_axis: str = "model"):
    """The mesh axis (or axes) the logical `name` lands on: the
    reference's `_logical_to_mesh`, its thread state (`fsdp`,
    `expert_axis`) passed in."""
    if name is None:
        return None
    if name == "batch":
        ax = tuple(a for a in ("pod", "data") if a in axis_names)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    if name == "model":
        return "model" if "model" in axis_names else None
    if name == "fsdp":
        if fsdp and "data" in axis_names:
            return "data"
        return None
    if name == "seq_shard":
        return "data" if "data" in axis_names else None
    if name == "seq_tp":
        return "model" if "model" in axis_names else None
    if name == "expert":
        return expert_axis if expert_axis in axis_names else None
    if name == "fsdp_or_tp":
        if expert_axis == "model":
            return logical_to_mesh("fsdp", axis_names, fsdp, expert_axis)
        return None
    if name == "tp_if_ep_data":
        if expert_axis == "data":
            return "model" if "model" in axis_names else None
        return None
    return None


def sanitize_mesh_spec(spec: tuple, shape: tuple[int, ...],
                       mesh_shape: dict) -> tuple:
    """Drop each mesh axis whose size does not divide its dim (the
    reference's `sanitize_spec`)."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(ax if (ax is not None
                        and dim % axis_size(mesh_shape, ax) == 0) else None
                 for ax, dim in zip(axes, shape))


def mesh_spec(path: str, shape: tuple[int, ...], mesh_shape: dict,
              fsdp: bool = False, expert_axis: str = "model",
              tp_reduce: str = "psum") -> tuple:
    """The reference's sanitised partition spec of the parameter at `path`
    of `shape` on a mesh of `mesh_shape` (`param_pspecs`' leaf spec)."""
    logical = _match(path, tp_reduce)[:len(shape)]
    names = (None,) * (len(shape) - len(logical)) + tuple(logical)
    spec = tuple(logical_to_mesh(n, tuple(mesh_shape), fsdp, expert_axis)
                 for n in names)
    return sanitize_mesh_spec(spec, shape, mesh_shape)


def spec_shape(spec: tuple, shape: tuple[int, ...],
               mesh_shape: dict) -> tuple[int, ...]:
    """The local shape a partition spec gives a leaf of `shape`
    (``NamedSharding.shard_shape``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // axis_size(mesh_shape, ax) for ax, n in zip(spec, shape))


def reference_shape(path: str, shape: tuple[int, ...], mesh_shape: dict,
                    fsdp: bool = False, expert_axis: str = "model"
                    ) -> tuple[int, ...]:
    """The local shape the reference's rules give the parameter at
    `path` on a mesh of `mesh_shape` (psum mode)."""
    return spec_shape(mesh_spec(path, shape, mesh_shape, fsdp, expert_axis),
                      shape, mesh_shape)


def _data_axis(path: str, shape: tuple[int, ...], mesh_shape: dict,
               fsdp: bool, expert_axis: str, names: tuple) -> int | None:
    """The axis of the parameter at `path` whose logical name (one of
    `names`) the reference's rules put on "data", sanitised, or None."""
    if mesh_shape.get("data", 1) <= 1:
        return None
    logical = _match(path)[:len(shape)]
    logical = (None,) * (len(shape) - len(logical)) + tuple(logical)
    spec = mesh_spec(path, shape, mesh_shape, fsdp, expert_axis)
    return next((i for i, (n, ax) in enumerate(zip(logical, spec))
                 if ax == "data" and n in names), None)


def fsdp_axis(path: str, shape: tuple[int, ...], mesh_shape: dict,
              fsdp: bool, expert_axis: str = "model") -> int | None:
    """The axis of the parameter at `path` that FSDP cuts over "data" on a
    mesh of `mesh_shape`, or None: the dim the reference's rules put on
    "data" under its "fsdp" and "fsdp_or_tp" names (the experts' E under
    ``expert_axis="data"`` is `expert_axes`' cut, not FSDP's)."""
    if not fsdp:
        return None
    return _data_axis(path, shape, mesh_shape, True, expert_axis,
                      ("fsdp", "fsdp_or_tp"))


def _expert_axis(cfg) -> str:
    return getattr(cfg, "moe_expert_axis", "model")


def fsdp_axes(model: torch.nn.Module, mesh, cfg=None) -> dict:
    """{parameter name: its axis cut over "data", or None} of an
    unsharded `model` on `mesh` where ``cfg.fsdp`` (all None
    otherwise)."""
    on = bool(getattr(cfg, "fsdp", False)) and mesh is not None
    shape = mesh.shape if on else {}
    return {name: (fsdp_axis(param_path(name), tuple(p.shape), shape, True,
                             _expert_axis(cfg)) if on else None)
            for name, p in model.named_parameters()}


def expert_axes(model: torch.nn.Module, mesh, cfg=None) -> dict:
    """{parameter name: its axis cut over "data" as the experts' E, or
    None} of an unsharded `model` on `mesh` under
    ``cfg.moe_expert_axis="data"`` (the reference's "expert" name; all
    None otherwise, or where "data" does not divide E)."""
    on = (_expert_axis(cfg) == "data" and mesh is not None
          and getattr(cfg, "tp_reduce", "psum") != "gather")
    shape = mesh.shape if on else {}
    return {name: (_data_axis(param_path(name), tuple(p.shape), shape,
                              bool(getattr(cfg, "fsdp", False)), "data",
                              ("expert",)) if on else None)
            for name, p in model.named_parameters()}


# the kinds whose every block takes sequence parallelism (the hybrid:
# only its shared block, `SP_SHARED`; the others ignore the flag)
SP_STACK_KINDS = ("dense", "moe", "mla_moe", "vlm")
SP_SHARED = "shared_attn."


def sequence_partial(axes: dict, cfg=None) -> set:
    """The names of the leaves whose gradient is each "model" rank's
    share under sequence parallelism (`axes`: the "model" axis of each,
    `param_axes`): every leaf "model" does not cut, of a kind in
    `SP_STACK_KINDS`, or of the hybrid's shared block (the blocks that
    run on this rank's block of the sequence, `distributed.tp`)."""
    if not getattr(cfg, "sequence_parallel", False):
        return set()
    kind = getattr(cfg, "kind", None)
    return {n for n, ax in axes.items() if ax is None and (
        kind in SP_STACK_KINDS
        or (kind == "hybrid" and n.startswith(SP_SHARED)))}


# the logical names a (1, tp) serving mesh puts on "model": the reference's
# `_logical_to_mesh` as `param_pspecs` calls it (no fsdp, experts on the
# "model" axis); every other name is replicated. With the experts on
# "data" (psum mode) their d_ff is "model"'s instead
MODEL_AXIS_NAMES = ("model", "expert")
EP_DATA_MODEL_AXIS_NAMES = ("model", "tp_if_ep_data")


def sanitize_spec(spec: tuple, shape: tuple[int, ...], tp: int) -> tuple:
    """Drop the "model" axis where tp does not divide its dim (the
    reference's rule: jit in_shardings demand exact divisibility)."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(ax if (ax is not None and dim % tp == 0) else None
                 for ax, dim in zip(axes, shape))


# a part of a sharded axis: (its size, whether a rank holds a block of it
# (True) or the whole of it (False))
Parts = tuple[tuple[int, bool], ...]


def axis_parts(leaf: str, n: int, cfg=None) -> Parts:
    """The parts, in order, of the sharded axis (of size `n`) of the
    parameter or decode-state leaf whose basename is `leaf`: one sharded
    block unless `cfg` makes the axis a concatenation. Mamba1's `in_proj`
    columns are ``[x | z]``, each cut by channel; Mamba2's (and the
    hybrid's) ``[z | x | B C | dt]``, z and x cut by SSD head, B and C
    (shared by every head: `ssm_ngroups` groups) whole, dt by head; the
    Mamba2 conv (`conv_w`, `conv_b` and the conv history ``conv``) runs
    over ``[x | B C]``. A `cfg` whose widths do not add up to `n` leaves
    the axis one block."""
    one = ((n, True),)
    parts = _config_parts(leaf, cfg)
    return parts if parts and sum(size for size, _ in parts) == n else one


def _config_parts(leaf: str, cfg) -> Parts | None:
    """The parts `cfg` makes of the leaf `leaf`'s sharded axis (see
    `axis_parts`), or None where it is one block."""
    kind = getattr(cfg, "kind", None)
    if kind not in ("mamba1", "mamba2", "hybrid"):
        return None
    di = cfg.d_inner
    if kind == "mamba1":
        return ((di, True), (di, True)) if leaf == "in_proj" else None
    bc = 2 * cfg.ssm_ngroups * cfg.ssm_state
    heads = di // cfg.ssm_headdim
    if leaf == "in_proj":
        return ((di, True), (di, True), (bc, False), (heads, True))
    if leaf in ("conv_w", "conv_b", "conv"):
        return ((di, True), (bc, False))
    return None


def whole_size(leaf: str, local: int, tp: int, cfg=None) -> int:
    """The whole size of a sharded axis of the leaf `leaf` whose size on
    a rank is `local`: its parts' sum where `cfg` cuts it by parts whose
    local size under tp is `local` (a whole part is held whole), else
    ``local * tp``."""
    parts = _config_parts(leaf, cfg)
    if parts and local_size(parts, tp) == local:
        return sum(size for size, _ in parts)
    return local * tp


def local_parts(parts: Parts | None, tp: int) -> Parts | None:
    """`parts` at a rank's sizes under tp (each sharded part divided), or
    None where no part is held whole (one block, or every part cut)."""
    if not parts or all(cut for _, cut in parts):
        return None
    return tuple((size // tp if cut else size, cut) for size, cut in parts)


def whole_spans(parts: Parts) -> list[tuple[int, int]]:
    """(offset, size) along the axis of each part of `parts` held whole
    (`parts` at a rank's sizes: `local_parts`)."""
    out, lo = [], 0
    for size, cut in parts:
        if not cut:
            out.append((lo, size))
        lo += size
    return out


def local_size(parts: Parts, tp: int) -> int | None:
    """The axis's local size under tp (each sharded part divided), or
    None where tp does not divide a sharded part (the axis stays
    whole)."""
    if any(cut and size % tp for size, cut in parts):
        return None
    return sum(size // tp if cut else size for size, cut in parts)


# attention leaves whose sharded axis carries heads, and the config field
# counting them: a rank holds whole heads, so such a leaf is cut only where
# tp divides that count (with `cfg`)
HEAD_LEAVES = {"wq": "n_heads", "bq": "n_heads", "wo": "n_heads",
               "wk": "kv_heads", "bk": "kv_heads", "wv": "kv_heads",
               "bv": "kv_heads", "w_uq": "n_heads", "w_uk": "n_heads",
               "w_uv": "n_heads"}


def tp_divides(cfg) -> dict[str, int]:
    """What a rank holds a whole block of, by name, for `cfg`'s kind: the
    attention heads and KV heads (the attention kinds and the hybrid's
    shared block), MLA's heads (no KV heads of its own: its latent cache
    is whole), Mamba1's d_inner channels (its ``n_heads`` is unused) and
    the SSD heads of Mamba2 and the hybrid."""
    ssd = {"ssd_heads": cfg.d_inner // max(cfg.ssm_headdim, 1)}
    attn = {"n_heads": cfg.n_heads, "kv_heads": cfg.kv_heads}
    return {"mamba1": {"d_inner": cfg.d_inner},
            "mamba2": ssd, "hybrid": {**ssd, **attn},
            "mla_moe": {"n_heads": cfg.n_heads}}.get(cfg.kind, attn)


def check_tp(cfg, tp: int, tp_reduce: str = "gather") -> None:
    """Raise ValueError, naming each quantity, where tp does not divide
    what `cfg`'s kind shards (`tp_divides`): a rank holds whole heads and
    channel blocks. In psum mode (training) the KV heads of an attention
    block may stay whole where a rank's query heads share their KV heads
    (`HEAD_LEAVES`: each rank then uses its query heads' KV heads of the
    whole projections), except the encoder-decoder's, whose
    cross-attention projects only the KV heads it holds."""
    counts = tp_divides(cfg)
    if (tp_reduce != "gather" and "kv_heads" in counts
            and cfg.kind != "encdec" and cfg.n_heads % tp == 0
            and (cfg.n_heads // cfg.kv_heads) % (cfg.n_heads // tp) == 0):
        counts.pop("kv_heads")
    if any(n % tp for n in counts.values()):
        raise ValueError(
            f"tp={tp} must divide " + ", ".join(
                f"{k}={v}" for k, v in counts.items())
            + ": a rank holds whole heads and channel blocks")


def _heads_divide(path: str, tp: int, cfg) -> bool:
    """False where `path` is an attention leaf of `HEAD_LEAVES` whose
    heads (in `cfg`) tp does not divide."""
    group, _, leaf = path.rpartition("/")
    count = HEAD_LEAVES.get(leaf)
    if cfg is None or count is None or not group.endswith("attn"):
        return True
    return getattr(cfg, count) % tp == 0


def leaf_axis(path: str, shape: tuple[int, ...], tp: int,
              tp_reduce: str = "psum", cfg=None) -> int | None:
    """The axis of a leaf of `shape` at `path` ("/"-separated, leading
    stacked-layer axes allowed) that a (1, tp) serving mesh shards over
    "model", or None (replicated). With `cfg`, an axis cut by parts
    (`axis_parts`) is sharded only where tp divides every sharded
    part, and a head-carrying attention leaf (`HEAD_LEAVES`) only where tp
    divides its heads. With ``cfg.moe_expert_axis="data"`` in psum mode
    an expert leaf's "model" axis is its d_ff (the reference's
    ``tp_if_ep_data``), not E."""
    if tp <= 1:
        return None
    logical = _match(path, tp_reduce)[:len(shape)]
    names = (None,) * (len(shape) - len(logical)) + tuple(logical)
    on_model = (EP_DATA_MODEL_AXIS_NAMES if tp_reduce != "gather"
                and _expert_axis(cfg) == "data" else MODEL_AXIS_NAMES)
    spec = sanitize_spec(tuple("model" if n in on_model else None
                               for n in names), shape, tp)
    axes = [i for i, ax in enumerate(spec) if ax is not None]
    if not axes or not _heads_divide(path, tp, cfg):
        return None
    parts = axis_parts(path.rsplit("/", 1)[-1], shape[axes[0]], cfg)
    return axes[0] if local_size(parts, tp) is not None else None


def param_path(name: str) -> str:
    """A port parameter name ("blocks.3.attn.wq") as the "/"-separated
    path the rules match ("blocks/3/attn/wq")."""
    return name.replace(".", "/")


def param_axes(model: torch.nn.Module, tp: int,
               tp_reduce: str = "gather", cfg=None) -> dict[str, int | None]:
    """{parameter name: its axis sharded over "model", or None} of an
    unsharded `model` (any device, ``meta`` included) on a (1, tp) mesh:
    the port's `param_pspecs` (with `cfg`, axes cut by parts)."""
    return {name: leaf_axis(param_path(name), tuple(p.shape), tp, tp_reduce,
                            cfg)
            for name, p in model.named_parameters()}


def local_copy(full: torch.Tensor, axis: int | None, rank: int,
               tp: int, parts: Parts | None = None) -> torch.Tensor:
    """Rank `rank`'s block of `full` along `axis` (the whole tensor for
    None), as a fresh tensor: one contiguous block, or with `parts`
    (`axis_parts`) its block of each sharded part and each shared part
    whole, side by side in the parts' order. A matrix whose local rows are
    not a multiple of 8 elements is stored on rows padded to one (the view
    is the parameter), so the GEMM's fast paths still read it
    (`transformer.head_params`)."""
    if axis is None:
        return full
    blocks, lo = [], 0
    for size, cut in parts or ((full.shape[axis], True),):
        n = size // tp if cut else size
        blocks.append(full.narrow(axis, lo + (rank * n if cut else 0), n))
        lo += size
    part = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=axis)
    if part.dim() == 2 and part.shape[1] % 8:
        store = torch.empty((part.shape[0], -(-part.shape[1] // 8) * 8),
                            dtype=part.dtype, device=part.device)
        store[:, :part.shape[1]] = part
        return store[:, :part.shape[1]]
    # a copy even where the block is contiguous (a cut on axis 0: vocab
    # rows, experts), so that no view keeps the whole tensor alive
    return part.clone(memory_format=torch.contiguous_format)


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh, tp_reduce: str = "gather",
                 whole: torch.nn.Module | None = None,
                 cfg=None) -> torch.nn.Module:
    """Cut `mesh`'s rank's shard of every parameter of `model`, in place:
    each sharded parameter's data becomes its local copy (`local_copy`,
    cut by the parts `cfg` gives its axis) and the whole is released.
    `whole` is the unsharded model (on ``meta`` will do) when `model` may
    already hold this rank's shard (an earlier engine cut it): a parameter
    of its shard's shape is kept, one of any other shape raises
    ValueError. Returns `model`."""
    tp = model_size(mesh)
    ref = model if whole is None else whole
    axes = param_axes(ref, tp, tp_reduce, cfg)
    shapes = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    cut = {}
    for name, p in model.named_parameters():
        ax, full = axes[name], shapes[name]
        parts = (None if ax is None else
                 axis_parts(name.rsplit(".", 1)[-1], full[ax], cfg))
        local = tuple(local_size(parts, tp) if i == ax else n
                      for i, n in enumerate(full))
        if tuple(p.shape) not in (full, local):
            raise ValueError(f"{name}: shape {tuple(p.shape)} is neither "
                             f"{full} nor its shard {local}")
        if ax is not None and tuple(p.shape) == full:
            cut[name] = (ax, parts)
    for name, (ax, parts) in cut.items():
        p = model.get_parameter(name)
        p.data = local_copy(p.data, ax, mesh.rank, tp, parts)
    return model


def _parts_of(name: str, full: tuple[int, ...], axis: int | None,
              cfg=None) -> Parts | None:
    """The parts of `name`'s sharded axis (None for a whole leaf)."""
    if axis is None:
        return None
    return axis_parts(name.rsplit(".", 1)[-1], full[axis], cfg)


def whole_from_blocks(blocks: list[torch.Tensor], axis: int,
                      parts: Parts | None = None) -> torch.Tensor:
    """The whole tensor from every rank's `local_copy` along `axis` (in
    rank order): each sharded part's blocks side by side, each shared part
    once (from rank 0)."""
    tp = len(blocks)
    if not parts or len(parts) == 1:
        return torch.cat(blocks, dim=axis)
    out, lo = [], 0
    for size, cut in parts:
        n = size // tp if cut else size
        if cut:
            out += [b.narrow(axis, lo, n) for b in blocks]
        else:
            out.append(blocks[0].narrow(axis, lo, n))
        lo += n
    return torch.cat(out, dim=axis)


def _gather_axis(t: torch.Tensor, axis: int, group, n: int) -> list:
    """Every rank's `t` of `group` (`n` ranks), in rank order."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts


def gather_params(named, mesh, axes: dict[str, int | None], cfg=None,
                  whole: dict[str, tuple] | None = None
                  ) -> dict[str, torch.Tensor]:
    """The whole leaves of a rank's shards: {name: tensor} (or a module's
    parameters), each leaf that `axes` (`param_axes` of the whole model)
    shards all-gathered over "model" and put back by its parts
    (`whole_from_blocks`; `whole` gives the whole shapes the parts are
    read from, default the one `cfg`'s parts give the local shape,
    `whole_size`), the others as they are. The inverse of
    `shard_params`; every rank of the "model" group calls it, in the same
    order."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    out = {}
    for name, t in named.items():
        ax = axes.get(name)
        t = t.detach()
        if ax is None or mesh is None or mesh.tp == 1:
            out[name] = t
            continue
        blocks = _gather_axis(t, ax, mesh.group, mesh.tp)
        leaf = name.rsplit(".", 1)[-1]
        full = tuple(whole[name]) if whole else tuple(
            whole_size(leaf, n, mesh.tp, cfg) if i == ax else n
            for i, n in enumerate(t.shape))
        out[name] = whole_from_blocks(blocks, ax, _parts_of(name, full, ax,
                                                            cfg))
    return out


def zero1_axes(shapes: dict[str, tuple], model_axes: dict[str, int | None],
               data: int, cut: dict | None = None) -> dict[str, int | None]:
    """The reference's `zero1_shardings` for the port's local leaves: the
    axis over which "data" cuts each leaf's f32 optimizer state, the first
    axis that "model" does not shard and that `data` divides, or None
    (the state stays whole on every data rank; every leaf where `data` is
    1, and every leaf `cut` ({name: axis or None}, FSDP's) already cuts
    over "data": its state is cut with it)."""
    out = {}
    cut = cut or {}
    for name, shape in shapes.items():
        out[name] = None
        if data <= 1 or cut.get(name) is not None:
            continue
        for i, n in enumerate(shape):
            if i != model_axes.get(name) and n > 0 and n % data == 0:
                out[name] = i
                break
    return out


def data_block(t: torch.Tensor, axis: int | None, mesh) -> torch.Tensor:
    """This data rank's block of `t` along `axis` (ZeRO-1), a fresh
    tensor; `t` itself for None."""
    if axis is None or mesh is None or mesh.data == 1:
        return t
    n = t.shape[axis] // mesh.data
    return t.narrow(axis, mesh.data_rank * n, n).clone(
        memory_format=torch.contiguous_format)


def data_axes(fsdp: dict, experts: dict) -> dict:
    """{name: the "data" axis the leaf itself is cut on, by FSDP (`fsdp`,
    `fsdp_axes`) or as experts over "data" (`experts`, `expert_axes`; no
    leaf is cut by both), or None}."""
    return {n: ax if ax is not None else experts.get(n)
            for n, ax in {**experts, **fsdp}.items()}


@dataclasses.dataclass
class TrainLayout:
    """Where each leaf of a training state lives on `mesh`: the "model"
    axis of each parameter of the whole model (`axes`, psum mode's
    `param_axes`), its parts (`parts`), the "data" axis of its f32
    optimizer state (`zero1`, `zero1_axes`; None without ZeRO-1), the
    "data" axis FSDP cuts the leaf itself on, and its state with it
    (`fsdp`, `fsdp_axes`; empty without FSDP), the "data" axis of an
    expert leaf cut over "data" as its E (`experts`, `expert_axes`;
    empty unless ``moe_expert_axis="data"``) and the leaves whose
    gradient is each "model" rank's share under sequence parallelism
    (`sp_partial`, `sequence_partial`). It maps
    a flattened state (the checkpoint's "__"-joined keys: ``params__<name>``,
    ``opt__{master,m,v}__<name>``, ``opt__step``, ``rng``) to whole leaves
    (`gather`, a collective every rank calls) and back to this rank's
    (`cut`)."""

    mesh: object
    axes: dict
    parts: dict
    zero1: dict
    fsdp: dict = dataclasses.field(default_factory=dict)
    experts: dict = dataclasses.field(default_factory=dict)
    sp_partial: set = dataclasses.field(default_factory=set)

    def data_axes(self) -> dict:
        """`data_axes` of the layout's FSDP and expert cuts."""
        return data_axes(self.fsdp, self.experts)

    def data_cut(self) -> set:
        """The names of the leaves cut over "data" (by FSDP or as experts
        over "data"): their gradients are whole over "data" after the
        backward, and their optimizer state is cut with them."""
        return {n for n, ax in self.data_axes().items() if ax is not None}

    def whole_parts(self) -> dict:
        """{name: (its "model" axis, its parts at a rank's sizes)} of each
        leaf cut by parts that holds a part whole (Mamba2's in_proj and
        conv: B and C, `axis_parts`): the gradient of such a part is each
        rank's heads' share until summed over "model"."""
        tp = model_size(self.mesh)
        out = {}
        for name, parts in self.parts.items():
            loc = local_parts(parts, tp)
            if loc is not None:
                out[name] = (self.axes[name], loc)
        return out

    def sharded(self) -> dict:
        """{name: None, or its `whole_parts` entry} of each leaf "model"
        shards: `optim.adamw.global_norm`'s `sharded`."""
        parts = self.whole_parts()
        return {n: parts.get(n) for n, ax in self.axes.items()
                if ax is not None}

    def _leaf(self, key: str) -> tuple:
        head, _, name = key.partition("__")
        data = self.data_axes()
        if head == "params":
            return name, data.get(name)
        if head == "opt":
            kind, _, name = name.partition("__")
            if kind in ("master", "m", "v"):
                ax = data.get(name)
                return name, ax if ax is not None else self.zero1.get(name)
        return None, None

    def gather(self, flat: dict) -> dict:
        """Whole leaves: each leaf FSDP cuts and each moment gathered over
        "data" on its axis, each sharded leaf over "model" on its axis."""
        mesh, out = self.mesh, {}
        for key, t in flat.items():
            name, dax = self._leaf(key)
            t = torch.as_tensor(t).detach()
            if dax is not None and mesh.data > 1:
                t = torch.cat(_gather_axis(t, dax, mesh.data_group,
                                           mesh.data), dim=dax)
            ax = self.axes.get(name) if name else None
            if ax is not None and mesh.tp > 1:
                t = whole_from_blocks(_gather_axis(t, ax, mesh.group,
                                                   mesh.tp), ax,
                                      self.parts.get(name))
            out[key] = t
        return out

    def cut(self, flat: dict) -> dict:
        """This rank's leaves of whole ones."""
        mesh, out = self.mesh, {}
        for key, t in flat.items():
            name, dax = self._leaf(key)
            ax = self.axes.get(name) if name else None
            if ax is not None:
                t = local_copy(t, ax, mesh.rank, mesh.tp,
                               self.parts.get(name))
            out[key] = data_block(t, dax, mesh)
        return out


def train_layout(model: torch.nn.Module, mesh, cfg=None,
                 zero1: bool = False) -> TrainLayout:
    """The `TrainLayout` of the whole `model` (``meta`` will do) on
    `mesh` in psum mode, with ZeRO-1's axes where `zero1`, FSDP's where
    ``cfg.fsdp``, the experts' "data" axes under
    ``moe_expert_axis="data"`` and the leaves summed over "model" under
    sequence parallelism."""
    tp = model_size(mesh)
    axes = param_axes(model, tp, "psum", cfg)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    parts = {n: _parts_of(n, full[n], axes[n], cfg) for n in full}
    local = {n: tuple(local_size(parts[n], tp) if i == axes[n] else d
                      for i, d in enumerate(shape))
             for n, shape in full.items()}
    fsdp = fsdp_axes(model, mesh, cfg)
    experts = expert_axes(model, mesh, cfg)
    data = mesh.data if (zero1 and mesh is not None) else 1
    return TrainLayout(mesh, axes, parts,
                       zero1_axes(local, axes, data,
                                  data_axes(fsdp, experts)), fsdp, experts,
                       sequence_partial(axes, cfg) if tp > 1 else set())


def fsdp_leaf_axis(p: torch.Tensor) -> int | None:
    """The axis over which FSDP cut the parameter `p` over "data"
    (`cut_over_data`), or None."""
    return getattr(p, "fsdp_axis", None)


@torch.no_grad()
def cut_over_data(model: torch.nn.Module, axes: dict, mesh) -> None:
    """Cut each parameter of `model` that `axes` ({name: "data" axis or
    None}, `fsdp_axes`) names to this data rank's block, in place, and
    mark it with its axis (`fsdp_leaf_axis`: `distributed.fsdp` gathers it
    before use) and each module that holds it with ``fsdp_cut`` (so a
    model FSDP did not cut costs `distributed.fsdp` one attribute read a
    block)."""
    for name, p in model.named_parameters():
        ax = axes.get(name)
        if (ax is None or mesh is None or mesh.data == 1
                or fsdp_leaf_axis(p) is not None):
            continue
        p.data = data_block(p.data, ax, mesh)
        p.fsdp_axis = ax
        path = name.split(".")[:-1]
        for i in range(len(path) + 1):
            model.get_submodule(".".join(path[:i])).fsdp_cut = True


@torch.no_grad()
def cut_experts_over_data(model: torch.nn.Module, axes: dict, mesh) -> None:
    """Cut each expert leaf of `model` that `axes` (`expert_axes`) names
    to this data rank's block of the experts, in place. The leaves stay
    cut (the tokens go to them, `moe.moe_ffn_ep_data`); one already cut
    (``expert_cut``) is left as it is."""
    for name, p in model.named_parameters():
        ax = axes.get(name)
        if (ax is None or mesh is None or mesh.data == 1
                or getattr(p, "expert_cut", False)):
            continue
        p.data = data_block(p.data, ax, mesh)
        p.expert_cut = True


# ---------------------------------------------------------------------------
# Serving-state sharding: decode caches sharded along their head axis.
# ---------------------------------------------------------------------------

# leaf basename -> axis carrying heads (or head-grouped channels), counted
# from the end. KV cache leaves are (L, B, T, KV, hd) (dense) or (L, pages,
# page, KV, hd) (paged pool): heads sit second-to-last. SSM conv history
# (..., B, K-1, channels) shards its channel axis (by parts: `axis_parts`).
# MLA latent leaves are rank-compressed, shared across heads: replicated.
# Enc-dec cross-KV (xk/xv) is (L, B, T, KV, hd) like self-attn KV. Per-row
# scalars (src_len, pos_off, index) have no rule and stay replicated. The
# reference's table gives the SSM scan state axis 2, which is d_inner or
# the heads on a (L, B, ...) leaf but the batch on the hybrid's (G, E, B,
# H, N, P): GSPMD may shard a batch without changing a number, a local
# rank must hold every row. So the port counts the scan state's axis from
# the end, by kind (`SSM_STATE_AXES`).
SERVING_STATE_AXES: dict[str, int] = {"k": -2, "v": -2,
                                      "xk": -2, "xv": -2,
                                      "k_pages": -2, "v_pages": -2,
                                      "conv": -1}

# the SSM scan state ``ssm``'s channel or head axis: mamba1 (..., B, di,
# ds), mamba2 and the hybrid (..., B, H, N, P)
SSM_STATE_AXES: dict[str, int] = {"mamba1": -2, "mamba2": -3, "hybrid": -3}


def state_axis(name: str, shape: tuple[int, ...], tp: int,
               cfg=None) -> int | None:
    """The axis a (1, tp) mesh shards of the decode-state leaf `name` of
    `shape`, or None: the reference's `serving_state_pspecs` for the KV
    leaves, the SSM leaves' channel or head axis for `cfg`'s kind (the
    ``ssm`` leaf needs `cfg`; the ``conv`` axis is cut by its parts)."""
    if name == "ssm":
        ax = SSM_STATE_AXES.get(getattr(cfg, "kind", None))
    else:
        ax = SERVING_STATE_AXES.get(name)
    if ax is None or not shape or tp <= 1:
        return None
    ax = ax % len(shape)
    parts = axis_parts(name, shape[ax], cfg)
    return ax if local_size(parts, tp) is not None else None


def state_axes(tree, tp: int, cfg=None):
    """`state_axis` of every leaf of a decode-state tree (nested dicts of
    tensors), keyed like the tree."""
    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return state_axis(name, tuple(t.shape), tp, cfg)

    return walk(tree, "")


def query_kv_heads(cfg, tp: int, rank: int) -> int | None:
    """In psum mode where tp divides the query heads and not the KV heads
    (`HEAD_LEAVES`: ``wk`` and ``wv`` whole), the KV heads rank `rank`'s
    query heads read (`layers.attention_apply`'s span), which its cache
    holds; None otherwise."""
    if (getattr(cfg, "tp_reduce", "psum") == "gather" or tp <= 1
            or getattr(cfg, "tp_collectives", "auto") != "explicit"
            or cfg.n_heads % tp or cfg.kv_heads % tp == 0):
        return None
    H, group = cfg.n_heads // tp, cfg.n_heads // cfg.kv_heads
    return ((rank + 1) * H - 1) // group + 1 - rank * H // group


def local_state_shape(name: str, shape: tuple[int, ...],
                      cfg=None) -> tuple[int, ...]:
    """The local shape, under the current mesh, of the decode-state leaf
    `name` whose whole shape is `shape`: its head or channel axis cut to
    this rank's heads or channels where `state_axis` shards it (by parts
    for `cfg`'s SSM conv history), or, in psum mode where tp divides the
    query heads and not the KV heads, a KV cache's heads to those its
    query heads read (`query_kv_heads`). Every cache allocator of the
    port takes its shape from here, so a rank holds only its heads'
    cache."""
    tp = model_size()
    if name in ("k", "v", "k_pages", "v_pages") and cfg is not None:
        n = query_kv_heads(cfg, tp, current_mesh().rank if tp > 1 else 0)
        if n is not None and shape[-2] == cfg.kv_heads:
            return (*shape[:-2], n, shape[-1])
    ax = state_axis(name, tuple(shape), tp, cfg)
    if ax is None:
        return tuple(shape)
    n = local_size(axis_parts(name, shape[ax], cfg), tp)
    return tuple(n if i == ax else m for i, m in enumerate(shape))
