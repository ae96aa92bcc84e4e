"""Dry-run of every (arch, shape) cell: what each step should cost, counted
from the port's own ops on meta tensors, with no card and no device
memory, on one H100 or as one rank of the reference's production mesh.

    python -m repro_torch.launch.dryrun                      # all cells, one card
    python -m repro_torch.launch.dryrun --mesh both          # 16x16 and 2x16x16
    python -m repro_torch.launch.dryrun --mesh single --variant kv_batch
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k

The port's counterpart of the JAX package's `repro.launch.dryrun`. There
a cell is lowered and compiled for a TPU mesh and its HLO analysed; here
the parameters are built on ``meta`` at the config's full width and depth
(`ModelApi.init(cfg, None, device="meta")`, the counterpart of
``jax.eval_shape(model.init)``), the inputs are the cell's `input_specs`
as meta tensors, and one call of the step runs under
`core.opanalyze.analyze_step`: train cells the port's whole train step
with AdamW (`train.step.make_train_step`), prefill cells ``prefill``,
decode cells ``decode_step`` on the meta decode state. The hand-written
GEMM's wrappers take meta operands on their shape-only path (the
counterpart of the reference's ``ops.force_mode("xla")``): each product
is recorded under the path, tile and K segments `plan` gives the card.

Meshes (``--mesh``): ``card`` is one H100, ``h100x1``. ``single`` and
``multi`` are the reference's production meshes, (16, 16) over ("data",
"model") and (2, 16, 16) over ("pod", "data", "model")
(`launch.mesh.make_production_mesh`), as rank (0, ..., 0) runs its step:
a dry mesh whose collectives are logged, not posted, and counted with the
reference's ring formulas. The rank's step is the reference's dry-run
cell written out: psum-mode explicit collectives (the reference's default
``tp_reduce``), training with ZeRO-1, parameters on meta at the rank's
local shapes (`distributed.sharding`: "model" by whole heads and parts,
"data" where ``cfg.fsdp``), and its rows of the batch and of the decode
state (`local_specs`, the counterpart of the reference's
`batch_shardings`: the batch over ("pod", "data") where they divide it,
KV heads over "model" where tp divides them). Where tp does not divide a
leaf's heads the rank holds it whole (the reference's `sanitize_spec`
rule; `sharding.check_tp`, the engine's and the trainer's guard, is not
called). Each leaf the rank holds otherwise than the reference's chip
goes into the JSON's ``departures``: heads that tp does not divide, and
the caches the reference cuts by GSPMD's split attention (the sequence
over "model" where tp does not divide the KV heads, over "data" at
``long_500k``; MLA's latent ``c_kv`` over "model"), which the rank keeps
whole (ROADMAP A7.3c), and under ``moe_expert_axis="data"`` the expert
leaves, which the reference's compiled cells hold over "model" whatever
its rules say (`departures`).

One JSON per cell goes to ``artifacts/dryrun_torch/<mesh>/<arch>_<shape>[__<variant>].json``
(``h100x1``, ``h100_16x16`` or ``h100_2x16x16``) with the reference's
keys, less the XLA-only ones: ``lower_s`` and ``compile_s`` (here
``build_s`` and ``analyze_s``), ``while_trip_counts`` (the port's loops
are Python loops, counted as they run), ``xla_cost_analysis_flops_raw``,
``xla_cost_analysis_bytes_raw`` and
``memory_analysis.generated_code_size_in_bytes``. ``memory_analysis``
holds the arguments' and outputs' bytes and, as ``temp_size_in_bytes``,
the peak-live estimate less the arguments. Added: ``roofline``
(`core.roofline.roofline_from_cost` on the ``h100`` spec), ``gemms`` (the
GEMM's launches, FLOPs, bytes and summed bound per path), ``gemm_flops``
and ``n_ops``; on a mesh also ``collective_calls_by_op``,
``collective_operand_bytes_by_op`` and ``departures``. Every figure is
modelled from the ``h100`` data sheet's rates, not measured.

Variants (``--variant``, a mesh only), the reference's config transforms:
``tpx`` (the reference's explicit collectives: the port's own psum mode,
so its artifact equals the default's apart from ``variant``),
``kv_batch`` (the decode caches cut on the batch alone, the sequence
never), ``moe_smap`` (the MoE FFN's explicit expert parallelism,
`models.moe.moe_ffn_shard_map`), ``sp`` and ``tpx_sp`` (Megatron
sequence parallelism: the residual stream on the rank's 1/tp of the
sequence, all-gathers before the column products and reduce-scatters
after the row products, in training and prefill; decode never), ``ep_data``
(experts over "data" with their d_ff over "model", tokens exchanged by
all-to-all over "data", FSDP off), ``sp_ep_data`` (both) and
``moe_smap_sp`` (``moe_smap`` under SP) run. The cache-dtype variants
(``kv_fp8``, ``kv_batch_fp8``) raise a ValueError, since the port's
caches stay bf16 (the hand-written GEMM writes no float8, and MLA's
latent decompression is a GEMM whose output takes the cache's dtype).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import re
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPE_DEFS, all_cells, get_config, input_specs
from repro_torch.configs.common import Spec, meta_tree
from repro_torch.core.opanalyze import analyze_step
from repro_torch.core.roofline import roofline_from_cost
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (init_train_state, make_train_step,
                                    shard_state, train_config)

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESH = "h100x1"
# --mesh: the directory of each mesh's artifacts
MESHES = {"card": MESH, "single": "h100_16x16", "multi": "h100_2x16x16"}

# the reference's variants (its `VARIANTS` transforms): those the port
# runs on a mesh, among them Megatron-SP's and the experts over "data"
# (`SP_EP_VARIANTS`), and the float8 caches, which it refuses
SP_EP_VARIANTS = ("sp", "ep_data", "sp_ep_data", "moe_smap_sp", "tpx_sp")
HONOURED_VARIANTS = ("tpx", "kv_batch", "moe_smap") + SP_EP_VARIANTS
FP8_VARIANTS = ("kv_fp8", "kv_batch_fp8")
VARIANTS = {
    None: lambda cfg: cfg,
    "tpx": lambda cfg: dataclasses.replace(cfg, tp_collectives="explicit"),
    "kv_batch": lambda cfg: cfg,
    "moe_smap": lambda cfg: dataclasses.replace(cfg, moe_impl="shard_map"),
    "sp": lambda cfg: dataclasses.replace(cfg, sequence_parallel=True),
    "ep_data": lambda cfg: dataclasses.replace(
        cfg, moe_expert_axis="data", fsdp=False),
    "sp_ep_data": lambda cfg: dataclasses.replace(
        cfg, sequence_parallel=True, moe_expert_axis="data", fsdp=False),
    "moe_smap_sp": lambda cfg: dataclasses.replace(
        cfg, moe_impl="shard_map", sequence_parallel=True),
    "tpx_sp": lambda cfg: dataclasses.replace(
        cfg, tp_collectives="explicit", sequence_parallel=True),
}


def refuse_variant(variant: str) -> None:
    """Raise a ValueError saying why the port runs no cell of `variant`
    (one it does not honour)."""
    if variant in FP8_VARIANTS:
        raise ValueError(f"variant {variant!r} stores the cache in float8; "
                         "the port's caches are bf16 (its GEMM writes no "
                         "float8)")
    known = HONOURED_VARIANTS + FP8_VARIANTS
    raise ValueError(f"unknown variant {variant!r}; the reference's are "
                     f"{list(known)}")


def variant_config(cfg, variant: str | None):
    """`cfg` under `variant` (refused unless honoured)."""
    if variant not in VARIANTS:
        refuse_variant(variant)
    return VARIANTS[variant](cfg)


def _dp(mesh, size: int):
    """The data-parallel axes of a batch dim of `size`, or None where
    they do not divide it (the reference's `_dp`)."""
    ax = dp_axes(mesh)
    if size % mesh.dp == 0:
        return ax if len(ax) > 1 else ax[0]
    return None


def reference_specs(shape: str, mesh, specs: dict, cfg,
                    variant: str | None = None) -> dict:
    """The reference's `batch_shardings` of the cell's inputs, as
    partition-spec tuples over the port's spec tree (`specs`): each input
    on the batch axes, the decode state by kind (KV heads over "model"
    where tp divides them, else the sequence; over "data" at
    ``long_500k``; MLA's latent over "model"), each sanitised."""
    step = SHAPE_DEFS[shape]["step"]
    B = (specs["token"] if step == "decode" else specs["tokens"]).shape[0]
    dp = _dp(mesh, B)
    long_ctx = shape == "long_500k"
    mdl, tp = "model", mesh.tp

    def ns(sp, *spec):
        return sharding.sanitize_mesh_spec(spec, sp.shape, mesh.shape)

    out = {name: ns(sp, dp) for name, sp in specs.items() if name != "state"}
    if step != "decode":
        return out
    st = specs["state"]

    def kv_spec(sp):
        kv = sp.shape[3]
        if variant == "kv_batch":
            return ns(sp, None, dp, None, mdl if kv % tp == 0 else None,
                      None)
        seq_ax, tp_axes = (None, (mdl, None)) if kv % tp == 0 else (
            mdl, (None, None))
        if long_ctx:
            return ns(sp, None, None, ("data",) if seq_ax is None
                      else ("data", seq_ax), *tp_axes)
        return ns(sp, None, dp, seq_ax, *tp_axes)

    kind, state = cfg.kind, {}
    if kind in ("dense", "moe", "vlm"):
        state["kv"] = {"k": kv_spec(st["kv"]["k"]),
                       "v": kv_spec(st["kv"]["v"])}
    elif kind == "mla_moe":
        state["kv"] = {"c_kv": ns(st["kv"]["c_kv"], None, dp, None, mdl),
                       "k_pe": ns(st["kv"]["k_pe"], None, dp, None, None)}
    elif kind == "mamba1":
        state["kv"] = {"conv": ns(st["kv"]["conv"], None, dp, None, mdl),
                       "ssm": ns(st["kv"]["ssm"], None, dp, mdl, None)}
    elif kind == "hybrid":
        c, a = st["cache"]["mamba"], st["cache"]["attn"]
        attn = ((None, None, "data", mdl, None) if long_ctx
                else (None, dp, None, mdl, None))
        state["cache"] = {
            "mamba": {"conv": ns(c["conv"], None, None, dp, None, mdl),
                      "ssm": ns(c["ssm"], None, None, dp, mdl, None, None)},
            "attn": {"k": ns(a["k"], *attn), "v": ns(a["v"], *attn)}}
    elif kind == "encdec":
        kv = st["kv"]
        state["kv"] = {"k": kv_spec(kv["k"]), "v": kv_spec(kv["v"]),
                       "xk": ns(kv["xk"], None, dp, None, mdl, None),
                       "xv": ns(kv["xv"], None, dp, None, mdl, None)}
        state["src_len"] = ns(st["src_len"], dp)
    if "pos_off" in st:
        state["pos_off"] = ns(st["pos_off"], dp)
    state["index"] = ns(st["index"], dp) if st["index"].shape else ()
    out["state"] = state
    return out


def _walk(tree, fn, path=()):
    """`tree` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def local_specs(shape: str, mesh, specs: dict, cfg,
                variant: str | None = None) -> tuple[dict, dict]:
    """(the rank's input specs, the reference's chip's local shapes): each
    input cut on the axis `reference_specs` puts the batch on (where the
    data-parallel axes divide it), each decode-state leaf also on its head
    or channel axis as the port's caches are cut under the mesh
    (`sharding.local_state_shape`, with `cfg` as the rank runs it)."""
    ref = reference_specs(shape, mesh, specs, cfg, variant)
    rcfg = train_config(cfg, mesh, check=False)
    dp = _dp(mesh, (specs["token"] if "token" in specs
                    else specs["tokens"]).shape[0])
    prev = sharding.current_mesh()
    sharding.set_mesh(mesh)
    try:
        def cut(path, sp):
            spec = _get(ref, path)
            out = list(sp.shape)
            if path[0] == "state":
                out = list(sharding.local_state_shape(path[-1], sp.shape,
                                                      rcfg))
            for i, ax in enumerate(spec):
                if dp is not None and ax == dp:
                    out[i] //= mesh.dp
            return Spec(tuple(out), sp.dtype)

        local = _walk(specs, cut)
    finally:
        sharding.set_mesh(prev)
    want = _walk(specs, lambda path, sp: sharding.spec_shape(
        _get(ref, path), sp.shape, mesh.shape))
    return local, want


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _layer_name(name: str) -> str:
    """A parameter name with its layer index as ``*``."""
    return ".".join("*" if p.isdigit() else p for p in name.split("."))


def _stacked(name: str, cfg) -> tuple[int, ...]:
    """The leading axes the reference stacks the parameter `name`'s
    layers on (its rules match a leaf's trailing axes, so a rule longer
    than the port's per-layer leaf reaches into them): (L,), the
    hybrid's (groups, attn_every), the encoder's (encoder layers,), or ()
    for an unstacked leaf."""
    head = name.split(".")
    if len(head) < 2 or not head[1].isdigit():
        return ()
    if cfg.kind == "hybrid":
        return (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    if head[0] == "encoder":
        return (cfg.n_encoder_layers,)
    return (cfg.n_layers,)


# why an expert leaf departs under moe_expert_axis="data" (`departures`)
EXPERTS_RESET = ("the reference's param_pspecs resets the expert axis to "
                 "\"model\" for each leaf; the rank cuts E over \"data\" "
                 "and d_ff over \"model\" as its rules say")


def departures(params, cfg, mesh, inputs: dict, want: dict) -> list:
    """Each leaf the rank holds otherwise than the reference's chip: the
    parameters (by name, their layers folded into ``*``) against the
    reference's rules on its stacked leaves as its `param_pspecs` applies
    them (`sharding.reference_shape`; the hybrid's per-head ``A_log`` is
    one such, whose stacked rule lands on the layer axis), the inputs and
    decode state against `local_specs`' reference shapes. `param_pspecs`
    sets its rules again for each leaf with the experts over "model"
    (``set_mesh_rules(mesh, fsdp)``), so under ``moe_expert_axis="data"``
    its chip holds every expert leaf (E/tp, d, f) where the rank holds
    (E/dp, d, f/tp) as the rules say: each such leaf is listed with that
    ``reason``."""
    out = {}
    whole = get_model(cfg).init(cfg, None, device="meta")
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    for name, p in params.named_parameters():
        stack = _stacked(name, cfg)
        ref = sharding.reference_shape(sharding.param_path(name),
                                       stack + shapes[name], mesh.shape,
                                       cfg.fsdp)[len(stack):]
        if tuple(p.shape) != ref:
            entry = out.setdefault(_layer_name(name), {
                "leaf": _layer_name(name), "port": list(p.shape),
                "reference": list(ref)})
            if cfg.moe_expert_axis == "data" and ".experts." in name:
                entry["reason"] = EXPERTS_RESET

    def check(path, t):
        ref = tuple(_get(want, path))
        if tuple(t.shape) != ref:
            key = "/".join(path)
            out[key] = {"leaf": key, "port": list(t.shape),
                        "reference": list(ref)}

    _walk(inputs, check)
    return list(out.values())


def _rank_params(api, cfg, mesh, device, generator=None):
    """The rank's parameters: the whole model from `generator` (shapes
    only on meta) cut to its shard over "model", over "data" where
    ``cfg.fsdp``, and its experts' E over "data" under
    ``moe_expert_axis="data"`` (`train.step.shard_state`'s cut, without an
    optimizer)."""
    params = api.init(cfg, generator, device=device)
    rcfg = train_config(cfg, mesh, check=False)
    whole = api.init(rcfg, None, device="meta")
    sharding.shard_params(params, mesh, "psum", whole=whole, cfg=rcfg)
    sharding.cut_over_data(params, sharding.fsdp_axes(whole, mesh, rcfg),
                           mesh)
    sharding.cut_experts_over_data(
        params, sharding.expert_axes(whole, mesh, rcfg), mesh)
    return params


def build_cell(arch: str, shape: str, mesh=None, *, cfg=None,
               specs: dict | None = None, variant: str | None = None,
               device="meta", generator=None, inputs: dict | None = None
               ) -> tuple:
    """(fn, args, cfg) of one cell: ``fn(*args)`` is its step. `cfg` and
    `specs` override the cell's config and (global) input specs (a cut
    depth or another batch: how ``chip_smoke.py`` rebuilds the steps it
    ran on the card). On `mesh` (dry, or a real rank's) the step is that
    rank's (the module docstring): its parameters on `device` (from
    `generator`, else shapes only on meta) and its inputs `inputs` (else
    meta tensors of `local_specs`)."""
    cfg = variant_config(cfg or get_config(arch), variant)
    api = get_model(cfg)
    specs = specs if specs is not None else input_specs(arch, shape)
    step = SHAPE_DEFS[shape]["step"]
    if mesh is None:
        inputs = meta_tree(specs) if inputs is None else inputs
        if step == "train":
            state = init_train_state(None, api, cfg, device="meta")
            return (make_train_step(api, cfg, AdamWConfig()),
                    (state, inputs), cfg)
        params = api.init(cfg, None, device="meta")
        rcfg = cfg
    else:
        if inputs is None:
            inputs = meta_tree(local_specs(shape, mesh, specs, cfg,
                                           variant)[0])
        rcfg = train_config(cfg, mesh, check=False)
        if step == "train":
            params = api.init(cfg, generator, device=device)
            state = shard_state(params, api, cfg, mesh, zero1=True,
                                check=False)
            fn = make_train_step(api, cfg, AdamWConfig(), mesh=mesh,
                                 zero1=True, local_batch=True, check=False)
            return fn, (state, inputs), cfg
        params = _rank_params(api, cfg, mesh, device, generator)
    if step == "prefill":
        def prefill(params, batch):
            with _installed(mesh):
                return api.prefill(params, batch, rcfg)[0]

        return prefill, (params, inputs), cfg

    def decode(params, token, state):
        with _installed(mesh):
            return api.decode_step(params, token, state, rcfg)

    return decode, (params, inputs["token"], inputs["state"]), cfg


@contextlib.contextmanager
def _installed(mesh):
    """`mesh` installed on the thread for the block (nothing for None)."""
    prev = sharding.current_mesh()
    sharding.set_mesh(mesh if mesh is not None else prev)
    try:
        yield
    finally:
        sharding.set_mesh(prev)


def model_flops(cfg, shape: str) -> tuple[float, int]:
    """(model FLOPs, tokens) of one step of `shape`, the reference's
    formula: (6 if training else 2) x active params x tokens, a decode
    step's tokens one a row."""
    d = SHAPE_DEFS[shape]
    tokens = d["global_batch"] * (d["seq_len"] if d["step"] != "decode"
                                  else 1)
    return ((6 if d["step"] == "train" else 2) * cfg.n_active_params()
            * tokens, tokens)


def run_cell(arch: str, shape: str, *, mesh: str = "card",
             variant: str | None = None, out_dir: str | Path = ARTIFACTS,
             force: bool = False) -> dict:
    """Dry-run one cell on `mesh` ("card", "single" or "multi") and write
    its JSON (the module docstring lists its keys; an existing one is
    returned as it is unless `force`)."""
    if variant is not None and mesh == "card":
        raise ValueError(f"variant {variant!r} changes a mesh's cell; "
                         "give --mesh single, multi or both")
    cfg0 = variant_config(get_config(arch), variant)
    out = Path(out_dir) / MESHES[mesh]
    out.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    path = out / f"{arch}_{shape}{suffix}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    dry = None if mesh == "card" else make_production_mesh(mesh == "multi")
    n_chips = 1 if dry is None else dry.size
    t0 = time.perf_counter()
    fn, args, cfg = build_cell(arch, shape, dry, variant=variant)
    t1 = time.perf_counter()
    cost = analyze_step(fn, *args)
    t2 = time.perf_counter()
    mf, tokens = model_flops(cfg0, shape)
    report = roofline_from_cost(f"{arch}_{shape}{suffix}", cost,
                                n_chips=n_chips, model_flops=mf)
    result = {
        "arch": arch,
        "shape": shape,
        "variant": variant,
        "mesh": MESHES[mesh],
        "n_chips": n_chips,
        "step": SHAPE_DEFS[shape]["step"],
        "build_s": round(t1 - t0, 3),
        "analyze_s": round(t2 - t1, 3),
        "flops_per_chip": float(cost.flops),
        "bytes_per_chip": float(cost.hbm_bytes),
        "collective_wire_bytes_per_chip": float(cost.collective_bytes),
        "collective_wire_bytes_by_op": dict(cost.collective_by_op),
        "model_flops": float(mf),
        "tokens_per_step": tokens,
        "memory_analysis": {
            "argument_size_in_bytes": cost.argument_bytes,
            "output_size_in_bytes": cost.output_bytes,
            "temp_size_in_bytes": cost.peak_live_bytes - cost.argument_bytes,
        },
        "roofline": report.as_row(),
        "gemm_flops": float(cost.gemm_flops),
        "gemms": {p: dataclasses.asdict(g) for p, g in cost.gemms.items()},
        "n_ops": cost.n_ops,
    }
    if dry is not None:
        specs = input_specs(arch, shape)
        _, want = local_specs(shape, dry, specs, cfg, variant)
        step = SHAPE_DEFS[shape]["step"]
        if step == "train":
            params, inputs = args[0]["params"], args[1]
        else:
            params = args[0]
            inputs = args[1] if step == "prefill" else {
                "token": args[1], "state": args[2]}
        result["collective_calls_by_op"] = dict(cost.collective_calls)
        result["collective_operand_bytes_by_op"] = {
            k: float(v) for k, v in cost.collective_operand_bytes.items()}
        result["departures"] = departures(params, cfg, dry, inputs, want)
    del fn, args
    path.write_text(json.dumps(result, indent=1))
    return result


def table(results: list) -> str:
    """A markdown table of dry-run results: per chip the dot FLOPs, bytes
    and collective wire bytes, the bound and its dominant term, and the
    leaves in ``departures``, counted by group ("attn 7": seven
    attention leaves of every block; "state 2": two decode-state
    leaves)."""
    lines = ["| Cell | Mesh | FLOPs/chip | Bytes/chip | Collective B/chip "
             "| Bound s | Dominant | Departures |",
             "| --- | --- | ---: | ---: | ---: | ---: | --- | --- |"]
    for r in results:
        groups = collections.Counter(
            re.split(r"[./]", d["leaf"].replace("blocks.*.", ""))[0]
            for d in r.get("departures", []))
        dep = ", ".join(f"{g} {n}" for g, n in sorted(groups.items()))
        lines.append(
            f"| {r['arch']} {r['shape']}"
            + (f" {r['variant']}" if r["variant"] else "")
            + f" | {r['mesh']} | {r['flops_per_chip']:.4e} "
            f"| {r['bytes_per_chip']:.4e} "
            f"| {r['collective_wire_bytes_per_chip']:.4e} "
            f"| {r['roofline']['bound_s']:.4e} | {r['roofline']['dominant']} "
            f"| {dep or 'none'} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    """Dry-run the selected cells; exit 1 if any fails."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="dry-run on meta: one H100, or "
                                 "one rank of the production mesh")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both", "card"],
                    default="card")
    ap.add_argument("--variant", default=None,
                    help=f"a reference variant: {list(HONOURED_VARIANTS)} "
                    "run on a mesh, the others are refused (docstring)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the cells at the end")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    if args.variant not in VARIANTS:
        refuse_variant(args.variant)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"], "card": ["card"]}[args.mesh]
    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    failures, done = [], []
    for arch, shape in cells:
        for mesh in meshes:
            tag = f"{arch} x {shape} x {MESHES[mesh]}" + (
                f" x {args.variant}" if args.variant else "")
            try:
                t0 = time.perf_counter()
                r = run_cell(arch, shape, mesh=mesh, variant=args.variant,
                             out_dir=args.out, force=args.force)
                done.append(r)
                roof = r["roofline"]
                print(f"[ok] {tag}: flops={r['flops_per_chip']:.4e} "
                      f"bytes={r['bytes_per_chip']:.4e} "
                      f"coll={r['collective_wire_bytes_per_chip']:.4e}B "
                      f"bound={roof['bound_s']:.4e}s ({roof['dominant']}) "
                      f"args={r['memory_analysis']['argument_size_in_bytes'] / 2**30:.2f}GiB "
                      + (f"departures={len(r['departures'])} "
                         if "departures" in r else "")
                      + f"({time.perf_counter() - t0:.1f}s)", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}", flush=True)
                traceback.print_exc()
    if args.table:
        print(table(done))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(f"  {t}: {e}")
        return 1
    print(f"\nall {len(cells) * len(meshes)} dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
