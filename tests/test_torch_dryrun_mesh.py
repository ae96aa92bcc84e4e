"""The mesh dry-run against the JAX package's, at smoke size on a (2, 2)
("data", "model") mesh.

The reference's cells are built as its `build_cell` builds them
(``param_shardings(fsdp=cfg.fsdp)``, ``batch_shardings``,
``zero1_shardings``) on four forced host devices under an
``AxisType.Auto`` mesh and compiled in one subprocess for the module
(`torch_mesh_reference.py`); the port's are rank (0, 0)'s step on meta on a
dry (2, 2) mesh (`launch.mesh.make_dry_mesh`, `launch.dryrun.build_cell`).

(a) The port's per-rank dot FLOPs equal ``analyze_hlo(hlo, 4)``'s per chip
after the terms named here, each computed from the config and the cell.
(b) Collective wire bytes by op, tensors apart from scalar sums: in every
cell the port's bytes, minus what only it posts, plus what only the
reference posts, equal the reference's, each term in closed form from the
config and the cell (`train_differences`, `embedding_and_logits`);
hybrid-decode's GSPMD re-layout of Mamba2's concatenated leaves, which the
port does not make, is named and bounded. (c) Every parameter, input and decode-state leaf
of rank (d, m) has the local shape of the reference's
``NamedSharding.shard_shape``, except the leaves the cell's
``departures`` list. (d) Four gloo ranks run the same steps for real: each
rank's posted collectives (op, calls, operand bytes) equal the dry count.
(e) Where tp does not divide the attention heads the rank computes them
whole and gives tp=1's logits and loss. The reference's five Megatron-SP
and experts-over-"data" variants (``sp``, ``tpx_sp``, ``moe_smap_sp``,
``sp_ep_data`` on prefill cells, ``ep_data`` on a training cell) are
cases of every test above, their differences named in
`variant_differences` and `train_differences`. The copies the port keeps of the
reference's rules (`sharding.logical_to_mesh`, `dp_axes`) and of its ring
formulas (`opanalyze.collective_wire`) are held to the originals.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_mesh_ranks as R
from repro.core import hloanalyze
from repro.distributed import sharding as jsharding
from repro_torch import configs
from repro_torch.core.opanalyze import analyze_step, collective_wire
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (RankPool, dp_axes, make_dry_mesh,
                                     make_production_mesh)
from repro_torch.models import moe
from test_torch_dryrun_ssm import mamba1_c_dot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 2)
DP, TP = MESH
# fewer elements than this: a scalar sum, as `torch_mesh_reference.SCALAR`
SCALAR = 8
# case: (arch, cell, config changes)
CASES = {
    "dense-train": ("qwen2-7b", "train_4k", {}),
    "dense-prefill": ("qwen2-7b", "prefill_32k", {}),
    "dense-decode": ("qwen2-7b", "decode_32k", {}),
    "moe-spmd": ("olmoe-1b-7b", "train_4k", {}),
    "moe-smap": ("olmoe-1b-7b", "train_4k", {"moe_impl": "shard_map"}),
    "mla-fsdp": ("deepseek-v2-236b", "train_4k", {"fsdp": True}),
    "mamba1-fsdp": ("falcon-mamba-7b", "train_4k", {"fsdp": True}),
    "hybrid-decode": ("zamba2-2.7b", "decode_32k", {}),
    "encdec-prefill": ("seamless-m4t-medium", "prefill_32k", {}),
    "vlm-train": ("qwen2-vl-2b", "train_4k", {}),
    # the reference's variants (`launch.dryrun.VARIANTS`)
    "sp-prefill": ("qwen2-7b", "prefill_32k", {"sequence_parallel": True}),
    "tpx-sp-prefill": ("qwen2-7b", "prefill_32k",
                       {"tp_collectives": "explicit",
                        "sequence_parallel": True}),
    "smap-sp-prefill": ("olmoe-1b-7b", "prefill_32k",
                        {"moe_impl": "shard_map",
                         "sequence_parallel": True}),
    "sp-ep-prefill": ("olmoe-1b-7b", "prefill_32k",
                      {"sequence_parallel": True, "moe_expert_axis": "data",
                       "fsdp": False}),
    "ep-train": ("olmoe-1b-7b", "train_4k",
                 {"moe_expert_axis": "data", "fsdp": False}),
}
# the variant cases whose wire bytes `variant_differences` names
VARIANT_SERVING = ("sp-prefill", "tpx-sp-prefill", "smap-sp-prefill",
                   "sp-ep-prefill")


def _cfg(case: str):
    arch, _, changes = CASES[case]
    return dataclasses.replace(configs.get_config(arch, smoke=True),
                               **changes)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{case: the reference's FLOPs, wire bytes by op and shard shapes},
    compiled in one subprocess."""
    d = tmp_path_factory.mktemp("mesh_ref")
    src, dst = d / "cases.json", d / "ref.json"
    src.write_text(json.dumps({k: {"arch": a, "shape": s, "changes": c}
                               for k, (a, s, c) in CASES.items()}))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, os.path.join(
        REPO, "tests", "torch_mesh_reference.py"), str(src), str(dst)],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(dst.read_text())


_PORT: dict = {}


def port(case: str):
    """(StepCost, args) of rank (0, 0)'s step of `case` on the dry
    mesh."""
    if case not in _PORT:
        arch, cell, _ = CASES[case]
        fn, args, _ = dryrun.build_cell(
            arch, cell, make_dry_mesh(MESH), cfg=_cfg(case),
            specs=configs.input_specs(arch, cell, smoke=True))
        _PORT[case] = (analyze_step(fn, *args), args)
    return _PORT[case]


# ---------------------------------------------------------------- (a)

def _rows(case: str) -> tuple[int, int]:
    """(global rows, tokens a row) of the smoke cell."""
    arch, cell, _ = CASES[case]
    specs = configs.input_specs(arch, cell, smoke=True)
    return specs["tokens"].shape


def expert_capacity_gemm(case: str) -> float:
    """One routed-expert GEMM of a layer as the reference's chip runs
    it: its dense dispatch shards the (E, B x capacity, d) buffer over
    "model" by expert and keeps the capacity axis whole over "data"
    (`repro.models.moe.moe_ffn_apply`'s note: a data-sharded capacity
    lowers the token scatter as a cross-shard exchange), so each chip's
    GEMM is 2 (E/tp) (B x capacity) d f over the GLOBAL rows; the port's
    rank dispatches its own rows, 1/dp of that."""
    cfg = _cfg(case)
    B, S = _rows(case)
    return (2.0 * (cfg.n_experts // TP) * B * moe.capacity(cfg, S)
            * cfg.d_model * cfg.d_ff_expert)


def mla_fsdp_weight_grads(case: str) -> float:
    """Port only, mla_moe under FSDP: MLA's down projections cut over
    "data" on d (``w_dq``, ``w_dkv``, and ``w_kpe``, whose product the
    backward contracts twice) have their weight gradients computed whole
    over the rank's tokens, 2 T d n each, then reduce-scattered; GSPMD
    moves the activations (its all-to-all) and contracts each chip's d/dp
    rows, half of it at dp = 2. (1 - 1/dp) x 2 T d (q_lora + kv_lora + 2
    rope) a layer, T the rank's tokens."""
    cfg = _cfg(case)
    B, S = _rows(case)
    T = B // DP * S
    return ((1 - 1 / DP) * 2 * T * cfg.d_model
            * (cfg.q_lora_rank + cfg.kv_lora_rank + 2 * cfg.rope_head_dim)
            * cfg.n_layers)


def ref_only_flops(case: str) -> float:
    """The reference's FLOPs per chip the port's rank does not compute."""
    cfg = _cfg(case)
    if case == "sp-ep-prefill":
        # the forward's three expert GEMMs on the whole capacity buffer
        return 3 * cfg.n_layers * expert_capacity_gemm(case) * (1 - 1 / DP)
    if case in ("moe-spmd", "ep-train"):
        # the forward's three expert GEMMs and the backward's six, all on
        # the whole capacity buffer: (1 - 1/dp) of each is the reference's
        # alone
        return 9 * cfg.n_layers * expert_capacity_gemm(case) * (1 - 1 / DP)
    if case == "mla-fsdp":
        # under FSDP GSPMD keeps four of each layer's nine expert GEMMs
        # (the forward's three and one of the backward's) on the whole
        # buffer and data-parallelises the other five
        return 4 * cfg.n_layers * expert_capacity_gemm(case) * (1 - 1 / DP)
    if case == "mamba1-fsdp":
        # `test_torch_dryrun_ssm.mamba1_c_dot` (C . h as a dot), one rank's
        # share of the batch and of d_inner
        return mamba1_c_dot("falcon-mamba-7b", "train_4k") / (DP * TP)
    return 0.0


def port_only_flops(case: str) -> float:
    if case == "mla-fsdp":
        return mla_fsdp_weight_grads(case)
    if case == "sp-ep-prefill":
        # the router over the gathered sequence, where GSPMD routes the
        # chip's 1/tp of it: 2 (T - T/tp) d E a layer
        cfg = _cfg(case)
        B, S = _rows(case)
        T = B // DP * S
        return (cfg.n_layers * 2 * T * (1 - 1 / TP) * cfg.d_model
                * cfg.n_experts)
    return 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_dot_flops_equal_the_references_per_chip(case, reference):
    cost, _ = port(case)
    want = reference[case]["flops"]
    assert cost.flops - port_only_flops(case) + ref_only_flops(case) == want
    assert cost.gemm_flops > 0


# ---------------------------------------------------------------- (b)

def _wire(op: str, nbytes: float, group: int) -> float:
    return collective_wire(op, nbytes, group)


def _port_split(case: str) -> dict:
    """The port's {op: [tensor wire bytes, scalar wire bytes]} of rank
    (0, 0)'s step (a scalar sum: an operand of fewer than
    `torch_mesh_reference.SCALAR` elements)."""
    cost, _ = port(case)
    out: dict = {}
    for op, nbytes, group, _, n in cost.collective_log:
        out.setdefault(op, [0.0, 0.0])[n < SCALAR] += _wire(op, nbytes,
                                                            group)
    return out


def _fsdp_leaves(case: str) -> list:
    """[(name, whole-over-"data" bytes W, whether "model" cuts it)] of the
    rank's leaves FSDP cut over "data"."""
    _, args = port(case)
    cfg = _cfg(case)
    whole = {n: tuple(p.shape) for n, p in dryrun.get_model(cfg).init(
        cfg, None, device="meta").named_parameters()}
    out = []
    for n, p in args[0]["params"].named_parameters():
        ax = sharding.fsdp_leaf_axis(p)
        if ax is None:
            continue
        local = tuple(s * (DP if i == ax else 1)
                      for i, s in enumerate(p.shape))
        out.append((n, p.numel() * DP * p.element_size(),
                    local != whole[n]))
    return out


def _zero1_vectors(case: str) -> float:
    """The bytes of the rank's one-dimensional leaves "model" cuts (biases,
    Mamba's D, dt_bias and conv_b), FSDP's aside."""
    _, args = port(case)
    cfg = _cfg(case)
    whole = {n: tuple(p.shape) for n, p in dryrun.get_model(cfg).init(
        cfg, None, device="meta").named_parameters()}
    return sum(p.numel() * p.element_size()
               for n, p in args[0]["params"].named_parameters()
               if p.dim() == 1 and tuple(p.shape) != whole[n]
               and sharding.fsdp_leaf_axis(p) is None)


# extra input-gradient all-reduces a layer in the reference: each
# column-parallel product's share of its input's gradient reduced on its
# own (attention's q, k and v; a gated MLP's or MLA's shared expert's gate
# and up; MoE-by-shard_map's router and experts), where the port sums a
# block's shares and all-reduces once (`tp.copy_to_model`): (products - 1)
# per block (MLA's attention enters its latents, counted on its own below;
# GSPMD's MoE dispatch and Mamba1's one in_proj add none)
EXTRA_INPUT_GRADS = {"dense-train": 3, "vlm-train": 3, "moe-smap": 3,
                     "moe-spmd": 2, "mamba1-fsdp": 0, "mla-fsdp": 1,
                     "ep-train": 2}


def train_differences(case: str) -> list:
    """Every difference between the port's and the reference's collective
    wire bytes per chip in a training cell, op by op, from the config and
    the cell: [(what, op, port only, reference only)]. The reference's
    bytes are read from its HLO (`torch_mesh_reference.py`); each line
    names what the two steps post differently."""
    cfg = _cfg(case)
    arch, cell, _ = CASES[case]
    specs = configs.input_specs(arch, cell, smoke=True)
    B, S_text = specs["tokens"].shape
    S = specs["labels"].shape[1]
    rows = B // DP
    T, Tt = rows * S, rows * S_text
    d, L, E = cfg.d_model, cfg.n_layers, cfg.n_experts
    act = 4 if cfg.activation_dtype == "float32" else 2
    AG = lambda nb, g: _wire("all-gather", nb, g)      # noqa: E731
    AR = lambda nb, g: _wire("all-reduce", nb, g)      # noqa: E731
    RS = lambda nb, g: _wire("reduce-scatter", nb, g)  # noqa: E731
    A2A = lambda nb, g: _wire("all-to-all", nb, g)     # noqa: E731
    fsdp = _fsdp_leaves(case)
    out = [
        ("embedding lookup: the port all-gathers its rows of the "
         "vocab-cut table over 'model', the reference all-reduces the "
         "masked lookup (under FSDP on the global rows' d/dp columns, the "
         "same bytes)", "all-gather", AG(Tt * d * act, TP), 0.0),
        ("", "all-reduce", 0.0, AR(Tt * d * act, TP)),
        ("the lookup's ids, which the reference's scatter-add gathers "
         "over 'model' and moves across the (data, model) transpose",
         "all-gather", 0.0, AG(Tt * 4, TP)),
        ("", "collective-permute", 0.0, Tt * 4),
        ("accuracy's argmax over the vocab shards: the port all-reduces "
         "each token's index (int64) after its max, the reference "
         "all-gathers each shard's (max, index) pair", "all-reduce",
         AR(T * 8, TP), 0.0),
        ("", "all-gather", 0.0, 2 * AG(T * 4, TP)),
        ("the embedding gradient: the reference moves each rank's "
         "cotangent rows to the table's 'data' halves", "all-to-all", 0.0,
         A2A(Tt * d * act, DP)),
        ("ZeRO-1 of a vector 'model' cuts: the reference cuts the stacked "
         "(L, n) leaf on its layer axis, the port's per-layer leaf has no "
         "free axis", "all-gather", 0.0,
         AG(_zero1_vectors(case) / DP, DP)),
        ("input gradients reduced per product (`EXTRA_INPUT_GRADS`)",
         "all-reduce", 0.0,
         L * EXTRA_INPUT_GRADS[case] * AR(T * d * act, TP)),
    ]
    if not fsdp:
        out.append(("the embedding gradient: the port all-reduces the "
                    "table's over 'data'", "all-reduce",
                    AR(cfg.vocab // TP * d * 4, DP), 0.0))
    else:
        blocks = [(n, W, cut) for n, W, cut in fsdp
                  if n.startswith("blocks.")]
        spmd_experts = cfg.kind in ("moe", "mla_moe") and \
            cfg.moe_impl == "spmd"
        reduced = [(n, W, cut) for n, W, cut in blocks
                   if not (spmd_experts and ".experts." in n)]
        head = [W for n, W, _ in fsdp
                if n == ("embed.table" if cfg.tie_embeddings else "head.w")]
        uses = {"embed.table": 2 if cfg.tie_embeddings else 1}
        out += [
            ("FSDP's gradients: the port reduce-scatters each use's over "
             "'data'", "reduce-scatter",
             sum(uses.get(n, 1) * RS(W, DP) for n, W, _ in fsdp), 0.0),
            ("FSDP: GSPMD gathers each block leaf again for the backward "
             "(the port's autograd keeps the gathered leaf)", "all-gather",
             0.0, sum(AG(W / DP, DP) for _, W, _ in blocks)),
            ("FSDP: GSPMD all-reduces a leaf's gradient over 'data' once: "
             "the head's; a block leaf's whole where 'model' cuts it, at "
             "its 'data' block where not (MLA's down projections, the "
             "router); the embedding's goes by the cotangent rows",
             "all-reduce", 0.0,
             sum(AR(W, DP) for W in head)
             + sum(AR(W if cut else W / DP, DP) for _, W, cut in reduced)),
            ("FSDP: the lookup from the table cut on d: GSPMD looks up its "
             "d-half for the global rows and moves them to the rank's",
             "all-to-all", 0.0, A2A(T * d * act, DP)),
            ("FSDP: a block leaf 'model' does not cut is moved across the "
             "(data, model) transpose before its gather over 'model', once "
             "in the forward and twice in the backward",
             "collective-permute", 0.0,
             3 * sum(W / DP for _, W, cut in blocks if not cut)),
        ]
    ep = cfg.moe_expert_axis == "data"
    if cfg.kind in ("moe", "mla_moe") and cfg.moe_impl == "spmd":
        C = rows * moe.capacity(cfg, S)
        Et = E // TP
        W_e = Et * d * cfg.d_ff_expert * 4
        grad = RS if fsdp else AR
        out += [
            ("MoE dispatch: the port gathers the experts' outputs and "
             "their input gradient over 'model' (experts over 'data': "
             "none), GSPMD all-reduces the combine over 'model' on the "
             "global rows, forward and backward", "all-gather",
             0.0 if ep else 2 * L * AG(Et * C * d * act, TP), 0.0),
            ("", "all-reduce", 0.0, 2 * L * AR(B * S * d * act, TP)),
            ("MoE routing over the global capacity buffer: the reference "
             "gathers the router logits and the top-k ids over 'data' and "
             "all-reduces the slot counts", "all-gather", 0.0,
             L * (AG(T * E * 4, DP) + AG(T * cfg.top_k * 4, DP))),
            ("", "all-reduce", 0.0, L * AR(B * S * cfg.top_k * 4, DP)),
            ("expert gradients: the port reduces each expert weight's over "
             "'data' (experts over 'data': whole after the exchange), "
             "GSPMD the capacity buffer's two cotangents (dispatch and "
             "combine) and computes the weights' whole",
             "reduce-scatter" if fsdp else "all-reduce",
             0.0 if fsdp or ep else 3 * L * grad(W_e, DP), 0.0),
            ("", "all-reduce", 0.0,
             2 * L * AR(Et * B * moe.capacity(cfg, S) * d * act, DP)),
            ("the aux loss's per-expert sums over 'data': the port's "
             "counts are int64", "all-reduce", L * AR(E * (4 + 8), DP),
             L * AR(E * 2 * 4, DP)),
        ]
    if ep:
        out += [
            ("experts over 'data': the port sends each expert block of "
             "the rows' dispatch buffer to its owner and the outputs back, "
             "and their cotangents the same way (four all-to-alls a "
             "layer); GSPMD keeps the global capacity buffer",
             "all-to-all",
             4 * L * A2A(E * rows * moe.capacity(cfg, S) * d * act, DP),
             0.0),
            ("experts over 'data', d_ff over 'model': the port sums the "
             "f32 partial output over 'model' and, in the backward, its "
             "d_ff blocks' shares of the tokens' and routing logits' "
             "gradients", "all-reduce",
             L * (AR(T * d * 4, TP) + AR(T * d * act, TP)
                  + AR(T * E * 4, TP)), 0.0),
            ("ZeRO-1 of the experts: the reference's compiled cell holds "
             "them (E/tp, d, f) over 'model' (`test_local_shapes_are_the_"
             "references_shard_shapes`), cuts their state over 'data' and "
             "gathers the updated params; the port's experts are cut over "
             "'data' already, their state with them", "all-gather", 0.0,
             3 * L * AG(E // TP * d * cfg.d_ff_expert * 4 // DP, DP)),
        ]
    if case == "moe-smap":
        r = d * E * 4
        out.append(("the router's gradient: the port all-reduces it over "
                    "'model' then 'data', the reference over all four "
                    "chips at once", "all-reduce",
                    L * (AR(r, TP) + AR(r, DP)), L * AR(r, TP * DP)))
    if cfg.kind == "mamba1":
        di = cfg.expand * d // TP
        out += [
            ("Mamba1's in_proj output [x | z]: GSPMD cuts it in halves over "
             "'model', so its split moves each rank's other part "
             "(collective-permutes) and the backward's concatenate "
             "exchanges them (all-to-alls); the port cuts x and z each "
             "(`sharding.axis_parts`)", "collective-permute", 0.0,
             2 * L * T * di * act),
            ("", "all-to-all", 0.0, 2 * L * T * di * act),
        ]
    if cfg.kind == "mla_moe":
        out.append(("MLA's latent c_kv feeds two column-parallel products "
                    "(w_uk, w_uv): the reference reduces each one's share "
                    "of its gradient on its own", "all-reduce", 0.0,
                    L * AR(T * cfg.kv_lora_rank * act, TP)))
    return out


def embedding_and_logits(case: str) -> tuple[float, float]:
    """(embedding, logits) wire bytes of a serving cell: the port's
    vocab-sharded lookup all-gathers each rank's masked rows (B S d
    activation bytes x (tp - 1)) where the reference all-reduces the
    masked lookup (2 B S d (tp - 1)/tp: the same bytes at tp = 2); the
    port all-gathers its f32 logit columns (B V/tp x 4 x (tp - 1)), the
    reference returns them sharded."""
    cfg = _cfg(case)
    arch, cell, _ = CASES[case]
    specs = configs.input_specs(arch, cell, smoke=True)
    B = (specs["token"] if "token" in specs else specs["tokens"]).shape[0]
    S = 1 if "token" in specs else specs["tokens"].shape[1]
    act = 4 if cfg.activation_dtype == "float32" else 2
    rows = B // DP
    return (rows * S * cfg.d_model * act * (TP - 1),
            rows * cfg.vocab // TP * 4 * (TP - 1))


SERVING = ("dense-prefill", "dense-decode", "encdec-prefill",
           "hybrid-decode")


def variant_differences(case: str) -> list:
    """Every difference between the port's and the reference's collective
    wire bytes per chip in a sequence-parallel prefill cell
    (`VARIANT_SERVING`), op by op, from the config and the cell: [(what,
    op, port only, reference only)], as `train_differences`. GSPMD on the
    CPU lowers a sequence-parallel reduce-scatter point as an all-reduce
    and a slice, and for olmoe-1b-7b keeps the attention on the sequence
    shard (gathering the weights and the keys) where the port gathers
    the sequence."""
    cfg = _cfg(case)
    arch, cell, _ = CASES[case]
    B, S = configs.input_specs(arch, cell, smoke=True)["tokens"].shape
    rows = B // DP
    T = rows * S
    d, L, E, K = cfg.d_model, cfg.n_layers, cfg.n_experts, cfg.top_k
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    act = 4 if cfg.activation_dtype == "float32" else 2
    AG = lambda nb, g: _wire("all-gather", nb, g)      # noqa: E731
    AR = lambda nb, g: _wire("all-reduce", nb, g)      # noqa: E731
    RS = lambda nb, g: _wire("reduce-scatter", nb, g)  # noqa: E731
    A2A = lambda nb, g: _wire("all-to-all", nb, g)     # noqa: E731
    emb, logits = embedding_and_logits(case)
    block = AG(T // TP * d * act, TP)         # one gather of the sequence
    out = [
        ("the embedding and the logits (`embedding_and_logits`)",
         "all-gather", emb + logits, 0.0),
        ("", "all-reduce", 0.0, emb),
        ("the last position's row: the port gathers the sequence before "
         "the head, GSPMD moves the last block's row (a permute) and "
         "reduces it over 'model'", "all-gather", block, 0.0),
        ("", "collective-permute", 0.0, rows * d * act),
        ("", "all-reduce", 0.0, AR(rows * d * act, TP)),
        ("attention's wo: the port reduce-scatters its partial sums to "
         "the sequence block, GSPMD all-reduces them", "reduce-scatter",
         L * RS(T * d * act, TP), 0.0),
    ]
    if cfg.kind == "dense":
        out += [("the MLP's w_down: the same", "reduce-scatter",
                 L * RS(T * d * act, TP), 0.0),
                ("", "all-reduce", 0.0,
                 2 * L * AR(T * d * act, TP))]
        return out
    out += [
        ("attention on the sequence shard: GSPMD gathers wq, wk, wv and "
         "wo's 'model' blocks and the keys' sequence where the port "
         "gathers the block's input", "all-gather", L * block,
         L * (4 * AG(d * H * hd // TP * act, TP)
              + AG(rows * S // TP * KV * hd * act, TP))),
        ("GSPMD's split-key attention: the softmax's max and sum and "
         "the probabilities-times-values partial sums reduced over "
         "'model'", "all-reduce", 0.0,
         L * (2 * AR(rows * H * S * 4, TP)
              + AR(rows * H * hd * S * act, TP))),
        ("the MoE's f32 partial output: the port reduce-scatters it, "
         "GSPMD all-reduces it (shard_map's psum)", "reduce-scatter",
         L * RS(T * d * 4, TP), 0.0),
    ]
    if cfg.moe_impl == "shard_map" and cfg.moe_expert_axis != "data":
        out.append(("", "all-reduce", 0.0, L * AR(T * d * 4, TP)))
        return out
    C = rows * moe.capacity(cfg, S)
    out += [
        ("experts over 'data': the port sends each expert block of the "
         "rows' dispatch buffer to its owner and the outputs back",
         "all-to-all", 2 * L * A2A(E * C * d * act, DP), 0.0),
        ("the aux loss's per-expert sums over 'data' (int64 counts, f32 "
         "probabilities), which GSPMD's prefill drops", "all-reduce",
         L * AR(E * (8 + 4), DP), 0.0),
        ("GSPMD's dense dispatch over the global capacity buffer: the "
         "block's input gathered by the shard_map-less MoE over 'model' "
         "(the port's gather before the MoE) against the data shard's "
         "tokens over 'data', the chip's 1/tp routing logits and top-k "
         "ids over all chips, the tokens' ids twice over 'data'",
         "all-gather", L * block,
         L * (AG(T * d * act, DP) + AG(T // TP * E * 4, TP * DP)
              + AG(T // TP * K * 4, TP * DP) + 2 * AG(T * K * 4, DP))),
        ("GSPMD's dense dispatch: the global slot counts over all chips, "
         "the capacity buffer's expert block over 'data' and the "
         "combine over 'model' on the global rows", "all-reduce", 0.0,
         L * (AR(B * S * K * 4, TP * DP)
              + AR(E // TP * B * moe.capacity(cfg, S) * d * act, DP)
              + AR(B * S * d * act, TP))),
    ]
    return out


def mamba2_relayout_bound(case: str) -> float:
    """A bound on the bytes GSPMD moves to re-lay a Mamba2 layer's
    concatenated in_proj output [z | x | B C | dt] and conv history from
    its contiguous halves over 'model' to the parts the port cuts
    (`sharding.axis_parts`): the rank's in_proj output row and conv
    channels, a row and a layer."""
    cfg = _cfg(case)
    di = cfg.expand * cfg.d_model
    bc = 2 * cfg.ssm_ngroups * cfg.ssm_state
    heads = di // cfg.ssm_headdim
    n_mamba = cfg.n_layers
    arch, cell, _ = CASES[case]
    rows = configs.input_specs(arch, cell, smoke=True)["token"].shape[0] // DP
    return rows * n_mamba * 4 * ((2 * di + bc + heads) + (di + bc))


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_bytes_by_op(case, reference):
    """Per op, the port's collective wire bytes minus what only it posts
    plus what only the reference posts equal the reference's, each term
    named (`train_differences`, `embedding_and_logits`); scalar sums (the
    loss's parts, the metrics, the global norm's square sums: XLA reduces
    one per leaf and axis, the port one norm) are kept apart and each
    side's held under 4 bytes a leaf plus 32."""
    cost, _ = port(case)
    got = _port_split(case)
    want = reference[case]["wire_split"]
    assert cost.collective_bytes == sum(sum(v) for v in got.values())
    n_leaves = len(list(dryrun.get_model(_cfg(case)).init(
        _cfg(case), None, device="meta").parameters()))
    for op in set(got) | set(want):
        assert got.get(op, [0, 0])[1] <= 4 * n_leaves + 32, op
        assert want.get(op, [0, 0])[1] <= 4 * n_leaves + 32, op
    tensor = {op: v[0] for op, v in got.items()}
    ref = {op: v[0] for op, v in want.items() if v[0]}
    if case in VARIANT_SERVING:
        for what, op, port_only, ref_only in variant_differences(case):
            tensor[op] = tensor.get(op, 0.0) - port_only + ref_only
        assert {op: v for op, v in tensor.items() if v} == ref
        return
    if case in SERVING:
        emb, logits = embedding_and_logits(case)
        assert tensor["all-gather"] == emb + logits
        assert tensor["all-reduce"] + emb == ref["all-reduce"]
        relayout = sum(v for op, v in ref.items() if op != "all-reduce")
        if case == "hybrid-decode":
            # GSPMD's re-layout of Mamba2's concatenated leaves (its
            # all-gathers, all-to-alls and collective-permutes): named and
            # bounded; the port posts none of them
            assert 0 < relayout <= mamba2_relayout_bound(case)
        else:
            assert set(ref) == {"all-reduce"}
        return
    for what, op, port_only, ref_only in train_differences(case):
        tensor[op] = tensor.get(op, 0.0) - port_only + ref_only
    assert {op: v for op, v in tensor.items() if v} == ref
    assert cost.collective_bytes > 0


# ---------------------------------------------------------------- (c)

def _ref_path(name: str) -> str:
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _divisors(global_shape, local) -> tuple:
    return tuple(g // n for g, n in zip(global_shape, local))


def _departures(case: str) -> dict:
    """{leaf: its `dryrun.departures` entry} of the case's rank."""
    cost, args = port(case)
    arch, cell, _ = CASES[case]
    specs = configs.input_specs(arch, cell, smoke=True)
    mesh = make_dry_mesh(MESH)
    _, want = dryrun.local_specs(cell, mesh, specs, _cfg(case))
    params, inputs = _params_inputs(case, args)
    return {d["leaf"]: d for d in dryrun.departures(params, _cfg(case),
                                                    mesh, inputs, want)}


def _params_inputs(case: str, args: tuple):
    step = configs.SHAPE_DEFS[CASES[case][1]]["step"]
    if step == "train":
        return args[0]["params"], args[1]
    if step == "prefill":
        return args
    return args[0], {"token": args[1], "state": args[2]}


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_shapes_are_the_references_shard_shapes(case, reference):
    """Every leaf's local shape is the reference's shard shape, but the
    departures the rank names, whose ``reference`` is the shard shape of
    the reference's compiled cell. Under ``moe_expert_axis="data"`` they
    are the experts: the port cuts E over "data" and d_ff over "model" as
    the reference's rules say, while its compiled cell holds them (E/tp,
    d, f) over "model" (`param_pspecs` calls ``set_mesh_rules(mesh,
    fsdp)`` for each leaf, which puts the rules' expert axis back to
    "model")."""
    _, args = port(case)
    params, inputs = _params_inputs(case, args)
    departed = _departures(case)
    ref = reference[case]
    cfg = _cfg(case)
    whole = {n: tuple(p.shape) for n, p in dryrun.get_model(
        cfg).init(cfg, None, device="meta").named_parameters()}
    checked = 0
    for name, p in params.named_parameters():
        g, s = ref["params"][_ref_path(name)]
        n = len(p.shape)
        experts = cfg.moe_expert_axis == "data" and ".experts." in name
        dep = departed.get(dryrun._layer_name(name))
        assert dep is not None or not experts, name
        if dep is not None:
            assert tuple(dep["reference"]) == tuple(s[-n:]), name
            assert tuple(dep["port"]) == tuple(p.shape), name
            if experts:
                ff = 2 if name.endswith(("w_gate", "w_up")) else 1
                assert tuple(p.shape) == tuple(
                    m // (DP if i == 0 else TP if i == ff else 1)
                    for i, m in enumerate(whole[name])), name
                assert dep["reason"] == dryrun.EXPERTS_RESET, name
            continue
        assert tuple(s[-n:]) == tuple(p.shape), name
        assert tuple(g[-n:]) == whole[name], name
        checked += 1
    assert checked > 0
    arch, cell, _ = CASES[case]
    specs = _flat(configs.input_specs(arch, cell, smoke=True))
    for path, t in _flat(inputs).items():
        if path in departed or path not in ref["inputs"]:
            continue
        g, s = ref["inputs"][path]
        if len(g) != t.dim():       # the port's per-row index (configs)
            continue
        assert _divisors(specs[path].shape, t.shape) == _divisors(g, s), path


def test_departures_are_empty_at_smoke_and_name_whole_heads():
    """At smoke size tp = 2 divides every head count: no departure. On
    the production mesh qwen2-7b's 28 query and 4 KV heads stay whole on
    a rank of tp = 16 where the reference shards their columns, and its
    cache's sequence, which the reference cuts over "model", stays
    whole."""
    for case in ("dense-decode", "mla-fsdp", "vlm-train"):
        assert _departures(case) == {}
    mesh = dryrun.make_production_mesh()
    cfg = configs.get_config("qwen2-7b")
    specs = configs.input_specs("qwen2-7b", "decode_32k")
    local, want = dryrun.local_specs("decode_32k", mesh, specs, cfg)
    assert local["state"]["kv"]["k"].shape == (28, 8, 32768, 4, 128)
    assert want["state"]["kv"]["k"] == (28, 8, 2048, 4, 128)
    assert sharding.reference_shape("blocks/0/attn/wq", (3584, 3584),
                                    mesh.shape) == (3584, 224)
    assert sharding.leaf_axis("blocks/0/attn/wq", (3584, 3584), 16,
                              "psum", cfg) is None


# ---------------------------------------------------------------- (d)

@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240, threads=1) as p:
        yield p


@pytest.mark.parametrize("case", sorted(CASES))
def test_counted_equals_posted(case, pool):
    """Each of four gloo ranks posts, op for op, the calls and operand
    bytes rank (0, 0)'s dry step counts."""
    cost, _ = port(case)
    arch, cell, changes = CASES[case]
    dry = {op: {"calls": calls, "bytes": cost.collective_operand_bytes[op]}
           for op, calls in cost.collective_calls.items()}
    for out in pool.run(R.posted, MESH, arch, cell, changes):
        assert out == dry


def test_reduce_scatter_is_this_ranks_block_of_the_sum(pool):
    """`tp._reduce_scatter_` (FSDP's gradient) gives each rank its block
    of the four ranks' sum (f32, within 1e-6: the backend may add them in
    another order), counted as one reduce-scatter of the whole operand."""
    ranks = pool.run(R.reduce_scatter_block, 3)
    whole = sum(r["whole"] for r in ranks)
    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(out["block"],
                                   whole[:, 2 * rank:2 * rank + 2],
                                   rtol=1e-6, atol=1e-6)
        assert out["by_op"] == {
            "reduce-scatter": {"calls": 1, "bytes": 6 * 8 * 3 * 4}}


# ---------------------------------------------------------------- (e)

def test_heads_tp_does_not_divide_give_tp1s_logits_and_loss(pool):
    """qwen2-7b's smoke config with 2 query heads and 1 KV head at tp = 4
    (heads whole on every rank, the FFN and vocab sharded) against tp = 1:
    logits within the whole-model 1e-4, the loss within f32's 1e-5."""
    changes = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 16}
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 32)).astype(np.int32)}
    one = pool.run(R.logits_and_loss, (1, 1), "qwen2-7b", changes, batch)[0]
    four = pool.run(R.logits_and_loss, (1, 4), "qwen2-7b", changes, batch)
    for out in four:
        assert out["whole"] == one["whole"]        # wq whole: (64, 32)
        np.testing.assert_allclose(out["logits"], one["logits"],
                                   rtol=1e-4, atol=1e-4)
        assert abs(out["loss"] - one["loss"]) <= 1e-5 * max(
            1.0, abs(one["loss"]))


# ---------------------------------------------------------------- copies

@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_logical_to_mesh_and_dp_axes_are_the_references(names):
    """`sharding.logical_to_mesh` and `launch.mesh.dp_axes` against the
    reference's `_logical_to_mesh` and `dp_axes` on an abstract mesh of
    each production layout, under both FSDP settings and expert axes."""
    sizes = (2, 16, 16)[-len(names):]
    jmesh = jax.sharding.AbstractMesh(sizes, names)
    mesh = make_production_mesh(len(names) == 3)
    assert mesh.shape == dict(zip(names, sizes if len(names) == 3
                                  else (16, 16)))
    assert dp_axes(mesh) == jsharding.dp_axes(jmesh)
    logical = ("batch", "model", "fsdp", "seq_shard", "seq_tp", "expert",
               "fsdp_or_tp", "tp_if_ep_data", None, "other")
    try:
        for fsdp in (False, True):
            for expert in ("model", "data"):
                jsharding.set_mesh_rules(jmesh, fsdp, expert)
                for name in logical:
                    assert (sharding.logical_to_mesh(name, names, fsdp,
                                                     expert)
                            == jsharding._logical_to_mesh(name, jmesh)), (
                        name, fsdp, expert)
    finally:
        jsharding.set_mesh_rules(None)


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_ring_formulas_are_the_references(op, group):
    """`collective_wire` against `hloanalyze._collective_wire` on one
    instruction of a 1024-element f32 operand over groups of `group`."""
    ins = hloanalyze.Instr(
        name="c", opcode=op, result="f32[1024]{0}", args="f32[1024]{0} %x",
        attrs=f"replica_groups=[{32 // group},{group}]<=[32]", line="")
    assert collective_wire(op, 4096, group) == hloanalyze._collective_wire(
        ins, 32, {})
