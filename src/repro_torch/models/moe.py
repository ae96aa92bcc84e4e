"""Mixture-of-experts blocks: OLMoE-style (top-8 of 64) and DeepSeek-V2
(multi-head latent attention + 2 shared + 160 routed top-6 experts).

The counterpart of the JAX package's `repro.models.moe` at tp=1. Routing is
dense dispatch with a per-row capacity: tokens are ranked within their
(row, expert) group and scattered into a static (E, B * capacity, d)
buffer, the experts run as batched einsums over that buffer, and a
Switch-style load-balancing loss comes back beside the output. The router,
the shared experts and every MLA projection go through `ops.matmul` (the
hand-written GEMM on the card); the expert einsums and the attention are
plain PyTorch, as the JAX package leaves them to XLA.

Two reductions are written out in a fixed order so that a row's result
never depends on how many rows share the call (the batch-composition
independence per-row capacity exists for): the gate-weighted sum over a
token's top-k experts, and the top-k itself (a stable descending sort, so
ties go to the lower expert index as ``jax.lax.top_k`` sends them).

Under tensor parallelism the experts are E-sharded and the router
replicated. In the dense-dispatch path (`moe_ffn_apply`, the JAX
package's at tp=1 and in gather mode) every rank routes every token, runs
its own experts' slots and all-gathers their outputs (`_experts`; in
training the gather's backward is this rank's block and the dispatch
buffer's split gathers its gradient). The explicit expert-parallel path
(`moe_ffn_shard_map`, ``moe_impl="shard_map"`` on a training mesh) keeps
only this rank's experts' slots and sums the partial outputs over
"model". MLA holds its rank's heads: w_uq's whole heads
(column-parallel), w_uk's and w_uv's head columns (the decompression of
the replicated latent cache, column-parallel) and wo (gathered in gather
mode, summed in psum mode); the latent cache, w_dq, w_dkv and w_kpe stay
whole on every rank, and in psum mode their outputs enter the sharded
heads through `tp.enter`. Under sequence parallelism the blocks take this
rank's block of the sequence and gather it before attention and the FFN
(`transformer.dense_block_apply`); each MoE path's output goes back to the
block (a cut, or the partial sum reduce-scattered). Experts over "data"
(``moe_expert_axis="data"``, `moe_ffn_ep_data`) send their tokens to the
experts' owners by an all-to-all over "data" and cut d_ff over "model".
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import current_mesh
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Mapping


# ---------------- routing and dispatch ----------------

def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, largest
    first and, among equal values, the lower index first (what
    ``jax.lax.top_k`` returns; `torch.topk` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Expert slots per batch row: ``max(1, int(cf * S * K / E))``, from the
    row's own length S, never from the batch."""
    return max(1, int(cfg.capacity_factor * seq_len * cfg.top_k
                      / cfg.n_experts))


def route(logits: torch.Tensor, cfg: ModelConfig, n_rows: int) -> dict:
    """Top-k routing and slot assignment of T = n_rows * S tokens from
    their (T, E) f32 router logits.

    Returns {"probs" (T, E), "idx" (T*K,) expert ids, "slot" (T*K,) slots
    in the (E, n_rows * capacity) buffer, "keep" (T*K,) bool, "gate" (T*K,)
    renormalised gate values, zero where dropped, "capacity"}. Tokens take
    an expert's slots of their own row first come, first served; the ones
    past the row's capacity are dropped. Nothing here waits on the host."""
    T, E = logits.shape
    K = cfg.top_k
    S = T // n_rows
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                         # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = capacity(cfg, S)
    TK = T * K
    idx = gate_idx.reshape(TK)
    row = torch.div(torch.arange(TK, device=dev), S * K,
                    rounding_mode="floor")
    grp = row * E + idx                                           # (row, e)
    order = torch.argsort(grp, stable=True)
    sorted_grp = grp[order]
    start = torch.searchsorted(sorted_grp,
                               torch.arange(n_rows * E, device=dev))
    pos = torch.empty_like(idx)
    pos[order] = torch.arange(TK, device=dev) - start[sorted_grp]
    keep = pos < cap
    slot = row * cap + torch.where(keep, pos, 0)
    gate = gate_vals.reshape(TK) * keep.to(gate_vals.dtype)
    return {"probs": probs, "idx": idx, "slot": slot, "keep": keep,
            "gate": gate, "capacity": cap}


# ---------------- the MoE FFN ----------------

def _expert_ffn(w: Params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over a dispatch buffer (E', C, d) of the
    experts `w` holds (E', d, f)."""
    g = torch.einsum("ecd,edf->ecf", xe, w["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xe, w["w_up"])
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.einsum("ecf,efd->ecd", h, w["w_down"])


def _experts(w: Params, xe: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """The experts' SwiGLU over the dispatch buffer xe (E, C, d) -> (E, C,
    d). Under tensor parallelism the experts are E-sharded (the rank holds
    E/tp of them, `sharding.PARAM_RULES`' "expert" axis): each rank runs
    its own experts' slots and the outputs are all-gathered on E before the
    unchanged combine, never summed across ranks (the JAX package's
    reason, `moe.py` `moe_ffn`: a psum would re-associate the fp32 sum).
    In training the buffer, whole on every rank, is split (`tp.
    split_to_model`: its gradient gathered) and the outputs gathered
    (`tp.gather_from_model`: their gradient this rank's block). Under
    `sp` each rank's gradient of the outputs is its rows' share: the
    buffer is cut with its gradient zero outside the rank's experts
    (`tp.sequence_block`) and the outputs gathered with their gradient
    reduce-scattered (`tp.gather_from_sequence` on E)."""
    e_loc = w["w_gate"].shape[0]
    if e_loc == xe.shape[0]:
        return _expert_ffn(w, xe)
    if torch.is_grad_enabled() and (xe.requires_grad
                                    or w["w_gate"].requires_grad):
        if sp:
            return TP.gather_from_sequence(
                _expert_ffn(w, TP.sequence_block(xe, 0)), 0)
        return TP.gather_from_model(
            _expert_ffn(w, TP.split_to_model(xe, 0)), 0)
    xe = xe.narrow(0, current_mesh().rank * e_loc, e_loc)
    return TP.all_gather(_expert_ffn(w, xe), 0)


def _aux_loss(cfg: ModelConfig, idx: torch.Tensor, probs: torch.Tensor,
              n_tokens: int, sp_rows: int = 0) -> torch.Tensor:
    """The Switch-transformer load-balancing loss of `n_tokens` tokens
    routed to experts `idx` (T*K,) with router probabilities `probs`
    (T, E): integer counts, exact in f32 (a static-shape count, which a
    meta tensor can take: bincount's output size depends on the data).
    On a mesh with a data axis of more than one rank the counts and the
    probabilities' sums are the whole batch's (summed over "data"), as
    the reference's global dense path computes them. Under sequence
    parallelism (`sp_rows`, the batch rows of the whole sequences every
    rank routes) the probabilities pass their gradient only within this
    rank's block of each row (`tp.sequence_share`)."""
    E, K = cfg.n_experts, cfg.top_k
    if sp_rows:
        probs = TP.sequence_share(probs.reshape(sp_rows, -1, E)
                                  ).reshape(-1, E)
    counts = torch.zeros(E, dtype=torch.long, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))
    data = TP.data_size()
    if data == 1:
        mean = probs.mean(0)
    else:
        counts = TP.all_reduce_data(counts)
        n_tokens *= data
        mean = TP.reduce_over_data(probs.sum(0)) / n_tokens
    density = counts.float() / (n_tokens * K)
    return cfg.router_aux_coef * E * torch.sum(density * mean)


def _combine(y_tok: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """The sum over each token's K expert outputs (TK, d) -> (T, d), in a
    fixed order for every row."""
    y_tok = y_tok.reshape(T, K, -1)
    out = y_tok[:, 0]
    for j in range(1, K):
        out = out + y_tok[:, j]
    return out


def moe_ffn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  sp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, d), aux loss). `p` holds ``router.w`` (d, E),
    ``experts.{w_gate, w_up}`` (E, d, f) and ``experts.w_down`` (E, f, d),
    and ``shared_mlp`` when the config has shared experts.

    Dispatch scatters each kept token into its expert's slot of an f32
    (E, B * capacity, d) buffer with ``index_put_(accumulate=True)``: a
    kept token owns its slot, and only the zeros of dropped tokens (sent to
    their row's slot 0) ever land beside it, so the sum is exact.

    Under `sp` (`x` the gathered sequence) every rank routes and combines
    every token as before and its output is cut to its block of the
    sequence with no collective (`tp.sequence_block`): each rank's
    gradient is then its block's share, gathered into the experts by
    `_experts` and into the router by the gates and the aux loss."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    logits = ops.matmul(xt, p["router"]["w"], out_dtype=torch.float32)
    r = route(logits, cfg, B)
    idx, slot, keep = r["idx"], r["slot"], r["keep"]
    contrib = torch.where(keep[:, None],
                          xt.repeat_interleave(K, dim=0).float(), 0.0)
    xe = torch.zeros((E, B * r["capacity"], d), dtype=torch.float32,
                     device=x.device)
    xe.index_put_((idx, slot), contrib, accumulate=True)
    xe = xe.to(x.dtype)

    ye = _experts(p["experts"], xe, sp)                           # (E, C, d)

    out = _combine(ye[idx, slot].float() * r["gate"][:, None], T, K)
    out = out.to(x.dtype).reshape(B, S, d)
    if sp:
        out = TP.sequence_block(out)
    if "shared_mlp" in p:
        f = cfg.d_ff_expert * cfg.n_shared_experts
        out = out + L.swiglu_apply(p["shared_mlp"], x if sp else xt, cfg, f,
                                   sp=sp).reshape(out.shape)
    aux = _aux_loss(cfg, idx, r["probs"], T, B if sp else 0)
    return out, aux


def moe_ffn_shard_map(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      sp: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's explicit expert-parallel MoE (`moe_ffn_shard_map`,
    its `_local_dispatch`) on the current (data, model) mesh: this rank's
    tokens (the batch is cut over "data" by the train step) whole on
    every "model" rank, its E/tp experts, and one all-reduce of the
    partial outputs over "model". Every rank routes every one of its
    tokens (capacity per row of its rows, so data sharding changes no
    routing), dispatches only the slots of its own experts, runs them and
    the shared experts' column block, and sums the gate-weighted outputs
    of its experts into an f32 partial, which `tp.reduce_from_model`
    completes. Returns (out, aux): aux is each data shard's own
    load-balancing loss averaged over "data" (the reference's ``pmean``
    over data, then over model, where it is the same on every rank) — not
    the dense path's whole-batch aux when data > 1.

    The tokens enter the partial region through `tp.copy_to_model` (each
    rank's gradient of them is its experts' share); the router is whole
    and used partially by each rank, so its logits enter there too, while
    the aux loss, the same on every rank, reads them as they are: the
    router's gradient is then summed over "model" (the reference's
    shard_map sums a replicated input's cotangent).

    Under `sp` (`x` the gathered sequence, whose gradient is
    reduce-scattered) nothing enters through a copy, the aux loss's
    probabilities pass their gradient within this rank's block of the
    sequence, and the f32 partial sum is reduce-scattered to the block
    (`tp.scatter_to_sequence`)."""
    mesh = current_mesh()
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    w = p["experts"]
    e_loc = w["w_gate"].shape[0]
    tp = mesh.tp
    if e_loc * tp != E:
        raise ValueError(f"moe_impl='shard_map' needs n_experts={E} "
                         f"divisible by the model axis, {tp}")
    xt = x.reshape(T, d)
    logits = ops.matmul(xt, p["router"]["w"], out_dtype=torch.float32)
    if tp > 1 and not sp:
        xt_in, lg = TP.copy_to_model(xt), TP.copy_to_model(logits)
    else:
        xt_in, lg = xt, logits
    r = route(lg, cfg, B)
    idx, slot, keep, cap = r["idx"], r["slot"], r["keep"], r["capacity"]
    rel = idx - mesh.rank * e_loc
    mine = (rel >= 0) & (rel < e_loc)
    rel = rel.clamp(0, e_loc - 1)
    contrib = torch.where((keep & mine)[:, None],
                          xt_in.repeat_interleave(K, dim=0).float(), 0.0)
    xe = torch.zeros((e_loc, B * cap, d), dtype=torch.float32,
                     device=x.device)
    xe.index_put_((rel, slot), contrib, accumulate=True)
    ye = _expert_ffn(w, xe.to(x.dtype))
    y_tok = torch.where(mine[:, None], ye[rel, slot].float(), 0.0)
    partial = _combine(y_tok * r["gate"][:, None], T, K)
    if "shared_mlp" in p:
        sm = p["shared_mlp"]
        f = cfg.d_ff_expert * cfg.n_shared_experts
        u = TP.tp_column(xt_in, sm["w_up"], cfg, f)
        g = TP.tp_column(xt_in, sm["w_gate"], cfg, f)
        h = F.silu(g.float()).to(x.dtype) * u
        partial = partial + ops.matmul(h, sm["w_down"]).float()
    if sp:
        out = TP.scatter_to_sequence(partial.reshape(B, S, d), 1, mesh)
    else:
        out = TP.reduce_from_model(partial, mesh) if tp > 1 else partial
    probs = torch.softmax(logits, dim=-1)
    if sp:
        probs = TP.sequence_share(probs.reshape(B, S, E)).reshape(T, E)
    counts = torch.zeros(E, dtype=torch.long, device=x.device).index_add_(
        0, idx, torch.ones_like(idx))
    aux = (cfg.router_aux_coef * E
           * torch.sum(counts.float() / (T * K) * probs.mean(0)))
    aux = TP.reduce_over_data(aux, mesh) / mesh.dp
    return out.to(x.dtype).reshape(B, -1, d), aux


def moe_ffn_ep_data(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    sp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Experts over "data" (``moe_expert_axis="data"``, the reference's
    ``expert``/``tp_if_ep_data`` rules): this rank holds E/data experts,
    each with its block of d_ff over "model". Every rank routes its own
    rows (capacity per row, `route`: a row's kept tokens do not change)
    into the (E, B x capacity, d) buffer, whose expert blocks go to their
    owners by `tp.all_to_all_data`; the owner runs its experts over every
    data rank's slots, gate and up column-parallel and w_down a partial
    sum over its d_ff block, and the outputs come back the same way. The
    gate-weighted combine and the shared experts' column block (as in
    `moe_ffn_shard_map`) make an f32 partial, all-reduced over "model"
    (`tp.reduce_from_model`), or under `sp` reduce-scattered to this
    rank's block of the sequence. The aux loss is the whole batch's
    (`_aux_loss`' sums over "data"). The tokens and the routing logits
    enter the partial region through `tp.copy_to_model` where "model" has
    more than one rank and `sp` is off; the aux loss reads the logits as
    they are. An expert leaf's gradient is whole over "data" after the
    exchange's backward: the train step does not sum it there."""
    mesh = current_mesh()
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    w = p["experts"]
    e_loc = w["w_gate"].shape[0]
    n, tp = mesh.data, mesh.tp
    if e_loc * n != E or (tp > 1 and w["w_gate"].shape[-1] * tp
                          != cfg.d_ff_expert):
        raise ValueError(f"experts over 'data' need n_experts={E} cut over "
                         f"{n} data ranks and d_ff_expert="
                         f"{cfg.d_ff_expert} over {tp} model ranks")
    xt = x.reshape(T, d)
    logits = ops.matmul(xt, p["router"]["w"], out_dtype=torch.float32)
    if tp > 1 and not sp:
        xt_in, lg = TP.copy_to_model(xt), TP.copy_to_model(logits)
    else:
        xt_in, lg = xt, logits
    r = route(lg, cfg, B)
    idx, slot, keep, cap = r["idx"], r["slot"], r["keep"], r["capacity"]
    C = B * cap
    contrib = torch.where(keep[:, None],
                          xt_in.repeat_interleave(K, dim=0).float(), 0.0)
    xe = torch.zeros((E, C, d), dtype=torch.float32, device=x.device)
    xe.index_put_((idx, slot), contrib, accumulate=True)
    # (E, C, d): block j of experts to data rank j; back, data rank i's
    # slots of this rank's experts, side by side on the capacity axis
    xe = TP.all_to_all_data(xe.to(x.dtype), mesh)
    xe = xe.reshape(n, e_loc, C, d).transpose(0, 1).reshape(e_loc, n * C, d)
    ye = _expert_ffn(w, xe)
    ye = ye.reshape(e_loc, n, C, d).transpose(0, 1).reshape(E, C, d)
    ye = TP.all_to_all_data(ye, mesh)
    partial = _combine(ye[idx, slot].float() * r["gate"][:, None], T, K)
    if "shared_mlp" in p:
        sm = p["shared_mlp"]
        f = cfg.d_ff_expert * cfg.n_shared_experts
        u = TP.tp_column(xt_in, sm["w_up"], cfg, f)
        g = TP.tp_column(xt_in, sm["w_gate"], cfg, f)
        h = F.silu(g.float()).to(x.dtype) * u
        partial = partial + ops.matmul(h, sm["w_down"]).float()
    partial = partial.reshape(B, S, d)
    if sp:
        out = TP.scatter_to_sequence(partial, 1, mesh)
    else:
        out = TP.reduce_from_model(partial, mesh) if tp > 1 else partial
    probs = r["probs"] if lg is logits else torch.softmax(logits, dim=-1)
    aux = _aux_loss(cfg, idx, probs, T, B if sp else 0)
    return out.to(x.dtype), aux


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, sp: bool = False):
    """The MoE FFN the blocks call, outside gather mode on a mesh: the
    experts-over-"data" `moe_ffn_ep_data` under
    ``moe_expert_axis="data"`` (whatever ``moe_impl``: the experts live on
    "data"), the explicit expert-parallel `moe_ffn_shard_map` under
    ``moe_impl="shard_map"`` (as the reference's `moe_ffn` decides); else
    the dense-dispatch `moe_ffn_apply`. `sp`: `x` is the gathered
    sequence and the output this rank's block of it."""
    mesh = current_mesh()
    if mesh is not None and getattr(cfg, "tp_reduce", "psum") != "gather":
        if getattr(cfg, "moe_expert_axis", "model") == "data":
            return moe_ffn_ep_data(p, x, cfg, sp)
        if cfg.moe_impl == "shard_map":
            return moe_ffn_shard_map(p, x, cfg, sp)
    return moe_ffn_apply(p, x, cfg, sp)



def moe_block_apply(blk, x: torch.Tensor, cfg: ModelConfig, *, positions,
                    cache=None, cache_index=None, seq_lens=None):
    """OLMoE block: RMSNorm -> GQA attention -> RMSNorm -> MoE FFN.
    Returns (x, cache, aux). Under sequence parallelism as
    `transformer.dense_block_apply`."""
    sp = TP.sequence_parallel(cfg, positions.shape[1])
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    if sp:
        h = TP.gather_from_sequence(h)
    attn_out, new_cache = L.attention_apply(
        blk.attn, h, cfg, positions=positions, kv_cache=cache,
        cache_index=cache_index, seq_lens=seq_lens, sp=sp)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    if sp:
        h = TP.gather_from_sequence(h)
    moe_out, aux = moe_ffn(blk.moe, h, cfg, sp)
    return x + moe_out, new_cache, aux


# ---------------- DeepSeek-V2 multi-head latent attention ----------------

def _decompress(c: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
                n: int) -> torch.Tensor:
    """c @ w in `c`'s dtype: the latent (possibly a bf16 cache under an f32
    config) is widened exactly to the weight's dtype, multiplied in f32 and
    rounded back, as the JAX package's matmul of a bf16 cache does. `w` is
    this rank's head columns of a projection `n` wide under tensor
    parallelism (its K segments the whole projection's)."""
    sharded = TP.tp_enabled(cfg) and w.shape[-1] != n
    return ops.matmul(c.to(w.dtype), w, out_dtype=c.dtype,
                      segments_n=n if sharded else None)


def mla_attention(q_c: torch.Tensor, q_pe: torch.Tensor, k_c: torch.Tensor,
                  v: torch.Tensor, k_pe: torch.Tensor, *, q_offset,
                  kv_len, kv_valid, scale: float) -> torch.Tensor:
    """MLA's attention over the heads of `q_c` (B, S, H, hd) and `q_pe`
    (B, S, H, pe) against the decompressed `k_c`, `v` (B, Sk, H, hd) and
    the shared RoPE key `k_pe` (B, Sk, 1, pe): f32 scores and softmax,
    the weights rounded to the activation dtype before the PV product, in
    query blocks of `layers.Q_CHUNK` for a long prefill. Returns (B, S, H,
    hd) in `q_c`'s dtype. On the card, as in `layers._sdpa`, fewer than
    `layers.Q_MIN_CUDA` queries are zero-padded to that many and a call
    of one row and one head runs twice over: cuBLAS picks a short or
    single batched product's kernel, and with it the order of each dot
    product's sum, by the batch of (row, head) matrices, so a rank's
    heads of a decode step summed otherwise than beside the other ranks'
    (measured on the H100). So each head's result is its own: a rank's
    heads give the whole call's bits for those heads (`chip_smoke.py`
    phase 3)."""
    B, S = q_c.shape[:2]
    Sk = k_c.shape[1]
    dt = q_c.dtype
    kw = dict(q_offset=q_offset, kv_len=kv_len, kv_valid=kv_valid,
              scale=scale)
    if q_c.is_cuda and B * q_c.shape[2] < L.BATCH_MIN_CUDA:
        twice = (L._twice(t) for t in (q_c, q_pe, k_c, v, k_pe))
        return mla_attention(*twice, **{k: L._twice(t) for k, t in
                                        kw.items()})[:1]
    if q_c.is_cuda and S < L.Q_MIN_CUDA:
        def pad(t):
            return torch.cat([t, t.new_zeros(
                (B, L.Q_MIN_CUDA - S, *t.shape[2:]))], dim=1)
        return mla_attention(pad(q_c), pad(q_pe), k_c, v, k_pe,
                             **kw)[:, :S]

    def attend_block(q_c_b, q_pe_b, off):
        Sq = q_c_b.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q_c_b.float(), k_c.float())
        scores = scores + torch.einsum("bqhp,bkgp->bhqk", q_pe_b.float(),
                                       k_pe.float())
        scores = scores * scale
        mask = L.attention_mask(Sq, Sk, causal=True, q_offset=off,
                                kv_len=kv_len, device=q_c.device)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        scores = torch.where(mask[:, None], scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(dt).float(),
                            v.float()).to(dt)

    qc = L.Q_CHUNK
    if S <= qc or S % qc != 0:
        return attend_block(q_c, q_pe, q_offset)
    return torch.cat([attend_block(q_c[:, i:i + qc], q_pe[:, i:i + qc],
                                   q_offset + i)
                      for i in range(0, S, qc)], dim=1)


def mla_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions,
              kv_cache: dict | None = None, cache_index=None,
              seq_lens=None, sp: bool = False
              ) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention. The cache holds the rank-r latent
    ``c_kv`` and the shared RoPE key ``k_pe``: dense ({"c_kv", "k_pe"},
    (B, max_len, r | pe), written in place at `cache_index`) or paged
    ({"c_kv_pages", "k_pe_pages"} pools and a (B, n) "table", written
    through the table and gathered back per row). The keys and values are
    decompressed from the whole cache view every call (``w_uk``/``w_uv``
    over B x cache-length rows), as in the JAX package. Returns (y, cache).

    Under tensor parallelism the head count is this rank's, read from
    w_uq's width (whole heads of hd + pe columns), and the output
    projection gathers the heads and its columns (`tp_row`). Under `sp`
    (`x` the gathered sequence) nothing enters the heads through a copy
    and the output is this rank's block of the sequence, as in
    `layers.attention_apply`.
    """
    B, S, d = x.shape
    hd, pe = cfg.hd, cfg.rope_head_dim
    H = p["w_uq"].shape[-1] // (hd + pe)          # this rank's heads

    n_uq = cfg.n_heads * (hd + pe)
    q_in = ops.matmul(x, p["w_dq"]) if cfg.q_lora_rank else x
    q = TP.tp_column(TP.enter(q_in, cfg, p["w_uq"], n_uq, sp), p["w_uq"],
                     cfg, n_uq)
    q = q.reshape(B, S, H, hd + pe)
    q_c, q_pe = q[..., :hd], q[..., hd:]
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)

    c_kv = ops.matmul(x, p["w_dkv"])                              # (B, S, r)
    k_pe = ops.matmul(x, p["w_kpe"]).reshape(B, S, 1, pe)
    k_pe = L.apply_rope(k_pe, positions, cfg.rope_theta)

    new_cache = None
    kv_valid = None
    if kv_cache is not None and "c_kv_pages" in kv_cache:
        table = kv_cache["table"]
        cc = L.paged_cache_update(kv_cache["c_kv_pages"], c_kv, table,
                                  cache_index, update_lens=seq_lens)
        cp = L.paged_cache_update(kv_cache["k_pe_pages"], k_pe[:, :, 0],
                                  table, cache_index, update_lens=seq_lens)
        new_cache = {"c_kv_pages": cc, "k_pe_pages": cp, "table": table}
        c_kv_full = L.paged_gather(cc, table)
        k_pe_full = L.paged_gather(cp, table)[:, :, None]
        kv_valid = L.page_valid_mask(table, c_kv_full.shape[1])
        kv_len, q_offset = cache_index + S, cache_index
    elif kv_cache is not None:
        cc = L.cache_update(kv_cache["c_kv"], c_kv, cache_index,
                            update_lens=seq_lens)
        cp = L.cache_update(kv_cache["k_pe"], k_pe[:, :, 0], cache_index,
                            update_lens=seq_lens)
        new_cache = {"c_kv": cc, "k_pe": cp}
        c_kv_full, k_pe_full = cc, cp[:, :, None]
        kv_len, q_offset = cache_index + S, cache_index
    else:
        c_kv_full, k_pe_full = c_kv, k_pe
        kv_len, q_offset = None, 0

    Sk = c_kv_full.shape[1]
    n_uk = cfg.n_heads * hd
    # psum mode: the whole latent and RoPE key enter the sharded heads
    c_kv_full = TP.enter(c_kv_full, cfg, p["w_uq"], n_uq, sp)
    k_pe_full = TP.enter(k_pe_full, cfg, p["w_uq"], n_uq, sp)
    k_c = _decompress(c_kv_full, p["w_uk"], cfg, n_uk).reshape(B, Sk, H, hd)
    v = _decompress(c_kv_full, p["w_uv"], cfg, n_uk).reshape(B, Sk, H, hd)
    out = mla_attention(q_c, q_pe, k_c, v, k_pe_full, q_offset=q_offset,
                        kv_len=kv_len, kv_valid=kv_valid,
                        scale=1.0 / math.sqrt(hd + pe))
    y = TP.tp_row(out.reshape(B, S, H * hd), p["wo"], cfg, d, n_uk, sp=sp)
    return y, new_cache


def mla_moe_block_apply(blk, x: torch.Tensor, cfg: ModelConfig, *,
                        positions, cache=None, cache_index=None,
                        seq_lens=None):
    """DeepSeek-V2 block: RMSNorm -> MLA -> RMSNorm -> MoE FFN with shared
    experts. Returns (x, cache, aux). Under sequence parallelism as
    `transformer.dense_block_apply`."""
    sp = TP.sequence_parallel(cfg, positions.shape[1])
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    if sp:
        h = TP.gather_from_sequence(h)
    attn_out, new_cache = mla_apply(blk.attn, h, cfg, positions=positions,
                                    kv_cache=cache, cache_index=cache_index,
                                    seq_lens=seq_lens, sp=sp)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    if sp:
        h = TP.gather_from_sequence(h)
    moe_out, aux = moe_ffn(blk.moe, h, cfg, sp)
    return x + moe_out, new_cache, aux


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device: str | torch.device = "cuda") -> dict:
    """Zeroed dense latent cache: (L, B, max_len, r) ``c_kv`` and
    (L, B, max_len, pe) ``k_pe``, bf16 by default as in the JAX package."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len)
    return {"c_kv": torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dtype,
                                device=dev),
            "k_pe": torch.zeros(shape + (cfg.rope_head_dim,), dtype=dtype,
                                device=dev)}


def init_mla_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                       dtype: torch.dtype = torch.bfloat16, *,
                       device: str | torch.device = "cuda") -> dict:
    """Zeroed paged latent pool, (L, P, T, r | pe) per leaf (page 0 the
    null page): the MLA analogue of `transformer.init_kv_page_pool`."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size)
    return {"c_kv_pages": torch.zeros(shape + (cfg.kv_lora_rank,),
                                      dtype=dtype, device=dev),
            "k_pe_pages": torch.zeros(shape + (cfg.rope_head_dim,),
                                      dtype=dtype, device=dev)}
