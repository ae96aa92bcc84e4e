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

Not ported here: the JAX package's explicit expert-parallel path
(`moe_ffn_shard_map`, ROADMAP A7); `moe_ffn` takes the dense-dispatch
branch, the one the JAX package takes at tp=1.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

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

def moe_ffn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, d), aux loss). `p` holds ``router.w`` (d, E),
    ``experts.{w_gate, w_up}`` (E, d, f) and ``experts.w_down`` (E, f, d),
    and ``shared_mlp`` when the config has shared experts.

    Dispatch scatters each kept token into its expert's slot of an f32
    (E, B * capacity, d) buffer with ``index_put_(accumulate=True)``: a
    kept token owns its slot, and only the zeros of dropped tokens (sent to
    their row's slot 0) ever land beside it, so the sum is exact."""
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

    w = p["experts"]
    g = torch.einsum("ecd,edf->ecf", xe, w["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xe, w["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    ye = torch.einsum("ecf,efd->ecd", h, w["w_down"])             # (E, C, d)

    y_tok = (ye[idx, slot].float() * r["gate"][:, None]).reshape(T, K, d)
    out = y_tok[:, 0]
    for j in range(1, K):                    # a fixed order for every row
        out = out + y_tok[:, j]
    out = out.to(x.dtype)
    if "shared_mlp" in p:
        out = out + L.swiglu_apply(p["shared_mlp"], xt, cfg)

    # Switch-transformer load-balancing loss: integer counts, exact in f32
    density = torch.bincount(idx, minlength=E).float() / (T * K)
    aux = cfg.router_aux_coef * E * torch.sum(density * r["probs"].mean(0))
    return out.reshape(B, S, d), aux


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The MoE FFN the blocks call: the dense-dispatch `moe_ffn_apply`.
    (The JAX package takes its explicit expert-parallel `moe_ffn_shard_map`
    on a (data, model) mesh; that path waits for ROADMAP A7.)"""
    return moe_ffn_apply(p, x, cfg)


def moe_block_apply(blk, x: torch.Tensor, cfg: ModelConfig, *, positions,
                    cache=None, cache_index=None, seq_lens=None):
    """OLMoE block: RMSNorm -> GQA attention -> RMSNorm -> MoE FFN.
    Returns (x, cache, aux)."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    attn_out, new_cache = L.attention_apply(
        blk.attn, h, cfg, positions=positions, kv_cache=cache,
        cache_index=cache_index, seq_lens=seq_lens)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    moe_out, aux = moe_ffn(blk.moe, h, cfg)
    return x + moe_out, new_cache, aux


# ---------------- DeepSeek-V2 multi-head latent attention ----------------

def _decompress(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """c @ w in `c`'s dtype: the latent (possibly a bf16 cache under an f32
    config) is widened exactly to the weight's dtype, multiplied in f32 and
    rounded back, as the JAX package's matmul of a bf16 cache does."""
    return ops.matmul(c.to(w.dtype), w, out_dtype=c.dtype)


def mla_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions,
              kv_cache: dict | None = None, cache_index=None,
              seq_lens=None) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention. The cache holds the rank-r latent
    ``c_kv`` and the shared RoPE key ``k_pe``: dense ({"c_kv", "k_pe"},
    (B, max_len, r | pe), written in place at `cache_index`) or paged
    ({"c_kv_pages", "k_pe_pages"} pools and a (B, n) "table", written
    through the table and gathered back per row). The keys and values are
    decompressed from the whole cache view every call (``w_uk``/``w_uv``
    over B x cache-length rows), as in the JAX package. Returns (y, cache).
    """
    B, S, _ = x.shape
    H, hd, pe = cfg.n_heads, cfg.hd, cfg.rope_head_dim

    if cfg.q_lora_rank:
        q = ops.matmul(ops.matmul(x, p["w_dq"]), p["w_uq"])
    else:
        q = ops.matmul(x, p["w_uq"])
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
    k_c = _decompress(c_kv_full, p["w_uk"]).reshape(B, Sk, H, hd)
    v = _decompress(c_kv_full, p["w_uv"]).reshape(B, Sk, H, hd)
    scale = 1.0 / math.sqrt(hd + pe)

    def attend_block(q_c_b, q_pe_b, off):
        """One query block: f32 scores and softmax, the weights rounded to
        the activation dtype before the PV product."""
        Sq = q_c_b.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q_c_b.float(), k_c.float())
        scores = scores + torch.einsum("bqhp,bkgp->bhqk", q_pe_b.float(),
                                       k_pe_full.float())
        scores = scores * scale
        mask = L.attention_mask(Sq, Sk, causal=True, q_offset=off,
                                kv_len=kv_len, device=x.device)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        scores = torch.where(mask[:, None], scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(x.dtype).float(),
                            v.float()).to(x.dtype)

    qc = L.Q_CHUNK
    if S <= qc or S % qc != 0:
        out = attend_block(q_c, q_pe, q_offset)
    else:
        out = torch.cat([attend_block(q_c[:, i:i + qc], q_pe[:, i:i + qc],
                                      q_offset + i)
                         for i in range(0, S, qc)], dim=1)
    y = ops.matmul(out.reshape(B, S, H * hd), p["wo"])
    return y, new_cache


def mla_moe_block_apply(blk, x: torch.Tensor, cfg: ModelConfig, *,
                        positions, cache=None, cache_index=None,
                        seq_lens=None):
    """DeepSeek-V2 block: RMSNorm -> MLA -> RMSNorm -> MoE FFN with shared
    experts. Returns (x, cache, aux)."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    attn_out, new_cache = mla_apply(blk.attn, h, cfg, positions=positions,
                                    kv_cache=cache, cache_index=cache_index,
                                    seq_lens=seq_lens)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    moe_out, aux = moe_ffn(blk.moe, h, cfg)
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
