"""Model configuration — the port's own copy of the JAX package's
`repro.models.config.ModelConfig` (kept whole, so the two compare field by
field), of `kv_cache_bytes` and of `gemm_shape_counts`.

One dataclass, many families. `kind` selects the forward function:
  dense        - standard decoder-only transformer (GQA, RoPE, opt. QKV bias)
  moe          - dense attention + mixture-of-experts FFN (top-k routing)
  mla_moe      - DeepSeek-V2: multi-head latent attention + shared+routed MoE
  mamba1       - attention-free selective-SSM stack (Falcon-Mamba)
  mamba2       - attention-free SSD stack (Mamba2 blocks, no shared attn)
  hybrid       - Mamba2 backbone with shared attention blocks (Zamba2)
  encdec       - encoder-decoder with cross attention (Seamless-M4T)
  vlm          - decoder-only with M-RoPE + patch-embedding input (Qwen2-VL)

The port serves `dense`, `moe` and `mla_moe` so far; the other kinds are
carried so that a config means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["dense", "moe", "mla_moe", "mamba1", "mamba2", "hybrid",
               "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One model's architecture, numerics and distribution hints."""

    name: str
    kind: Kind
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int | None = None          # GQA; None => MHA
    head_dim: int | None = None            # None => d_model // n_heads
    qkv_bias: bool = False
    gated_mlp: bool = True                 # SwiGLU; False => 2-matrix GELU FFN
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0                   # per-expert hidden dim
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0                  # latent KV compression dim
    q_lora_rank: int = 0
    rope_head_dim: int = 64                # decoupled RoPE key dim
    # --- SSM (Mamba1/Mamba2) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64                  # mamba2 head dim
    ssm_ngroups: int = 1
    # --- hybrid (Zamba2) ---
    attn_every: int = 6                    # shared attn block period
    # --- encdec ---
    n_encoder_layers: int = 0
    # --- vlm ---
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2
    # --- numerics ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # --- distribution hints ---
    fsdp: bool = False                     # shard params over data axis too
    remat: bool = True                     # activation checkpoint per layer
    # --- perf levers (EXPERIMENTS.md §Perf) ---
    sequence_parallel: bool = False        # shard residual stream seq over TP
    moe_expert_axis: str = "model"         # "model" (EP=TP) | "data" (EP=DP)
    moe_impl: str = "spmd"                 # "spmd" | "shard_map" (explicit EP)
    tp_collectives: str = "auto"           # "auto" | "explicit" (bf16 wires)
    # row-parallel reduction: "psum" (all-reduce, lowest wire — training) or
    # "gather" (all-gather in/out, bit-identical to the unsharded dot — the
    # serving engine's parity-safe mode; see distributed.tp)
    tp_reduce: str = "psum"
    # interleaved column chunks per row-parallel projection: chunk c's
    # collective overlaps chunk c+1's GEMM (double-buffered SUMMA pipelining)
    tp_overlap_chunks: int = 1
    # serving-prefill SSM scan block; 0 => ssm.SERVE_CHUNK (8). Wider grains
    # (32/64) recover long-prompt prefill throughput; chunk_tokens must stay
    # a multiple (bit-parity contract — see ssm.SERVE_CHUNK)
    ssm_serve_grain: int = 0
    kv_cache_dtype: str = "bfloat16"       # "float8_e4m3fn" halves cache bytes

    @property
    def kv_heads(self) -> int:
        """KV heads (GQA); equals n_heads for MHA."""
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def hd(self) -> int:
        """Head dim (d_model // n_heads unless set)."""
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        """SSM inner width (expand * d_model)."""
        return self.expand * self.d_model

    @property
    def attention_free(self) -> bool:
        """True for pure SSM stacks (no KV cache)."""
        return self.kind in ("mamba1", "mamba2")

    @property
    def sub_quadratic(self) -> bool:
        """True for SSM and hybrid stacks."""
        return self.kind in ("mamba1", "mamba2", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        hd, H, KV = self.hd, self.n_heads, self.kv_heads
        if self.kind == "mamba1":
            di, ds = self.d_inner, self.ssm_state
            per = (d * 2 * di          # in_proj
                   + di * self.d_conv  # conv
                   + di * (2 * ds + 2) # x_proj(B,C,dt) approx + dt_proj
                   + di * ds + di      # A, D
                   + di * d)           # out_proj
            return emb + L * per + d
        if self.kind == "mamba2":
            di, ds = self.d_inner, self.ssm_state
            H = di // max(self.ssm_headdim, 1)
            conv_ch = di + 2 * self.ssm_ngroups * ds
            per = (d * (2 * di + 2 * self.ssm_ngroups * ds + H)  # in_proj
                   + conv_ch * (self.d_conv + 1)                 # conv w+b
                   + 3 * H + di                                  # A/D/dt/norm
                   + di * d)                                     # out_proj
            return emb + L * per + d
        attn = d * (H * hd) + d * (KV * hd) * 2 + (H * hd) * d
        if self.kind == "mla_moe":
            attn = (d * self.kv_lora_rank + d * self.rope_head_dim
                    + self.kv_lora_rank * (H * hd) * 2
                    + (d * (H * hd) if not self.q_lora_rank else
                       d * self.q_lora_rank + self.q_lora_rank * H * (hd + self.rope_head_dim))
                    + (H * hd) * d)
        mlp_dense = (3 if self.gated_mlp else 2) * d * self.d_ff
        per = attn + mlp_dense
        if self.kind in ("moe", "mla_moe"):
            moe = 3 * d * self.d_ff_expert * (self.n_experts + self.n_shared_experts)
            per = attn + moe + d * self.n_experts  # + router
        if self.kind == "hybrid":
            di, ds = self.d_inner, self.ssm_state
            mamba = (d * 2 * di + di * self.d_conv + di // self.ssm_headdim * 3
                     + 2 * self.ssm_ngroups * ds * di // 1 + di * d)
            shared_attn = attn + mlp_dense  # counted once (shared)
            return emb + L * mamba + shared_attn + d
        if self.kind == "encdec":
            enc = self.n_encoder_layers * (attn + mlp_dense)
            dec = L * (attn * 2 + mlp_dense)  # self + cross
            return emb + enc + dec + d
        return emb + L * per + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.kind not in ("moe", "mla_moe"):
            return self.n_params()
        full = self.n_params()
        all_experts = 3 * self.d_model * self.d_ff_expert * self.n_experts * self.n_layers
        active_experts = 3 * self.d_model * self.d_ff_expert * self.top_k * self.n_layers
        return full - all_experts + active_experts


def kv_cache_bytes(cfg: ModelConfig, tokens: int,
                   dtype_bytes: int = 2) -> int:
    """Bytes of KV (or MLA latent) cache for `tokens` cached positions,
    summed over layers. Attention-free families cache O(1) state per row,
    not per token — 0 here; hybrid counts only its shared attention
    blocks."""
    if cfg.attention_free:
        return 0
    L = cfg.n_layers
    if cfg.kind == "hybrid":
        L = max(cfg.n_layers // max(cfg.attn_every, 1), 1)
    if cfg.kind == "mla_moe" and cfg.kv_lora_rank:
        per_tok = cfg.kv_lora_rank + cfg.rope_head_dim
    else:
        per_tok = 2 * cfg.kv_heads * cfg.hd
    return int(tokens) * per_tok * L * int(dtype_bytes)


def gemm_shape_counts(cfg: ModelConfig, n_tokens: int,
                      head_tokens: int | None = None,
                      kv_rows: int | None = None
                      ) -> dict[tuple[int, int, int], float]:
    """Dominant (m, n, k) GEMMs of one forward pass over `n_tokens` rows,
    with per-step multiplicities — the denominator the serving engine's
    energy attribution needs (one decode step issues each projection once
    per layer, K and V separately, but the LM head only once).

    `head_tokens` sizes the LM-head GEMM's rows separately: training
    unembeds every position (default, = n_tokens), but a serving prefill
    unembeds only each row's last position, so the engine passes its row
    count (see `lm_prefill`). `kv_rows` sizes MLA's cache-wide K/V
    decompression (``w_uk``/``w_uv`` run over every cached row each step,
    B x max_len; default n_tokens, the no-cache case). Zero-row GEMMs are
    dropped.

    Counts are the reference's analytical estimate: MoE expert GEMMs are
    counted ``top_k`` (routed) plus ``n_shared_experts`` times per layer at
    full `n_tokens` rows, and the router is left out. (So they are not the
    launches of `ops.matmul`: the routed experts are einsums that never
    reach the hand-written GEMM, the router does, and the shared experts
    run as one SwiGLU of n_shared x d_ff_expert.)

    The reference's counts at tp = 1 cut to the kinds the port serves
    (dense, moe, mla_moe): its SSM, hybrid and encoder-decoder fleets and
    its tensor-parallel shards come with the slices that port them.
    """
    if cfg.kind not in ("dense", "moe", "mla_moe"):
        raise NotImplementedError(
            f"the port counts dense, moe and mla_moe GEMMs, not "
            f"{cfg.kind!r}")
    t = int(n_tokens)
    d, hd, kv, L = cfg.d_model, cfg.hd, cfg.kv_heads, cfg.n_layers
    counts: dict[tuple[int, int, int], float] = {}

    def add(shape: tuple[int, int, int], n: float) -> None:
        if shape[0] <= 0 or n <= 0:
            return
        counts[shape] = counts.get(shape, 0.0) + n

    if cfg.kind == "mla_moe" and cfg.kv_lora_rank:
        # multi-head latent attention traces its own projection fleet
        # (moe.mla_apply), not the generic Q/K/V/O skeleton
        r, rq, pe = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
        kvr = int(kv_rows) if kv_rows is not None else t
        if rq:
            add((t, rq, d), L)                       # w_dq (Q compress)
            add((t, cfg.n_heads * (hd + pe), rq), L)  # w_uq
        else:
            add((t, cfg.n_heads * (hd + pe), d), L)  # w_uq
        add((t, r, d), L)                            # w_dkv (KV compress)
        add((t, pe, d), L)                           # w_kpe (RoPE key)
        add((kvr, cfg.n_heads * hd, r), 2 * L)       # w_uk / w_uv
        add((t, d, cfg.n_heads * hd), L)             # output projection
    else:
        add((t, cfg.n_heads * hd, d), L)             # Q projection
        add((t, kv * hd, d), 2 * L)                  # K and V projections
        add((t, d, cfg.n_heads * hd), L)             # output projection
    add((int(head_tokens) if head_tokens is not None else t,
         cfg.vocab, d), 1)                           # LM head
    ff = cfg.d_ff_expert if cfg.n_experts else cfg.d_ff
    if ff:
        gate_mult = 2 if cfg.gated_mlp else 1
        if cfg.n_experts:
            add((t, ff, d), gate_mult * cfg.top_k * L)   # routed experts
            add((t, d, ff), cfg.top_k * L)
            if cfg.n_shared_experts:
                add((t, ff, d), gate_mult * cfg.n_shared_experts * L)
                add((t, d, ff), cfg.n_shared_experts * L)
        else:
            add((t, ff, d), gate_mult * L)           # up (and gate)
            add((t, d, ff), L)                       # down projection
    return counts
