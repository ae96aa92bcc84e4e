"""Decoder-only transformer: the module holding the weights, its
initialisation, the KV caches (dense and paged), and the serving forwards
(prefill, chunked prefill, decode).

The counterpart of the JAX package's `repro.models.transformer` at tp=1,
for dense, MoE (`moe.moe_block_apply`) and MLA-MoE
(`moe.mla_moe_block_apply`) blocks. The parameter tree mirrors the JAX one
— ``embed.table``, per layer ``ln1/attn/ln2`` and ``mlp`` or ``moe``
(``router``, ``experts``, ``shared_mlp``), ``ln_f.scale``, ``head.w`` —
except that layers are a list of modules rather than leaves stacked on an L
axis (the port runs a Python loop where JAX runs ``lax.scan``).

The serving forwards write the KV cache of the state they are given in
place (JAX donates and rebinds it) and return the state with its advanced
``index``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _params(device, dtype, **shapes) -> nn.ParameterDict:
    """Uninitialised, frozen parameters of the given shapes."""
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, shape in shapes.items()})


def _mlp_shapes(cfg: ModelConfig, d_ff: int) -> dict:
    """The (SwiGLU or GELU) FFN's weight shapes at hidden width `d_ff`."""
    d = cfg.d_model
    mlp = dict(w_up=(d, d_ff), w_down=(d_ff, d))
    if cfg.gated_mlp:
        mlp["w_gate"] = (d, d_ff)
    return mlp


def _gqa_shapes(cfg: ModelConfig) -> dict:
    """GQA attention's projections (and QKV biases)."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.kv_heads
    attn = dict(wq=(d, H * hd), wk=(d, KV * hd), wv=(d, KV * hd),
                wo=(H * hd, d))
    if cfg.qkv_bias:
        attn.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    return attn


def _mla_shapes(cfg: ModelConfig) -> dict:
    """Multi-head latent attention's projections (`moe.mla_apply`)."""
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    r, rq, pe = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
    attn = dict(w_dkv=(d, r), w_kpe=(d, pe), w_uk=(r, H * hd),
                w_uv=(r, H * hd), wo=(H * hd, d))
    if rq:
        attn.update(w_dq=(d, rq), w_uq=(rq, H * (hd + pe)))
    else:
        attn["w_uq"] = (d, H * (hd + pe))
    return attn


def _moe_groups(cfg: ModelConfig, device, dt) -> nn.ModuleDict:
    """The MoE FFN's groups: ``router.w`` (d, E), ``experts`` stacked on E,
    and ``shared_mlp`` (a SwiGLU of n_shared x d_ff_expert) if any."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    groups = {"router": _params(device, dt, w=(d, E)),
              "experts": _params(device, dt, w_gate=(E, d, f),
                                 w_up=(E, d, f), w_down=(E, f, d))}
    if cfg.n_shared_experts:
        groups["shared_mlp"] = _params(
            device, dt, **_mlp_shapes(cfg, f * cfg.n_shared_experts))
    return nn.ModuleDict(groups)


class DenseBlock(nn.Module):
    """One pre-norm block: RMSNorm -> GQA attention -> RMSNorm -> SwiGLU."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(cfg.d_model,))
        self.attn = _params(device, dt, **_gqa_shapes(cfg))
        self.ln2 = _params(device, dt, scale=(cfg.d_model,))
        self.mlp = _params(device, dt, **_mlp_shapes(cfg, cfg.d_ff))


class MoEBlock(nn.Module):
    """OLMoE block: RMSNorm -> GQA attention -> RMSNorm -> MoE FFN."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(cfg.d_model,))
        self.attn = _params(device, dt, **_gqa_shapes(cfg))
        self.ln2 = _params(device, dt, scale=(cfg.d_model,))
        self.moe = _moe_groups(cfg, device, dt)


class MLAMoEBlock(nn.Module):
    """DeepSeek-V2 block: RMSNorm -> multi-head latent attention ->
    RMSNorm -> MoE FFN with shared experts."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(cfg.d_model,))
        self.attn = _params(device, dt, **_mla_shapes(cfg))
        self.ln2 = _params(device, dt, scale=(cfg.d_model,))
        self.moe = _moe_groups(cfg, device, dt)


# the block module of each kind the port serves
BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "mla_moe": MLAMoEBlock}


class TransformerLM(nn.Module):
    """The weights of a decoder-only LM of a kind in `BLOCKS` (dense, MoE or
    MLA-MoE blocks), allocated uninitialised on `device` (the card unless
    the caller asks for the CPU). Fill them with `lm_init` or
    `bridge.params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        """Allocate every parameter, uninitialised, on `device`."""
        super().__init__()
        if cfg.kind not in BLOCKS:
            raise ValueError(f"TransformerLM holds {sorted(BLOCKS)} blocks, "
                             f"not kind={cfg.kind!r}")
        dev = resolve_device(device)
        dt = _dtype(cfg.param_dtype)
        self.embed = _params(dev, dt, table=(cfg.vocab, cfg.d_model))
        self.blocks = nn.ModuleList(
            BLOCKS[cfg.kind](cfg, dev) for _ in range(cfg.n_layers))
        self.ln_f = _params(dev, dt, scale=(cfg.d_model,))
        self.head = (None if cfg.tie_embeddings
                     else _params(dev, dt, w=(cfg.d_model, cfg.vocab)))

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.embed["table"].device


@torch.no_grad()
def lm_init(cfg: ModelConfig, generator: torch.Generator, *,
            device: str | torch.device = "cuda") -> TransformerLM:
    """Random weights drawn from `generator` (which must live on `device`),
    with the JAX package's scales: every projection N(0, 1/d_in), d_in its
    second-to-last axis (``wo`` over H*hd, ``w_down`` over d_ff, the
    experts (E, d, f) over d and (E, f, d) over f, the router over d),
    N(0, 0.02) embeddings, unit norms, zero biases. Each tensor is drawn in
    f32 on the device and cast on its own, so no f32 copy of the whole model
    ever exists (the largest transient is one tensor: a deepseek-v2-236b
    layer's (160, 5120, 1536) experts, 5.0 GB)."""
    model = TransformerLM(cfg, device)
    if generator.device.type != model.device.type:
        raise ValueError(f"generator on {generator.device}, model on "
                         f"{model.device}")
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            w.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            w.zero_()
        else:
            scale = 0.02 if name == "embed.table" else (
                1.0 / math.sqrt(w.shape[-2]))
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device,
                                dtype=torch.float32).mul_(scale))
    return model


def dense_block_apply(blk: DenseBlock, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, cache: dict | None = None,
                      cache_index=None, seq_lens=None):
    """One block; returns (x, cache, aux) (aux is 0: the uniform block
    API of the JAX package). `seq_lens` masks a right-padded chunk's KV
    write to each row's valid tokens."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    attn_out, new_cache = L.attention_apply(
        blk.attn, h, cfg, positions=positions, kv_cache=cache,
        cache_index=cache_index, seq_lens=seq_lens)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    return x + L.swiglu_apply(blk.mlp, h, cfg), new_cache, 0.0


def block_apply(cfg: ModelConfig):
    """The block function of ``cfg.kind``."""
    from repro_torch.models import moe

    return {"dense": dense_block_apply, "moe": moe.moe_block_apply,
            "mla_moe": moe.mla_moe_block_apply}[cfg.kind]


def _embed(model: TransformerLM, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    return model.embed["table"][tokens].to(_dtype(cfg.activation_dtype))


def _unembed(model: TransformerLM, x: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return ops.matmul(x, model.embed["table"], transpose_b=True,
                          out_dtype=torch.float32)
    return ops.matmul(x, model.head["w"], out_dtype=torch.float32)


def _run_blocks(model: TransformerLM, x: torch.Tensor, cfg: ModelConfig, *,
                positions, cache: dict, cache_index, seq_lens=None):
    """Every block in order (the block function of ``cfg.kind``) over
    per-layer views of `cache` (written in place). Every leaf of `cache` is
    stacked on a leading layer axis: the dense cache's "k"/"v" (MLA:
    "c_kv"/"k_pe"), or the paged cache's pools ("k_pages"/"v_pages", MLA:
    "c_kv_pages"/"k_pe_pages") and its "table" (one table per layer, as in
    the JAX package, usually a broadcast view of one). The blocks' aux
    losses are dropped: serving has no use for them."""
    apply = block_apply(cfg)
    for i, blk in enumerate(model.blocks):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = apply(blk, x, cfg, positions=positions, cache=layer_cache,
                  cache_index=cache_index, seq_lens=seq_lens)[0]
    return x


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  device: str | torch.device = "cuda") -> dict:
    """Zeroed KV cache, (L, B, max_len, KV, hd) per leaf. bf16 by default
    whatever the activation dtype, as in the JAX package: keys and values
    are rounded to bf16 on write and converted back on read."""
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    """The zeroed dense cache of ``cfg.kind``: the MLA latent cache
    (`moe.init_mla_cache`) for mla_moe, else the KV cache."""
    if cfg.kind == "mla_moe":
        from repro_torch.models.moe import init_mla_cache

        return init_mla_cache(cfg, batch, max_len, device=device)
    return init_kv_cache(cfg, batch, max_len, device=device)


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int, *,
                   device: str | torch.device = "cuda") -> dict:
    """The zeroed page pool of ``cfg.kind``: the MLA latent pool
    (`moe.init_mla_page_pool`) for mla_moe, else the KV pool."""
    if cfg.kind == "mla_moe":
        from repro_torch.models.moe import init_mla_page_pool

        return init_mla_page_pool(cfg, num_pages, page_size, device=device)
    return init_kv_page_pool(cfg, num_pages, page_size, device=device)


def init_kv_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                      dtype: torch.dtype = torch.bfloat16, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed paged KV pool: `num_pages` shared pages of `page_size` tokens
    per layer, (L, P, T, KV, hd) per leaf (page 0 reserved as the null page,
    see `serving.paging`). The engine pairs it with a per-row page table to
    form the paged decode cache {"k_pages", "v_pages", "table"}."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
            "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def lm_prefill(model: TransformerLM, batch: dict, cfg: ModelConfig,
               max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward filling the KV cache; returns last logits.

    Without ``batch["lengths"]`` every row is S tokens: returns the logits
    at position S-1 and a shared scalar ``index = S``. With a (B,) tensor of
    true lengths over right-padded rows: returns each row's logits at
    ``lengths[b] - 1`` and a per-row ``index = lengths`` (pad keys sit after
    every valid query, so right-padding is causal-safe)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    lengths = batch.get("lengths")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=dev).expand(B, S)
    cache = batch.get("cache")
    if cache is None:
        cache = init_cache(cfg, B, max_len or S, device=dev)
    x = _run_blocks(model, _embed(model, tokens, cfg), cfg,
                    positions=positions, cache=cache, cache_index=0,
                    seq_lens=None if lengths is None else lengths.long())
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    if lengths is None:
        logits = _unembed(model, x[:, -1:], cfg)
        return logits[:, 0], {"kv": cache,
                              "index": torch.tensor(S, device=dev)}
    lengths = lengths.long()
    last = x[torch.arange(B, device=dev), lengths - 1][:, None]
    logits = _unembed(model, last, cfg)
    return logits[:, 0], {"kv": cache, "index": lengths}


@torch.no_grad()
def lm_prefill_chunk(model: TransformerLM, tokens: torch.Tensor,
                     lengths: torch.Tensor, state: dict, cfg: ModelConfig,
                     positions: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """One admission-prefill chunk of the serving loop.

    tokens: (B, S), each row's next `lengths[b]` prompt tokens right-padded
    to the chunk bucket S; state: {"kv", "index"} with a per-row ``index``
    holding each row's chunk base (tokens already written). KV rows are
    written in place at ``index[b] .. index[b] + lengths[b]``; a zero-length
    row writes nothing. Returns each row's logits at its last valid position
    (clamped to 0 for zero-length rows) and the state with
    ``index + lengths``. Prefilling a prompt in chunks gives the logits of a
    single `lm_prefill` over the whole prompt."""
    B, S = tokens.shape
    dev = tokens.device
    base = state["index"].long()
    lengths = lengths.long()
    if positions is None:
        positions = base[:, None] + torch.arange(S, device=dev)[None, :]
    x = _run_blocks(model, _embed(model, tokens, cfg), cfg,
                    positions=positions, cache=state["kv"], cache_index=base,
                    seq_lens=lengths)
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    last = x[torch.arange(B, device=dev), (lengths - 1).clamp(min=0)][:, None]
    logits = _unembed(model, last, cfg)
    return logits[:, 0], {"kv": state["kv"], "index": base + lengths}


@torch.no_grad()
def lm_decode_step(model: TransformerLM, token: torch.Tensor, state: dict,
                   cfg: ModelConfig, positions: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, dict]:
    """One-token decode. token: (B,) int; state: {"kv", "index"}, where
    ``index`` is a scalar (every row at one position) or (B,) (each slot at
    its own position). Returns (logits (B, V) f32, state with index + 1)."""
    B = token.shape[0]
    idx = state["index"]
    if positions is None:
        positions = (idx.long().expand(B) if idx.dim() == 0
                     else idx.long())[:, None]
    x = _run_blocks(model, _embed(model, token[:, None], cfg), cfg,
                    positions=positions, cache=state["kv"], cache_index=idx)
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    logits = _unembed(model, x, cfg)
    return logits[:, 0], {"kv": state["kv"], "index": idx + 1}
