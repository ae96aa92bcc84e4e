"""Decoder-only dense transformer: the module holding the weights, its
initialisation, the KV caches (dense and paged), and the serving forwards
(prefill, chunked prefill, decode).

The counterpart of the JAX package's `repro.models.transformer` for dense
blocks at tp=1. The parameter tree mirrors the JAX one — ``embed.table``,
per layer ``ln1/attn/ln2/mlp``, ``ln_f.scale``, ``head.w`` — except that
layers are a list of modules rather than leaves stacked on an L axis (the
port runs a Python loop where JAX runs ``lax.scan``).

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


class DenseBlock(nn.Module):
    """One pre-norm block: RMSNorm -> GQA attention -> RMSNorm -> SwiGLU."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.kv_heads
        dt = _dtype(cfg.param_dtype)
        self.ln1 = _params(device, dt, scale=(d,))
        attn = dict(wq=(d, H * hd), wk=(d, KV * hd), wv=(d, KV * hd),
                    wo=(H * hd, d))
        if cfg.qkv_bias:
            attn.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
        self.attn = _params(device, dt, **attn)
        self.ln2 = _params(device, dt, scale=(d,))
        mlp = dict(w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
        if cfg.gated_mlp:
            mlp["w_gate"] = (d, cfg.d_ff)
        self.mlp = _params(device, dt, **mlp)


class TransformerLM(nn.Module):
    """The weights of a dense decoder-only LM, allocated uninitialised on
    `device` (the card unless the caller asks for the CPU). Fill them with
    `lm_init` or `bridge.params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        """Allocate every parameter, uninitialised, on `device`."""
        super().__init__()
        if cfg.kind != "dense":
            raise ValueError(f"TransformerLM holds dense blocks, not "
                             f"kind={cfg.kind!r}")
        dev = resolve_device(device)
        dt = _dtype(cfg.param_dtype)
        self.embed = _params(dev, dt, table=(cfg.vocab, cfg.d_model))
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, dev) for _ in range(cfg.n_layers))
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
    with the JAX package's scales: N(0, 1/d_in) projections (``wo`` over
    H*hd, ``w_down`` over d_ff), N(0, 0.02) embeddings, unit norms, zero
    biases. Each tensor is drawn in f32 on the device and cast on its own,
    so no f32 copy of the whole model ever exists."""
    model = TransformerLM(cfg, device)
    if generator.device.type != model.device.type:
        raise ValueError(f"generator on {generator.device}, model on "
                         f"{model.device}")

    def normal_(t: torch.Tensor, scale: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * scale)

    hd, H, f = cfg.hd, cfg.n_heads, cfg.d_ff
    normal_(model.embed["table"], 0.02)
    for blk in model.blocks:
        for name, w in blk.attn.items():
            if name.startswith("b"):
                w.zero_()
            else:
                normal_(w, 1.0 / math.sqrt(H * hd if name == "wo" else w.shape[0]))
        for name, w in blk.mlp.items():
            normal_(w, 1.0 / math.sqrt(f if name == "w_down" else w.shape[0]))
        blk.ln1["scale"].fill_(1.0)
        blk.ln2["scale"].fill_(1.0)
    model.ln_f["scale"].fill_(1.0)
    if model.head is not None:
        normal_(model.head["w"], 1.0 / math.sqrt(cfg.d_model))
    return model


def dense_block_apply(blk: DenseBlock, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, cache: dict | None = None,
                      cache_index=None, seq_lens=None):
    """One block; returns (x, cache). `seq_lens` masks a right-padded
    chunk's KV write to each row's valid tokens."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    attn_out, new_cache = L.attention_apply(
        blk.attn, h, cfg, positions=positions, kv_cache=cache,
        cache_index=cache_index, seq_lens=seq_lens)
    x = x + attn_out
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    return x + L.swiglu_apply(blk.mlp, h, cfg), new_cache


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
    """Every block in order over per-layer views of `cache` (written in
    place). Every leaf of `cache` is stacked on a leading layer axis: the
    dense cache's "k"/"v", or the paged cache's "k_pages"/"v_pages" pools
    and its "table" (one table per layer, as in the JAX package, usually a
    broadcast view of one)."""
    for i, blk in enumerate(model.blocks):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x, _ = dense_block_apply(blk, x, cfg, positions=positions,
                                 cache=layer_cache, cache_index=cache_index,
                                 seq_lens=seq_lens)
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
        cache = init_kv_cache(cfg, B, max_len or S, device=dev)
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
