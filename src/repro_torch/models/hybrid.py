"""Zamba2-style hybrid: a Mamba2 backbone with one shared attention block.

The counterpart of the JAX package's `repro.models.hybrid`.
`n_layers` Mamba2 blocks run in `n_groups` groups of `attn_every`; after
each group one *shared* attention + SwiGLU block runs, a single parameter
set reused at every application. Each application has its own KV cache,
since its states differ.

Layout: the JAX tree stacks the Mamba2 blocks (n_groups, attn_every, ...)
and drives them by a nested scan; here `HybridLM.blocks` is one list in the
same order (block e of group g at g * attn_every + e) and `models.bridge`
maps between the two. The decode state is ``{"cache": {"mamba": {"conv",
"ssm"} leaves (G, E, B, ...) f32, "attn": {"k", "v"} (G, B, max_len, KV,
hd) bf16}, "index"}``, written in place by the serving forwards;
`hybrid_loss`, the training forward, runs the backbone with no cache.

Under tensor-parallel serving the Mamba2 blocks hold their rank's SSD
heads (`models.ssm`) and the shared block its attention heads and FFN
columns (`models.layers`); the cache holds the same heads, its batch axis
(axis 2 of the Mamba2 leaves) whole on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import tp as TP
from repro_torch.distributed.sharding import local_state_shape
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def n_groups(cfg: ModelConfig) -> int:
    """Applications of the shared block: n_layers / attn_every."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"attn_every={cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


class HybridLM(nn.Module):
    """The weights of a hybrid LM, allocated uninitialised on `device` (the
    card unless the caller asks for the CPU): ``embed``, the Mamba2
    ``blocks``, the ``shared_attn`` dense block, ``ln_f`` and ``head``
    (None when the embeddings are tied). Fill them with `hybrid_init` or
    `bridge.params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        """Allocate every parameter, uninitialised, on `device`."""
        super().__init__()
        if cfg.kind != "hybrid":
            raise ValueError(f"HybridLM holds kind='hybrid', not "
                             f"{cfg.kind!r}")
        # the JAX tree's (n_groups, attn_every) stacking of `blocks`
        self.group_shape = (n_groups(cfg), cfg.attn_every)
        dev = resolve_device(device)
        dt = L.torch_dtype(cfg.param_dtype)
        self.embed = L.frozen_params(dev, dt, table=(cfg.vocab, cfg.d_model))
        self.blocks = nn.ModuleList(
            ssm.Mamba2Block(cfg, dev) for _ in range(cfg.n_layers))
        self.shared_attn = tfm.DenseBlock(cfg, dev)
        self.ln_f = L.frozen_params(dev, dt, scale=(cfg.d_model,))
        self.head = (None if cfg.tie_embeddings
                     else tfm.head_params(dev, dt, cfg.d_model, cfg.vocab))

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.embed["table"].device


def hybrid_init(cfg: ModelConfig, generator: torch.Generator | None, *,
                device: str | torch.device = "cuda") -> HybridLM:
    """A `HybridLM` on `device` with random weights drawn from `generator`
    (`transformer.init_weights`' scales; on ``meta``, shapes only)."""
    return tfm.init_weights(HybridLM(cfg, device), cfg, generator)


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int,
                      kv_dtype: torch.dtype = torch.bfloat16, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed hybrid cache: the Mamba2 state (G, E, B, ...) in f32 and one
    KV cache per application of the shared block, (G, B, max_len, KV,
    hd); this rank's heads of each under tensor parallelism."""
    g, e = n_groups(cfg), cfg.attn_every
    dev = resolve_device(device)
    mamba = {k: v.reshape(g, e, *v.shape[1:]) for k, v in
             ssm.init_mamba2_cache(cfg, batch, device=dev).items()}
    shape = local_state_shape("k", (g, batch, max_len, cfg.kv_heads,
                                    cfg.hd))
    return {"mamba": mamba,
            "attn": {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                     "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}}


def init_hybrid_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """The zeroed decode state the first chunk writes into: the cache under
    ``"cache"`` (the reference's key) and a per-row ``index``."""
    dev = resolve_device(device)
    return {"cache": init_hybrid_cache(cfg, batch, max_len, device=dev),
            "index": torch.zeros((batch,), dtype=torch.long, device=dev)}


def _group(model: HybridLM, g: int, x: torch.Tensor, cfg: ModelConfig,
           positions, cache: dict | None = None, cache_index=None,
           seq_lens=None) -> torch.Tensor:
    """Group `g`: its Mamba2 blocks, then the shared block, over the
    group's views of `cache` (written in place), or with no cache. Each
    block's leaves cut over "data" are gathered here, inside what `remat`
    recomputes (FSDP: `distributed.fsdp`). Under sequence parallelism
    the Mamba2 blocks, whose scans need the whole sequence, run on it
    whole, and the shared block on this rank's block of it: cut at its
    entry (`tp.split_to_model`: the gradient gathered) and gathered at
    the group's edge (`tp.gather_from_model`: the gradient's block
    kept), so the backbone around it sees no sequence parallelism."""
    E = cfg.attn_every
    for e in range(E):
        x = ssm.mamba2_block_apply(
            fsdp.gathered(model.blocks[g * E + e]), x, cfg,
            positions=positions,
            cache=None if cache is None else {
                k: v[g, e] for k, v in cache["mamba"].items()},
            cache_index=cache_index, seq_lens=seq_lens)[0]
    sp = TP.sequence_parallel(cfg, x.shape[1])
    if sp:
        x = TP.split_to_model(x, 1)
    x = tfm.dense_block_apply(
        fsdp.gathered(model.shared_attn), x, cfg, positions=positions,
        cache=None if cache is None else {
            k: v[g] for k, v in cache["attn"].items()},
        cache_index=cache_index, seq_lens=seq_lens)[0]
    return TP.gather_from_model(x, 1) if sp else x


def _backbone(model: HybridLM, x: torch.Tensor, cfg: ModelConfig, *,
              positions, cache: dict | None = None, cache_index=None,
              seq_lens=None):
    """Every group in order. With `cache` (serving) each writes its views
    in place; without (training) each group runs under
    `transformer.remat`, the unit the JAX package checkpoints."""
    for g in range(n_groups(cfg)):
        if cache is None:
            x = tfm.remat(cfg, _group, model, g, x, cfg, positions)
        else:
            x = _group(model, g, x, cfg, positions, cache, cache_index,
                       seq_lens)
    return x


def _head(model: HybridLM, x: torch.Tensor, cfg: ModelConfig):
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    return tfm._unembed(model, x, cfg)


def hybrid_loss(model: HybridLM, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """The training forward over ``batch["tokens"]`` (B, S): embed, the
    backbone with no cache (the shared block's gradient summed over its
    applications), then `transformer.head_loss`. Returns (loss, metrics:
    nll, accuracy, loss), the metrics detached; no aux loss, as in the JAX
    package."""
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _backbone(model, tfm._embed(model, tokens, cfg), cfg,
                  positions=positions)
    loss, metrics = tfm.head_loss(model, x, batch, cfg)
    metrics["loss"] = loss.detach()
    return loss, metrics


@torch.no_grad()
def hybrid_prefill(model: HybridLM, batch: dict, cfg: ModelConfig,
                   max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Serving prefill (the contract of `transformer.lm_prefill`): with
    ``batch["lengths"]`` each row's logits at its last valid position and a
    per-row ``index``, `seq_lens` stopping the SSD state at each row's last
    valid token; else the logits at S-1 and a scalar ``index``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    lengths = batch.get("lengths")
    positions = torch.arange(S, device=dev).expand(B, S)
    cache = batch.get("cache")
    if cache is None:
        cache = init_hybrid_cache(cfg, B, max_len or S, device=dev)
    lens = None if lengths is None else lengths.long()
    x = _backbone(model, tfm._embed(model, tokens, cfg), cfg,
                  positions=positions, cache=cache, cache_index=0,
                  seq_lens=lens)
    if lens is None:
        return _head(model, x[:, -1:], cfg)[:, 0], {
            "cache": cache, "index": torch.tensor(S, device=dev)}
    last = x[torch.arange(B, device=dev), lens - 1][:, None]
    return _head(model, last, cfg)[:, 0], {"cache": cache, "index": lens}


@torch.no_grad()
def hybrid_prefill_chunk(model: HybridLM, tokens: torch.Tensor,
                         lengths: torch.Tensor, state: dict,
                         cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One admission-prefill chunk (see `transformer.lm_prefill_chunk`):
    per-row bases in ``state["index"]``, right-padded rows, the SSD state
    carried across chunk boundaries bit-exactly."""
    B, S = tokens.shape
    dev = tokens.device
    base = state["index"].long()
    lens = lengths.long()
    positions = base[:, None] + torch.arange(S, device=dev)[None, :]
    x = _backbone(model, tfm._embed(model, tokens, cfg), cfg,
                  positions=positions, cache=state["cache"],
                  cache_index=base, seq_lens=lens)
    last = x[torch.arange(B, device=dev), (lens - 1).clamp(min=0)][:, None]
    return _head(model, last, cfg)[:, 0], {"cache": state["cache"],
                                           "index": base + lens}


@torch.no_grad()
def hybrid_decode_step(model: HybridLM, token: torch.Tensor, state: dict,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode; ``index`` is a scalar (wave) or (B,) (continuous:
    each slot at its own position)."""
    B = token.shape[0]
    idx = state["index"]
    positions = (idx.long().expand(B) if idx.dim() == 0
                 else idx.long())[:, None]
    x = _backbone(model, tfm._embed(model, token[:, None], cfg), cfg,
                  positions=positions, cache=state["cache"], cache_index=idx)
    return _head(model, x, cfg)[:, 0], {"cache": state["cache"],
                                        "index": idx + 1}
