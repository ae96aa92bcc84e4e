"""Encoder-decoder transformer (the Seamless-M4T medium backbone).

The counterpart of the JAX package's `repro.models.encdec` at tp=1. The
modality frontend is a stub, as in the reference: ``src_embeds`` arrive as
precomputed speech-frame embeddings (T_src, d_model). The text decoder is a
causal transformer with cross-attention into the encoder output.

Layout: the JAX tree stacks ``encoder`` and ``decoder`` blocks on a leading
L axis; here `EncDecLM.encoder` and `EncDecLM.decoder` are lists of
modules in the same order (`models.bridge` maps between the two).

Serving follows the prefill-once contract: the encoder and every decoder
layer's cross-attention KV run once at admission (`encdec_admit`) and land
in the decode state beside the self-attention cache, as ``xk``/``xv``
leaves (L, B, max_len, KV, hd) of `max_len` source-row capacity, read-only
afterwards, with a per-row ``src_len`` masking the cross-attention keys.
The decoder's self-attention then chunks through the `transformer`
generics like any LM. Every projection, the cross-KV included, goes
through `kernels.ops.matmul`, by way of the tensor-parallel wrappers
(`distributed.tp`), so under tp the cross-KV holds this rank's heads.
`encdec_loss`, the training forward, encodes the source and runs the
decoder with no cache, each layer projecting its cross-attention KV from
the encoder output. Under tensor-parallel training (psum mode) every
block's input, the cross-attention's query input and each layer's
encoder output enter their sharded projections (`tp.enter`), and the
row-parallel ``wo`` and ``w_down`` take their whole contraction widths.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import tp as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


class EncBlock(nn.Module):
    """Bidirectional encoder block: RMSNorm -> attention -> RMSNorm ->
    FFN."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = L.torch_dtype(cfg.param_dtype)
        self.ln1 = L.frozen_params(device, dt, scale=(cfg.d_model,))
        self.attn = L.frozen_params(device, dt, **tfm._gqa_shapes(cfg))
        self.ln2 = L.frozen_params(device, dt, scale=(cfg.d_model,))
        self.mlp = L.frozen_params(device, dt,
                                   **tfm._mlp_shapes(cfg, cfg.d_ff))


class DecBlock(nn.Module):
    """Decoder block: RMSNorm -> causal self-attention -> RMSNorm ->
    cross-attention -> RMSNorm -> FFN."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        """Allocate the block's parameters, uninitialised, on `device`."""
        super().__init__()
        dt = L.torch_dtype(cfg.param_dtype)
        self.ln1 = L.frozen_params(device, dt, scale=(cfg.d_model,))
        self.self_attn = L.frozen_params(device, dt, **tfm._gqa_shapes(cfg))
        self.ln_x = L.frozen_params(device, dt, scale=(cfg.d_model,))
        self.cross_attn = L.frozen_params(device, dt,
                                          **tfm._gqa_shapes(cfg))
        self.ln2 = L.frozen_params(device, dt, scale=(cfg.d_model,))
        self.mlp = L.frozen_params(device, dt,
                                   **tfm._mlp_shapes(cfg, cfg.d_ff))


class EncDecLM(nn.Module):
    """The weights of an encoder-decoder LM, allocated uninitialised on
    `device` (the card unless the caller asks for the CPU): ``embed``, the
    ``encoder`` blocks, ``enc_ln_f``, the ``decoder`` blocks, ``ln_f`` and
    ``head`` (`transformer.head_params`). Fill them with `encdec_init` or
    `bridge.params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        """Allocate every parameter, uninitialised, on `device`."""
        super().__init__()
        if cfg.kind != "encdec":
            raise ValueError(f"EncDecLM holds kind='encdec', not "
                             f"{cfg.kind!r}")
        dev = resolve_device(device)
        dt = L.torch_dtype(cfg.param_dtype)
        self.embed = L.frozen_params(dev, dt, table=(cfg.vocab, cfg.d_model))
        self.encoder = nn.ModuleList(
            EncBlock(cfg, dev) for _ in range(cfg.n_encoder_layers))
        self.enc_ln_f = L.frozen_params(dev, dt, scale=(cfg.d_model,))
        self.decoder = nn.ModuleList(
            DecBlock(cfg, dev) for _ in range(cfg.n_layers))
        self.ln_f = L.frozen_params(dev, dt, scale=(cfg.d_model,))
        self.head = tfm.head_params(dev, dt, cfg.d_model, cfg.vocab)

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.embed["table"].device


def encdec_init(cfg: ModelConfig, generator: torch.Generator | None, *,
                device: str | torch.device = "cuda") -> EncDecLM:
    """An `EncDecLM` on `device` with random weights drawn from `generator`
    (`transformer.init_weights`' scales; on ``meta``, shapes only)."""
    return tfm.init_weights(EncDecLM(cfg, device), cfg, generator)


# ---------------- blocks ----------------

def enc_block_apply(blk: EncBlock, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, src_lens: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Bidirectional encoder block. `src_lens` masks the attention keys to
    each row's valid source rows (non-causal attention over a right-padded
    batch needs it)."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    attn, _ = L.attention_apply(blk.attn, h, cfg, positions=positions,
                                causal=False, kv_lens=src_lens)
    x = x + attn
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    return x + L.swiglu_apply(blk.mlp, h, cfg, cfg.d_ff)


def _enc_layer(blk: EncBlock, x: torch.Tensor, cfg: ModelConfig, *,
               positions, src_lens=None) -> torch.Tensor:
    """One encoder block, its leaves cut over "data" gathered first,
    inside what `remat` recomputes (FSDP: `distributed.fsdp`)."""
    return enc_block_apply(fsdp.gathered(blk), x, cfg, positions=positions,
                           src_lens=src_lens)


def encode(model: EncDecLM, src_embeds: torch.Tensor, cfg: ModelConfig,
           src_lens: torch.Tensor | None = None) -> torch.Tensor:
    """The encoder over (B, T, d) source embeddings: every block (each
    under `transformer.remat` where autograd records), then
    ``enc_ln_f``."""
    B, T, _ = src_embeds.shape
    positions = torch.arange(T, device=src_embeds.device).expand(B, T)
    x = src_embeds.to(L.torch_dtype(cfg.activation_dtype))
    for blk in model.encoder:
        x = tfm.remat(cfg, _enc_layer, blk, x, cfg, positions=positions,
                      src_lens=src_lens)
    return L.rmsnorm(model.enc_ln_f, x, cfg.norm_eps)


def _cross_kv(p, memory: torch.Tensor, cfg: ModelConfig) -> dict:
    """One decoder layer's cross-attention keys and values over the
    encoder output: (B, T, KV, hd) each (this rank's KV/tp heads under
    tensor parallelism: column-parallel projections, `tp.tp_column`; in
    psum mode `memory` enters them, so its gradient, each rank's heads'
    share, is summed over "model" in every layer)."""
    B, T, _ = memory.shape
    hd = cfg.hd
    n_kv = cfg.kv_heads * hd
    memory = TP.enter(memory, cfg, p["wk"], n_kv)
    k = TP.tp_column(memory, p["wk"], cfg, n_kv)
    v = TP.tp_column(memory, p["wv"], cfg, n_kv)
    if cfg.qkv_bias:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return {"k": k.reshape(B, T, -1, hd), "v": v.reshape(B, T, -1, hd)}


def _cross_attend(p, x: torch.Tensor, ckv: dict, cfg: ModelConfig, *,
                  kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-attention over a precomputed (right-padded) memory KV;
    `kv_len` masks each row's keys to its true source length. The keys are
    the state's ``max_len`` rows in every call, so their count never
    depends on the call."""
    B, S, d = x.shape
    hd = cfg.hd
    n_q = cfg.n_heads * hd
    q = TP.tp_column(TP.enter(x, cfg, p["wq"], n_q), p["wq"], cfg, n_q)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(B, S, -1, hd)
    out = L._sdpa(q, ckv["k"].to(q.dtype), ckv["v"].to(q.dtype),
                  causal=False, kv_len=kv_len)
    return TP.tp_row(out.reshape(B, S, -1), p["wo"], cfg, d, n_q)


def dec_block_apply(blk: DecBlock, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, cross_kv: dict, cache: dict | None = None,
                    cache_index=None, seq_lens=None,
                    src_lens: torch.Tensor | None = None) -> tuple:
    """Decoder block: causal self-attention (over a dense or paged `cache`,
    written in place, or none), cross-attention over `cross_kv` ({"k",
    "v"}, masked to `src_lens`), FFN. Returns (x, self-attention cache)."""
    h = L.rmsnorm(blk.ln1, x, cfg.norm_eps)
    attn, new_cache = L.attention_apply(
        blk.self_attn, h, cfg, positions=positions, kv_cache=cache,
        cache_index=cache_index, seq_lens=seq_lens)
    x = x + attn
    h = L.rmsnorm(blk.ln_x, x, cfg.norm_eps)
    x = x + _cross_attend(blk.cross_attn, h, cross_kv, cfg, kv_len=src_lens)
    h = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    return x + L.swiglu_apply(blk.mlp, h, cfg, cfg.d_ff), new_cache


def dec_serve_block(blk: DecBlock, x: torch.Tensor, cfg: ModelConfig, *,
                    positions, cache: dict, cache_index=None, seq_lens=None,
                    src_len: torch.Tensor | None = None):
    """Serving decoder block over the fused decode cache: self-attention
    KV (dense ``k``/``v`` or paged ``k_pages``/``v_pages``/``table``,
    written in place) plus the admission's cross-attention KV (``xk``/
    ``xv``, read-only, masked to `src_len`). The block contract of the
    `transformer` generics: returns (x, cache, 0.0)."""
    sa = {k: v for k, v in cache.items() if k not in ("xk", "xv")}
    x, new_sa = dec_block_apply(
        blk, x, cfg, positions=positions,
        cross_kv={"k": cache["xk"], "v": cache["xv"]}, cache=sa,
        cache_index=cache_index, seq_lens=seq_lens, src_lens=src_len)
    return x, {**new_sa, "xk": cache["xk"], "xv": cache["xv"]}, 0.0


def _dec_train_layer(blk: DecBlock, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig, positions) -> torch.Tensor:
    """One decoder layer of the training forward: its cross-attention KV
    from the encoder output, then the block with no cache (its leaves cut
    over "data" gathered first, inside what `remat` recomputes)."""
    blk = fsdp.gathered(blk)
    return dec_block_apply(blk, x, cfg, positions=positions,
                           cross_kv=_cross_kv(blk.cross_attn, memory,
                                              cfg))[0]


def _decode_stack(model: EncDecLM, x: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig, *, positions) -> torch.Tensor:
    """The decoder of the training forward: every layer, each under
    `transformer.remat`, projecting its cross-attention KV from `memory`
    on the fly (its gradient summed over the layers)."""
    for blk in model.decoder:
        x = tfm.remat(cfg, _dec_train_layer, blk, x, memory, cfg, positions)
    return x


def encdec_loss(model: EncDecLM, batch: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """The training forward: ``batch["src_embeds"]`` (B, T, d) through the
    encoder, ``batch["tokens"]`` (B, S) through the decoder over it, then
    `transformer.head_loss` against ``batch["labels"]``. Returns (loss,
    metrics: nll, accuracy, loss), the metrics detached."""
    memory = encode(model, batch["src_embeds"], cfg)
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _decode_stack(model, tfm._embed(model, tokens, cfg), memory, cfg,
                      positions=positions)
    loss, metrics = tfm.head_loss(model, x, batch, cfg)
    metrics["loss"] = loss.detach()
    return loss, metrics


# ---------------- serving (prefill-once admission + chunked decode) -------

def encdec_init_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """The zeroed decode state: the self-attention KV cache plus the
    cross-attention KV (``xk``/``xv``, (L, B, max_len, KV, hd) bf16: the
    source shares the row's length budget) and per-row ``src_len`` and
    ``index``."""
    dev = resolve_device(device)
    kv = tfm.init_kv_cache(cfg, batch, max_len, device=dev)
    kv["xk"] = torch.zeros_like(kv["k"])
    kv["xv"] = torch.zeros_like(kv["v"])
    return {"kv": kv,
            "src_len": torch.zeros((batch,), dtype=torch.long, device=dev),
            "index": torch.zeros((batch,), dtype=torch.long, device=dev)}


def encdec_admit_dims(cfg: ModelConfig, extras: dict | None
                      ) -> tuple[int, int]:
    """(cache-prefix rows, source rows) one request's admission consumes:
    the encoder writes no decoder-cache rows; the source length sizes the
    cross-KV and the admission's GEMMs. Raises without ``src_embeds``."""
    if not extras or "src_embeds" not in extras:
        raise ValueError(
            "encdec requests need extras={'src_embeds': (T_src, d_model)}")
    return 0, int(np.asarray(extras["src_embeds"]).shape[0])


def encdec_pack_admit(cfg: ModelConfig, extras_list: list, width: int,
                      bucket: int, *, device: str | torch.device = "cuda"
                      ) -> dict:
    """The admission batch on `device`: source embeddings right-padded to
    the shared `bucket`, rows padded to `width` (pad rows all zero with
    src_len 0: fully masked downstream)."""
    src = np.zeros((width, bucket, cfg.d_model), np.float32)
    sl = np.zeros((width,), np.int64)
    for i, ex in enumerate(extras_list):
        if not ex:
            continue
        e = np.asarray(ex["src_embeds"], np.float32)
        src[i, :e.shape[0]] = e
        sl[i] = e.shape[0]
    dev = resolve_device(device)
    return {"src_embeds": torch.as_tensor(src, device=dev),
            "src_len": torch.as_tensor(sl, device=dev)}


@torch.no_grad()
def encdec_admit(model: EncDecLM, packed: dict, state: dict,
                 cfg: ModelConfig) -> dict:
    """Prefill-once admission: encode the padded source and write every
    decoder layer's cross-attention KV in place into the first T rows of
    ``xk``/``xv``. Touches only those leaves and ``src_len``; the
    self-attention cache (dense or paged) is left alone. A request's
    encoding does not depend on the bucket or batch its admission shares,
    on the card too (`layers._sdpa`)."""
    src_len = packed["src_len"].long()
    kv = state["kv"]
    memory = encode(model, packed["src_embeds"], cfg, src_lens=src_len)
    T = memory.shape[1]
    for i, blk in enumerate(model.decoder):
        cross = _cross_kv(fsdp.gathered(blk.cross_attn), memory, cfg)
        kv["xk"][i, :, :T] = cross["k"]
        kv["xv"][i, :, :T] = cross["v"]
    return {**state, "src_len": src_len}


@torch.no_grad()
def encdec_prefill_chunk(model: EncDecLM, tokens: torch.Tensor,
                         lengths: torch.Tensor, state: dict,
                         cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One admission-prefill chunk of the decoder (the contract of
    `transformer.lm_prefill_chunk`); the cross-KV rides along
    read-only."""
    src_len = state["src_len"]
    logits, st = tfm.lm_prefill_chunk(
        model, tokens, lengths, {"kv": state["kv"], "index": state["index"]},
        cfg, block=functools.partial(dec_serve_block, src_len=src_len),
        blocks=model.decoder)
    return logits, {**st, "src_len": src_len}


@torch.no_grad()
def encdec_decode_step(model: EncDecLM, token: torch.Tensor, state: dict,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode of the decoder over the fused cache."""
    src_len = state["src_len"]
    logits, st = tfm.lm_decode_step(
        model, token, {"kv": state["kv"], "index": state["index"]}, cfg,
        block=functools.partial(dec_serve_block, src_len=src_len),
        blocks=model.decoder)
    return logits, {**st, "src_len": src_len}


@torch.no_grad()
def encdec_prefill(model: EncDecLM, batch: dict, cfg: ModelConfig,
                   max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Single-shot prefill: admission (encode + cross-KV) plus one decoder
    chunk over the whole prompt, the serving engine's own path, so the
    state matches a chunked prefill of the same rows bit for bit. batch:
    ``tokens`` (B, S), ``src_embeds`` (B, T, d), optional ``src_lens`` and
    ``lengths`` (B,)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    src = batch["src_embeds"]
    src_lens = batch.get("src_lens")
    if src_lens is None:
        src_lens = torch.full((B,), src.shape[1], device=dev)
    state = encdec_init_state(cfg, B, max_len or S, device=dev)
    state = encdec_admit(model, {"src_embeds": src, "src_len": src_lens},
                         state, cfg)
    lengths = batch.get("lengths")
    if lengths is None:
        lengths = torch.full((B,), S, device=dev)
    return encdec_prefill_chunk(model, tokens, lengths, state, cfg)
