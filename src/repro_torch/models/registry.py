"""Uniform model API over every family: dense, moe, mla_moe, mamba1,
mamba2, hybrid, encdec and vlm.

    model = get_model(cfg)
    params = model.init(cfg, torch.Generator("cuda").manual_seed(0))
    logits, state = model.prefill(params, batch, cfg)
    logits, state = model.prefill_chunk(params, tokens, lengths, state, cfg)
    logits, state = model.decode_step(params, token, state, cfg)
    loss, metrics = model.loss(params, batch, cfg)          # training
    pool = model.init_page_pool(cfg, num_pages, page_size)  # KV kinds only
    state = model.admit(params, model.pack_admit(cfg, extras, w, bucket),
                        state, cfg)                          # encdec, vlm
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, vlm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """The functions the engine and the tests call for one family."""

    # (cfg, generator, *, device) -> params module; on device="meta" the
    # generator may be None: shapes and dtypes, no storage (the dry-run)
    init: Callable
    # the training forward: (params, batch, cfg) -> (loss, metrics), the
    # loss differentiable through every GEMM (batch: tokens and labels;
    # encdec adds src_embeds, vlm patch_embeds, positions_3d and loss_mask)
    loss: Callable
    prefill: Callable       # (params, batch, cfg, max_len=) -> (logits, state)
    decode_step: Callable   # (params, token, state, cfg) -> (logits, state)
    # (cfg, batch, max_len, *, device) -> cache; None for encdec, whose
    # cache is only ever built inside its decode state
    init_cache: Callable | None
    # chunked-admission prefill: (params, tokens (B, C), lengths (B,),
    # state, cfg) -> (last-valid logits (B, V), state); state carries a
    # per-row base ``index``. `init_state` builds the zeroed decode state
    # the first chunk writes into: (cfg, batch, max_len, *, device) -> state
    prefill_chunk: Callable
    init_state: Callable
    # paged-KV pool for the families the engine can serve paged: (cfg,
    # num_pages, page_size, *, device) -> pool leaves (L, P, T, ...); the
    # engine pairs it with per-row page tables (see serving.paging). SSM
    # and hybrid state is O(1) per row and stays dense: None.
    init_page_pool: Callable | None = None
    # prefill-once admission of the modality families (encdec: source
    # encoding and cross-KV; vlm: the patch prefix). A family is an "admit
    # family" iff `admit` is not None.
    #   admit_dims(cfg, extras) -> (prefix rows, source rows), host ints:
    #     the cache rows the admission writes ahead of the prompt, and the
    #     side (non-cache) source rows it encodes; raises on bad extras.
    #   pack_admit(cfg, extras_list, width, bucket, *, device) -> the
    #     admission batch (rows padded to `width`, sequence to `bucket`).
    #   admit(params, packed, state, cfg) -> state: writes the admission's
    #     leaves of a `width`-row state in place (the wave admits a whole
    #     batch in one call; chunked admission packs a step's fresh rows).
    admit_dims: Callable | None = None
    pack_admit: Callable | None = None
    admit: Callable | None = None


def _zero_index_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {"kv": tfm.init_cache(cfg, batch, max_len, device=dev),
            "index": torch.zeros((batch,), dtype=torch.long, device=dev)}


def _lm_api(paged: bool) -> ModelApi:
    """The API of the `TransformerLM` families (dense, moe, mla_moe, mamba1,
    mamba2): the forwards and `loss` pick the block function by
    ``cfg.kind``, `init_cache` the KV, MLA latent or SSM state layout, and
    `init_page_pool` (only where `paged`) the KV or MLA latent pool."""
    return ModelApi(
        init=tfm.lm_init,
        loss=tfm.lm_loss,
        prefill=tfm.lm_prefill,
        decode_step=tfm.lm_decode_step,
        init_cache=lambda cfg, b, ml, *, device="cuda": tfm.init_cache(
            cfg, b, ml, device=device),
        prefill_chunk=tfm.lm_prefill_chunk,
        init_state=_zero_index_state,
        init_page_pool=(lambda cfg, n, t, *, device="cuda": (
            tfm.init_page_pool(cfg, n, t, device=device))) if paged else None,
    )


def _hybrid_api() -> ModelApi:
    """The API of the hybrid family (`hybrid.HybridLM`); its state key is
    ``"cache"``, as in the reference."""
    return ModelApi(
        init=hybrid.hybrid_init,
        loss=hybrid.hybrid_loss,
        prefill=hybrid.hybrid_prefill,
        decode_step=hybrid.hybrid_decode_step,
        init_cache=lambda cfg, b, ml, *, device="cuda": (
            hybrid.init_hybrid_cache(cfg, b, ml, device=device)),
        prefill_chunk=hybrid.hybrid_prefill_chunk,
        init_state=hybrid.init_hybrid_state,
    )


def _kv_pool(cfg, n, t, *, device="cuda"):
    return tfm.init_kv_page_pool(cfg, n, t, device=device)


def _encdec_api() -> ModelApi:
    """The encoder-decoder family (`encdec.EncDecLM`); only the decoder's
    self-attention KV pages, the cross-KV stays a dense per-row leaf."""
    return ModelApi(
        init=encdec.encdec_init,
        loss=encdec.encdec_loss,
        prefill=encdec.encdec_prefill,
        decode_step=encdec.encdec_decode_step,
        init_cache=None,
        prefill_chunk=encdec.encdec_prefill_chunk,
        init_state=encdec.encdec_init_state,
        init_page_pool=_kv_pool,
        admit_dims=encdec.encdec_admit_dims,
        pack_admit=encdec.encdec_pack_admit,
        admit=encdec.encdec_admit,
    )


def _vlm_api() -> ModelApi:
    """The vision-language family: a dense `TransformerLM` with M-RoPE and
    a patch-prefix admission; pages its KV like a dense LM."""
    return ModelApi(
        init=vlm.vlm_init,
        loss=vlm.vlm_loss,
        prefill=vlm.vlm_prefill,
        decode_step=vlm.vlm_decode_step,
        init_cache=lambda cfg, b, ml, *, device="cuda": tfm.init_kv_cache(
            cfg, b, ml, device=device),
        prefill_chunk=vlm.vlm_prefill_chunk,
        init_state=vlm.vlm_init_state,
        init_page_pool=_kv_pool,
        admit_dims=vlm.vlm_admit_dims,
        pack_admit=vlm.vlm_pack_admit,
        admit=vlm.vlm_admit,
    )


_FAMILIES = {
    "dense": lambda: _lm_api(paged=True),
    "moe": lambda: _lm_api(paged=True),
    "mla_moe": lambda: _lm_api(paged=True),
    "mamba1": lambda: _lm_api(paged=False),
    "mamba2": lambda: _lm_api(paged=False),
    "hybrid": _hybrid_api,
    "encdec": _encdec_api,
    "vlm": _vlm_api,
}


def get_model(cfg: ModelConfig) -> ModelApi:
    """The `ModelApi` of ``cfg.kind``; an unknown kind raises KeyError."""
    if cfg.kind in _FAMILIES:
        return _FAMILIES[cfg.kind]()
    raise KeyError(f"unknown model kind {cfg.kind!r}")
