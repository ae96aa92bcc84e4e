"""Uniform model API over the ported families (dense only so far).

    model = get_model(cfg)
    params = model.init(cfg, torch.Generator("cuda").manual_seed(0))
    logits, state = model.prefill(params, batch, cfg)
    logits, state = model.prefill_chunk(params, tokens, lengths, state, cfg)
    logits, state = model.decode_step(params, token, state, cfg)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """The functions the engine and the tests call for one family."""

    init: Callable          # (cfg, generator, *, device) -> params module
    prefill: Callable       # (params, batch, cfg, max_len=) -> (logits, state)
    decode_step: Callable   # (params, token, state, cfg) -> (logits, state)
    init_cache: Callable    # (cfg, batch, max_len, *, device) -> cache
    # chunked-admission prefill: (params, tokens (B, C), lengths (B,),
    # state, cfg) -> (last-valid logits (B, V), state); state carries a
    # per-row base ``index``. `init_state` builds the zeroed decode state
    # the first chunk writes into: (cfg, batch, max_len, *, device) -> state
    prefill_chunk: Callable
    init_state: Callable


def _zero_index_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {"kv": tfm.init_kv_cache(cfg, batch, max_len, device=dev),
            "index": torch.zeros((batch,), dtype=torch.long, device=dev)}


def _dense_api() -> ModelApi:
    return ModelApi(
        init=tfm.lm_init,
        prefill=tfm.lm_prefill,
        decode_step=tfm.lm_decode_step,
        init_cache=lambda cfg, b, ml, *, device="cuda": tfm.init_kv_cache(
            cfg, b, ml, device=device),
        prefill_chunk=tfm.lm_prefill_chunk,
        init_state=_zero_index_state,
    )


# the JAX package's other families -> the ROADMAP item that ports them
_NOT_YET_PORTED = {
    "moe": "A4 (MoE/MLA)",
    "mla_moe": "A4 (MoE/MLA)",
    "mamba1": "A5 (SSM/hybrid)",
    "mamba2": "A5 (SSM/hybrid)",
    "hybrid": "A5 (SSM/hybrid)",
    "encdec": "A6 (encdec/vlm)",
    "vlm": "A6 (encdec/vlm)",
}


def get_model(cfg: ModelConfig) -> ModelApi:
    """The `ModelApi` of ``cfg.kind``; unported kinds raise
    `NotImplementedError` naming their ROADMAP item."""
    if cfg.kind == "dense":
        return _dense_api()
    if cfg.kind in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"kind={cfg.kind!r} is not ported yet: ROADMAP queue "
            f"{_NOT_YET_PORTED[cfg.kind]}")
    raise KeyError(f"unknown model kind {cfg.kind!r}")
