"""Qwen2-VL-style VLM backbone: a decoder-only dense LM with M-RoPE and a
stubbed vision frontend (precomputed patch embeddings, as in the
reference).

The counterpart of the JAX package's `repro.models.vlm` at tp=1. The
weights are a `transformer.TransformerLM` of dense blocks (kind "vlm");
`layers.attention_apply` rotates with M-RoPE because ``cfg.mrope``. The
sequence is [patch embeddings | text tokens]; M-RoPE position ids are
(t, h, w) triples: image patches advance h/w at t = 0, text advances all
three together from ``t0 = max(gh, gw)``.

Serving follows the prefill-once contract: the patch prefix runs through
the decoder once at admission (`vlm_admit`), writing its KV into rows
[0, prefix) of the cache (in place, dense or paged); the text then chunks
through `transformer.lm_prefill_chunk` with M-RoPE positions rebuilt per
row from ``index + pos_off``, where ``pos_off = t0 - n_patches`` is carried
in the decode state. A text-only request admits nothing and serves like a
dense LM. `vlm_loss`, the training forward, runs [patches | text] through
the blocks with no cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

vlm_init = tfm.lm_init


def build_mrope_positions(n_patches: int, grid_hw: tuple[int, int],
                          text_len: int, text_start: int = 0) -> np.ndarray:
    """(n_patches + text_len, 3) int32 position ids: patches at t = 0 on an
    h/w grid, then text rows ``text_start .. text_start + text_len`` at
    ``t0 + row`` on all three axes (``t0 = max(gh, gw)``). `text_start`
    lets a chunked text tail resume mid-sequence without the prefix."""
    gh, gw = grid_hw
    assert gh * gw == n_patches
    t0 = max(gh, gw)
    text = np.arange(text_start, text_start + text_len)[:, None] + t0
    text = np.repeat(text, 3, axis=1)
    if n_patches == 0:
        return text.astype(np.int32)
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    patch = np.stack([np.zeros(n_patches), hh.ravel(), ww.ravel()], axis=1)
    return np.concatenate([patch, text], axis=0).astype(np.int32)


def _mrope3(pos: torch.Tensor) -> torch.Tensor:
    """Text-token (..., 3) triples: all three axes share the scalar id."""
    return pos.long()[..., None].expand(*pos.shape, 3)


def _vlm_embed(model: tfm.TransformerLM, batch: dict,
               cfg: ModelConfig) -> torch.Tensor:
    """[patch embeddings | token embeddings] (B, P + S_txt, d) in the
    activation dtype."""
    tok = tfm._embed(model, batch["tokens"].long(), cfg)
    return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)


def vlm_loss(model: tfm.TransformerLM, batch: dict, cfg: ModelConfig
             ) -> tuple[torch.Tensor, dict]:
    """The training forward over [patches | text]: batch holds ``tokens``
    (B, S_txt), ``patch_embeds`` (B, P, d), ``positions_3d`` (B, P +
    S_txt, 3), ``labels`` (B, P + S_txt) and ``loss_mask`` (0 on the
    patches). The dense blocks with M-RoPE, each under
    `transformer.remat`, then `transformer.head_loss`. Returns (loss,
    metrics: nll, accuracy, loss), the metrics detached."""
    x = tfm.enter_sequence(model, _vlm_embed(model, batch, cfg), cfg)
    x, _ = tfm.train_stack(model.blocks, x, cfg,
                           positions=batch["positions_3d"].long(),
                           block=tfm.dense_block_apply)
    loss, metrics = tfm.head_loss(model, x, batch, cfg)
    metrics["loss"] = loss.detach()
    return loss, metrics


@torch.no_grad()
def vlm_prefill(model: tfm.TransformerLM, batch: dict, cfg: ModelConfig,
                max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Single-shot prefill of [patches | text]: batch holds ``tokens``
    (B, S_txt), ``patch_embeds`` (B, P, d) and ``positions_3d`` (B, P +
    S_txt, 3). Returns the last position's logits and the state with a
    scalar ``index = P + S_txt`` and per-row ``pos_off`` (next text id
    minus index: chunked and single-shot prefill share one layout)."""
    x = _vlm_embed(model, batch, cfg)
    B, S, _ = x.shape
    pos = batch["positions_3d"].long()
    cache = batch.get("cache")
    if cache is None:
        cache = tfm.init_kv_cache(cfg, B, max_len or S, device=x.device)
    x = tfm._run_blocks(model, x, cfg, positions=pos, cache=cache,
                        cache_index=0)
    x = L.rmsnorm(model.ln_f, x, cfg.norm_eps)
    logits = tfm._unembed(model, x[:, -1:], cfg)
    next_pos = pos[:, -1, 0] + 1
    return logits[:, 0], {"kv": cache,
                          "index": torch.tensor(S, device=x.device),
                          "pos_off": next_pos - S}


@torch.no_grad()
def vlm_decode_step(model: tfm.TransformerLM, token: torch.Tensor,
                    state: dict, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, dict]:
    """One-token decode at text id ``index + pos_off`` (index scalar or
    per row)."""
    off, idx = state["pos_off"].long(), state["index"]
    logits, st = tfm.lm_decode_step(
        model, token, {"kv": state["kv"], "index": idx}, cfg,
        positions=_mrope3((idx.long() + off)[:, None]))
    return logits, {**st, "pos_off": off}


# ---------------- serving (patch-prefix admission + chunked text) --------

def vlm_init_state(cfg: ModelConfig, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda") -> dict:
    """The zeroed decode state: KV cache, per-row ``index`` and
    ``pos_off``."""
    dev = resolve_device(device)
    return {"kv": tfm.init_kv_cache(cfg, batch, max_len, device=dev),
            "index": torch.zeros((batch,), dtype=torch.long, device=dev),
            "pos_off": torch.zeros((batch,), dtype=torch.long, device=dev)}


def vlm_admit_dims(cfg: ModelConfig, extras: dict | None
                   ) -> tuple[int, int]:
    """(cache-prefix rows, source rows): the patch prefix occupies cache
    rows; there is no side source. A text-only request admits nothing."""
    if not extras or "patch_embeds" not in extras:
        return 0, 0
    return int(np.asarray(extras["patch_embeds"]).shape[0]), 0


def vlm_pack_admit(cfg: ModelConfig, extras_list: list, width: int,
                   bucket: int, *, device: str | torch.device = "cuda"
                   ) -> dict:
    """The admission batch on `device`: patch embeddings right-padded to
    the shared `bucket`, rows padded to `width`, the grid's M-RoPE
    positions and each row's ``pos_off = t0 - n_patches``."""
    pe = np.zeros((width, bucket, cfg.d_model), np.float32)
    plen = np.zeros((width,), np.int64)
    off = np.zeros((width,), np.int64)
    pos = np.zeros((width, bucket, 3), np.int64)
    for i, ex in enumerate(extras_list):
        if not ex or "patch_embeds" not in ex:
            continue
        e = np.asarray(ex["patch_embeds"], np.float32)
        p = e.shape[0]
        gh, gw = ex["grid_hw"]
        pe[i, :p] = e
        plen[i] = p
        pos[i, :p] = build_mrope_positions(p, (gh, gw), 0)
        off[i] = max(gh, gw) - p
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in (
        ("patch_embeds", pe), ("prefix_len", plen), ("pos_off", off),
        ("positions", pos))}


@torch.no_grad()
def vlm_admit(model: tfm.TransformerLM, packed: dict, state: dict,
              cfg: ModelConfig) -> dict:
    """Prefill-once admission: run the patch prefix through the decoder,
    writing its KV in place into rows [0, prefix_len) of each row's cache
    (dense or paged; `seq_lens` masks pad rows' writes), and start the text
    at ``index = prefix_len``. Attention is causal over the prefix, as in
    `vlm_prefill`'s single pass."""
    plen = packed["prefix_len"].long()
    x = packed["patch_embeds"].to(L.torch_dtype(cfg.activation_dtype))
    tfm._run_blocks(model, x, cfg, positions=packed["positions"],
                    cache=state["kv"], cache_index=torch.zeros_like(plen),
                    seq_lens=plen)
    return {**state, "index": plen, "pos_off": packed["pos_off"].long()}


@torch.no_grad()
def vlm_prefill_chunk(model: tfm.TransformerLM, tokens: torch.Tensor,
                      lengths: torch.Tensor, state: dict, cfg: ModelConfig
                      ) -> tuple[torch.Tensor, dict]:
    """One text chunk via `transformer.lm_prefill_chunk`, M-RoPE positions
    rebuilt per row from the cache index plus the admission offset."""
    S = tokens.shape[1]
    off, base = state["pos_off"].long(), state["index"].long()
    pos = (base + off)[:, None] + torch.arange(S, device=tokens.device)
    logits, st = tfm.lm_prefill_chunk(
        model, tokens, lengths, {"kv": state["kv"], "index": base}, cfg,
        positions=_mrope3(pos))
    return logits, {**st, "pos_off": off}
