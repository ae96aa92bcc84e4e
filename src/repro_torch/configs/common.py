"""Input specs of the assigned shape cells: the port's copy of the JAX
package's `repro.configs.common` (and of the shape table its
`repro.configs` holds).

A spec is a `Spec`, a (shape, dtype) record; its `meta()` builds a meta
tensor of that shape and dtype, the port's counterpart of a
``jax.ShapeDtypeStruct`` handed to ``jit(...).lower``: no storage, so a
full-width cell's inputs cost nothing to build (`meta_tree` maps a whole
spec tree).

Shape semantics (as in the reference):
  train_4k / prefill_32k  -> full-sequence step at (global_batch, seq_len)
  decode_32k / long_500k  -> ONE new token against a cache of seq_len

The decode state follows the port's layout, which is what each family's
`ModelApi.init_state` builds, not the reference's. The leaves that differ:

* ``index`` is (B,) int64 for every family (the reference: () int32 for
  the LM and hybrid kinds, (B,) int32 for vlm and encdec): the port's
  states carry a per-row position.
* vlm ``pos_off`` and encdec ``src_len`` are int64 (the reference: int32).
* encdec ``xk``/``xv`` are (L, B, seq_len, KV, hd): the port's cross-KV
  shares the row's length budget (`encdec.encdec_init_state`); the
  reference sizes them to the source, (L, B, src_len(seq_len), KV, hd).

Every other leaf (tokens, labels, the caches' shapes and dtypes, the
modality inputs) is the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_DEFS = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "step": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "step": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "step": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "step": "decode"},
}

# the decode state's position leaves in the port's layout
INDEX_DTYPE = torch.int64


@dataclasses.dataclass(frozen=True)
class Spec:
    """One input's shape and dtype."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        """An empty meta tensor of this shape and dtype."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def meta_tree(tree):
    """`tree` (nested dicts of `Spec`) with every spec as its meta
    tensor."""
    if isinstance(tree, Spec):
        return tree.meta()
    return {k: meta_tree(v) for k, v in tree.items()}


def _bs(shape: str, smoke: bool) -> tuple[int, int]:
    d = SHAPE_DEFS[shape]
    if smoke:
        return (2, min(d["seq_len"], 64))
    return (d["global_batch"], d["seq_len"])


def lm_train_specs(cfg: ModelConfig, shape: str, smoke: bool = False) -> dict:
    """tokens and labels, (B, S) int32."""
    B, S = _bs(shape, smoke)
    return {"tokens": Spec((B, S), torch.int32),
            "labels": Spec((B, S), torch.int32)}


def lm_prefill_specs(cfg: ModelConfig, shape: str, smoke: bool = False
                     ) -> dict:
    """tokens, (B, S) int32."""
    B, S = _bs(shape, smoke)
    return {"tokens": Spec((B, S), torch.int32)}


def kv_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    """A dense KV cache, (L, B, S, KV, hd) bf16 per leaf."""
    kv = (cfg.n_layers, B, S, cfg.kv_heads, cfg.hd)
    return {"k": Spec(kv, torch.bfloat16), "v": Spec(kv, torch.bfloat16)}


def _cache_specs(cfg: ModelConfig, B: int, S: int, family: str) -> dict:
    L_ = cfg.n_layers
    if family == "kv":
        return kv_specs(cfg, B, S)
    if family == "mla":
        return {
            "c_kv": Spec((L_, B, S, cfg.kv_lora_rank), torch.bfloat16),
            "k_pe": Spec((L_, B, S, cfg.rope_head_dim), torch.bfloat16),
        }
    if family == "mamba1":
        return {
            "conv": Spec((L_, B, cfg.d_conv - 1, cfg.d_inner), torch.float32),
            "ssm": Spec((L_, B, cfg.d_inner, cfg.ssm_state), torch.float32),
        }
    if family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        e = cfg.attn_every
        conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        H = cfg.d_inner // cfg.ssm_headdim
        kv = (g, B, S, cfg.kv_heads, cfg.hd)
        return {
            "mamba": {
                "conv": Spec((g, e, B, cfg.d_conv - 1, conv_ch),
                             torch.float32),
                "ssm": Spec((g, e, B, H, cfg.ssm_state, cfg.ssm_headdim),
                            torch.float32),
            },
            "attn": {"k": Spec(kv, torch.bfloat16),
                     "v": Spec(kv, torch.bfloat16)},
        }
    raise ValueError(family)


def lm_decode_specs(cfg: ModelConfig, shape: str, family: str = "kv",
                    smoke: bool = False) -> dict:
    """Inputs of decode_step: token (B,) int32 and the state {kv or
    cache, index (B,)} (see the module docstring on ``index``)."""
    B, S = _bs(shape, smoke)
    key = "cache" if family == "hybrid" else "kv"
    state = {key: _cache_specs(cfg, B, S, family),
             "index": Spec((B,), INDEX_DTYPE)}
    return {"token": Spec((B,), torch.int32), "state": state}
