"""seamless-m4t-medium — 12L enc + 12L dec, d_model=1024 16H d_ff=4096
vocab=256206, speech frontend stubbed as precomputed frame embeddings
[arXiv:2308.11596]."""

import torch

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def src_len(seq_len: int) -> int:
    """Source frames a training or prefill sequence of `seq_len` target
    tokens comes with: a quarter of it, at least 8 (the reference's rule
    for its input shapes)."""
    return max(seq_len // 4, 8)


def full_config() -> ModelConfig:
    """The published seamless-m4t-medium backbone (plain GELU FFN)."""
    return ModelConfig(
        name="seamless-m4t-medium",
        kind="encdec",
        n_layers=12,
        n_encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        gated_mlp=False,   # conformer/NLLB-style plain FFN
    )


def smoke_config() -> ModelConfig:
    """2 + 2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="seamless-m4t-medium-smoke",
        kind="encdec",
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        param_dtype="float32",
        activation_dtype="float32",
        remat=False,
    )


def input_specs(shape: str, smoke: bool = False) -> dict:
    """The inputs of `shape`'s step: the source frames ((B, src_len(S),
    d) bf16) beside the target tokens; the decode state in the port's
    layout, its cross-KV sized to the row's budget S (`configs.common`)."""
    cfg = smoke_config() if smoke else full_config()
    d = common.SHAPE_DEFS[shape]
    B, S = common._bs(shape, smoke)
    T = src_len(S)
    Spec = common.Spec
    if d["step"] in ("train", "prefill"):
        specs = {"src_embeds": Spec((B, T, cfg.d_model), torch.bfloat16),
                 "tokens": Spec((B, S), torch.int32)}
        if d["step"] == "train":
            specs["labels"] = Spec((B, S), torch.int32)
        return specs
    kv = common.kv_specs(cfg, B, S)
    kv.update(xk=kv["k"], xv=kv["v"])
    return {"token": Spec((B,), torch.int32),
            "state": {"kv": kv, "src_len": Spec((B,), common.INDEX_DTYPE),
                      "index": Spec((B,), common.INDEX_DTYPE)}}
