"""starcoder2-3b — 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152,
RoPE [arXiv:2402.19173]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published starcoder2-3b."""
    return ModelConfig(
        name="starcoder2-3b",
        kind="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab=49152,
        rope_theta=1e5,
        gated_mlp=False,   # starcoder2 uses a plain 2-matrix GELU FFN
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="starcoder2-3b-smoke",
        kind="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        gated_mlp=False,
        param_dtype="float32",
        activation_dtype="float32",
        remat=False,
    )


def input_specs(shape: str, smoke: bool = False) -> dict:
    """The inputs of `shape`'s step (`configs.common`'s specs)."""
    cfg = smoke_config() if smoke else full_config()
    step = common.SHAPE_DEFS[shape]["step"]
    if step == "train":
        return common.lm_train_specs(cfg, shape, smoke)
    if step == "prefill":
        return common.lm_prefill_specs(cfg, shape, smoke)
    return common.lm_decode_specs(cfg, shape, family="kv", smoke=smoke)
