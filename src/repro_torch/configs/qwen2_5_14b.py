"""qwen2.5-14b — 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064,
QKV bias [hf:Qwen/Qwen2.5-14B]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published qwen2.5-14b."""
    return ModelConfig(
        name="qwen2.5-14b",
        kind="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1e6,
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="qwen2.5-14b-smoke",
        kind="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        qkv_bias=True,
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
