"""qwen2-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
QKV bias [arXiv:2407.10671]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published qwen2-7b."""
    return ModelConfig(
        name="qwen2-7b",
        kind="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="qwen2-7b-smoke",
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
