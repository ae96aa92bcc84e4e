"""olmoe-1b-7b — 16L d_model=2048 16H (kv=16) MoE 64 experts top-8,
d_ff_expert=1024, vocab 50304 [arXiv:2409.02060]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published olmoe-1b-7b."""
    return ModelConfig(
        name="olmoe-1b-7b",
        kind="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        n_experts=64,
        top_k=8,
        d_ff_expert=1024,
        rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="olmoe-1b-7b-smoke",
        kind="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        n_experts=8,
        top_k=2,
        d_ff_expert=128,
        capacity_factor=4.0,   # no token drops at smoke scale (exactness)
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
