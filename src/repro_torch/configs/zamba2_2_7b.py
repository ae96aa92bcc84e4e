"""zamba2-2.7b — 54L Mamba2 backbone (d_model=2560, ssm_state=64) + shared
attention blocks (32H, d_ff=10240) every 6 layers, vocab 32000
[arXiv:2411.15242]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published zamba2-2.7b."""
    return ModelConfig(
        name="zamba2-2.7b",
        kind="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        ssm_state=64,
        ssm_headdim=64,
        ssm_ngroups=1,
        d_conv=4,
        expand=2,
        attn_every=6,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    """4 layers in 2 groups, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        kind="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_headdim=16,
        ssm_ngroups=1,
        d_conv=4,
        expand=2,
        attn_every=2,
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
    return common.lm_decode_specs(cfg, shape, family="hybrid", smoke=smoke)
