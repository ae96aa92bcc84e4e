"""deepseek-v2-236b — 60L d_model=5120 128H MLA (kv_lora=512, decoupled RoPE
64), MoE 2 shared + 160 routed top-6, d_ff_expert=1536, vocab 102400
[arXiv:2405.04434]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published deepseek-v2-236b."""
    return ModelConfig(
        name="deepseek-v2-236b",
        kind="mla_moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,              # first-layer dense FFN dim (unused: all MoE)
        vocab=102400,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        fsdp=True,               # 236B total params: FSDP mandatory at pod scale
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        kind="mla_moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        n_experts=8,
        top_k=2,
        n_shared_experts=1,
        d_ff_expert=64,
        kv_lora_rank=32,
        q_lora_rank=48,
        rope_head_dim=8,
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
    return common.lm_decode_specs(cfg, shape, family="mla", smoke=smoke)
