"""falcon-mamba-7b — 64L d_model=4096 attention-free Mamba1, vocab 65024,
ssm_state=16 [arXiv:2410.05355]."""

from repro_torch.configs import common
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    """The published falcon-mamba-7b (tied embeddings)."""
    return ModelConfig(
        name="falcon-mamba-7b",
        kind="mamba1",
        n_layers=64,
        d_model=4096,
        n_heads=1,            # unused (attention-free)
        d_ff=0,               # unused
        vocab=65024,
        ssm_state=16,
        d_conv=4,
        expand=2,
        tie_embeddings=True,
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        kind="mamba1",
        n_layers=2,
        d_model=64,
        n_heads=1,
        d_ff=0,
        vocab=256,
        ssm_state=8,
        d_conv=4,
        expand=2,
        tie_embeddings=True,
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
    return common.lm_decode_specs(cfg, shape, family="mamba1", smoke=smoke)
