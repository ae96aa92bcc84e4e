"""seamless-m4t-medium — 12L enc + 12L dec, d_model=1024 16H d_ff=4096
vocab=256206, speech frontend stubbed as precomputed frame embeddings
[arXiv:2308.11596]."""

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
