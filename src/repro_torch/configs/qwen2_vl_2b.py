"""qwen2-vl-2b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, vision frontend stubbed as precomputed patch embeddings
[arXiv:2409.12191]."""

from repro_torch.models.config import ModelConfig

# the published image of the full-sequence shapes: a 32 x 32 patch grid
N_PATCHES = 1024
GRID = (32, 32)


def full_config() -> ModelConfig:
    """The published qwen2-vl-2b language backbone."""
    return ModelConfig(
        name="qwen2-vl-2b",
        kind="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        rope_theta=1e6,
        mrope=True,
        mrope_sections=(16, 24, 24),
    )


def smoke_config() -> ModelConfig:
    """2 layers, d_model 64, f32: the size the CPU tests run."""
    return ModelConfig(
        name="qwen2-vl-2b-smoke",
        kind="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        mrope=True,
        mrope_sections=(4, 2, 2),
        param_dtype="float32",
        activation_dtype="float32",
        remat=False,
    )
