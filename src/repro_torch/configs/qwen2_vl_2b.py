"""qwen2-vl-2b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, vision frontend stubbed as precomputed patch embeddings
[arXiv:2409.12191]."""

import torch

from repro_torch.configs import common
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


def _split(shape: str, smoke: bool) -> tuple[int, int, int, tuple[int, int]]:
    """(B, S, patches, grid) of `shape`: smoke 2 x 64 with a 4 x 4 grid."""
    if smoke:
        return 2, 64, 16, (4, 4)
    d = common.SHAPE_DEFS[shape]
    return d["global_batch"], d["seq_len"], N_PATCHES, GRID


def input_specs(shape: str, smoke: bool = False) -> dict:
    """The inputs of `shape`'s step: the full-sequence steps carry the
    patch prefix ((B, patches, d) bf16) and the (B, S, 3) M-RoPE
    positions beside S - patches text tokens (train: labels and a loss
    mask over all S); decode is a text-only continuation on the port's
    state layout (`configs.common`)."""
    cfg = smoke_config() if smoke else full_config()
    B, S, n_patch, _ = _split(shape, smoke)
    step = common.SHAPE_DEFS[shape]["step"]
    Spec = common.Spec
    if step in ("train", "prefill"):
        specs = {
            "tokens": Spec((B, S - n_patch), torch.int32),
            "patch_embeds": Spec((B, n_patch, cfg.d_model), torch.bfloat16),
            "positions_3d": Spec((B, S, 3), torch.int32),
        }
        if step == "train":
            specs["labels"] = Spec((B, S), torch.int32)
            specs["loss_mask"] = Spec((B, S), torch.float32)
        return specs
    return {"token": Spec((B,), torch.int32),
            "state": {"kv": common.kv_specs(cfg, B, S),
                      "index": Spec((B,), common.INDEX_DTYPE),
                      "pos_off": Spec((B,), common.INDEX_DTYPE)}}
