"""Published model configs the port serves, with reduced smoke variants.

    from repro_torch.configs import get_config
    cfg = get_config("qwen2-7b")            # full config
    cfg = get_config("qwen2-7b", smoke=True)
    specs = input_specs("qwen2-7b", "decode_32k")   # {name: Spec} tree
    cells = all_cells()                              # every (arch, shape)

Every architecture of the JAX package is ported: the four dense configs
`qwen2-7b`, `qwen2.5-14b`, `codeqwen1.5-7b` and `starcoder2-3b`; the two
MoE ones, `olmoe-1b-7b` and `deepseek-v2-236b` (MLA); the SSM and hybrid
ones, `falcon-mamba-7b` (Mamba1) and `zamba2-2.7b` (Mamba2 with shared
attention); and the encoder-decoder `seamless-m4t-medium` and the
vision-language `qwen2-vl-2b` (their modality frontends stubbed, as in the
reference). An unknown name raises `KeyError`.

`SHAPES`, `SHAPE_DEFS`, `input_specs`, `supported_cells` and `all_cells`
are the reference's cell table (`configs.common` holds the shape table
and the spec builders; the decode state follows the port's layout).
"""

from __future__ import annotations

from repro_torch.configs import (codeqwen1_5_7b, common, deepseek_v2_236b,
                                  falcon_mamba_7b, olmoe_1b_7b, qwen2_5_14b,
                                  qwen2_7b, qwen2_vl_2b, seamless_m4t_medium,
                                  starcoder2_3b, zamba2_2_7b)

# in the reference's order (its `list_archs`, and so `all_cells`)
PORTED = {
    "falcon-mamba-7b": falcon_mamba_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "starcoder2-3b": starcoder2_3b,
    "qwen2.5-14b": qwen2_5_14b,
    "qwen2-7b": qwen2_7b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "qwen2-vl-2b": qwen2_vl_2b,
    "zamba2-2.7b": zamba2_2_7b,
}


def list_archs() -> list[str]:
    """The architectures the port serves."""
    return list(PORTED)


def get_config(arch: str, smoke: bool = False):
    """The published config of `arch`, or its reduced smoke variant."""
    if arch not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; ported: {list_archs()}")
    mod = PORTED[arch]
    return mod.smoke_config() if smoke else mod.full_config()


SHAPES = common.SHAPES
SHAPE_DEFS = common.SHAPE_DEFS


def input_specs(arch: str, shape: str, smoke: bool = False) -> dict:
    """`common.Spec` stand-ins for every input of (arch, shape)'s step."""
    if arch not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; ported: {list_archs()}")
    return PORTED[arch].input_specs(shape, smoke=smoke)


def supported_cells(arch: str) -> list[str]:
    """Shapes this arch runs (long_500k only for sub-quadratic archs)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).sub_quadratic:
        shapes.append("long_500k")
    return shapes


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell, in the reference's order."""
    return [(a, s) for a in list_archs() for s in supported_cells(a)]
