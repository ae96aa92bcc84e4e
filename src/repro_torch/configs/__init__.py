"""Published model configs the port serves, with reduced smoke variants.

    from repro_torch.configs import get_config
    cfg = get_config("qwen2-7b")            # full config
    cfg = get_config("qwen2-7b", smoke=True)

The four dense configs are ported: `qwen2-7b`, `qwen2.5-14b`,
`codeqwen1.5-7b` and `starcoder2-3b`; and the two MoE ones: `olmoe-1b-7b`
and `deepseek-v2-236b` (MLA). Asking for another of the JAX
package's architectures raises `NotImplementedError` naming the ROADMAP item
(queue A) that ports its family.
"""

from __future__ import annotations

from repro_torch.configs import (codeqwen1_5_7b, deepseek_v2_236b,
                                  olmoe_1b_7b, qwen2_5_14b, qwen2_7b,
                                  starcoder2_3b)

PORTED = {
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "starcoder2-3b": starcoder2_3b,
    "qwen2.5-14b": qwen2_5_14b,
    "qwen2-7b": qwen2_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-v2-236b": deepseek_v2_236b,
}

# the JAX package's other architectures -> the ROADMAP item that ports them
NOT_YET_PORTED = {
    "falcon-mamba-7b": "A5 (SSM/hybrid)",
    "zamba2-2.7b": "A5 (SSM/hybrid)",
    "seamless-m4t-medium": "A6 (encdec/vlm)",
    "qwen2-vl-2b": "A6 (encdec/vlm)",
}


def list_archs() -> list[str]:
    """The architectures the port serves."""
    return list(PORTED)


def get_config(arch: str, smoke: bool = False):
    """The published config of `arch`, or its reduced smoke variant."""
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP queue {NOT_YET_PORTED[arch]}")
    if arch not in PORTED:
        raise KeyError(f"unknown arch {arch!r}; ported: {list_archs()}")
    mod = PORTED[arch]
    return mod.smoke_config() if smoke else mod.full_config()
