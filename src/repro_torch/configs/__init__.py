"""Published model configs the port serves, with reduced smoke variants.

    from repro_torch.configs import get_config
    cfg = get_config("qwen2-7b")            # full config
    cfg = get_config("qwen2-7b", smoke=True)

Only the dense `qwen2-7b` is ported so far. Asking for another of the JAX
package's architectures raises `NotImplementedError` naming the ROADMAP item
(queue A) that ports its family.
"""

from __future__ import annotations

from repro_torch.configs import qwen2_7b

PORTED = {"qwen2-7b": qwen2_7b}

# the JAX package's other architectures -> the ROADMAP item that ports them
NOT_YET_PORTED = {
    "codeqwen1.5-7b": "A2 (the other dense configs)",
    "qwen2.5-14b": "A2 (the other dense configs)",
    "starcoder2-3b": "A2 (the other dense configs)",
    "olmoe-1b-7b": "A4 (MoE/MLA)",
    "deepseek-v2-236b": "A4 (MoE/MLA)",
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
