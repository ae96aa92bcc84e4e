"""Device selection shared by the port's entry points.

Entry points default to ``device="cuda"``: the port runs on the card unless
the caller asks for the CPU (the tests do, to run the kernels' plain
versions). Without a GPU the default raises instead of carrying on on the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA and torch sees
    no GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs an NVIDIA GPU and torch finds none;"
            f" pass device='cpu' to run the plain versions on the CPU")
    return dev
