"""Plain PyTorch versions of the port's kernels.

The CPU tests run them in place of the kernels, and `chip_smoke.py` holds
each kernel against them on the card. The serving path never calls them on a
CUDA tensor.
"""

from __future__ import annotations

import torch


def matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor | None = None,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    alpha: float = 1.0,
    beta: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C with fp32 accumulation.

    The counterpart of the JAX package's ``kernels.ref.matmul_ref``: both
    operands are upcast to float32 and multiplied in full float32 (TF32 is
    switched off explicitly on the card), then the epilogue runs in float32
    and the result is cast to `out_dtype` (default: ``a.dtype``)."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    out_dtype = out_dtype or a.dtype
    if transpose_a:
        a = a.T
    if transpose_b:
        b = b.T
    out = alpha * (a.float() @ b.float())
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        out = out + beta * c.float()
    return out.to(out_dtype)
