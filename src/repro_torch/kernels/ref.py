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


def split3_ref(x: torch.Tensor) -> torch.Tensor:
    """The three bf16 terms of the f32 matrix `x`, stacked (3, *x.shape):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    rounded to nearest even. Both differences are exact in f32; for a
    normal x of magnitude at least 2^-102, hi + mid + lo == x. The plain
    version of the split kernel (`tiled_matmul.split3`), which does the
    same operations in the same order."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])
