"""Host wrapper of the hand-written Hopper GEMM (``csrc/tiled_matmul.cu``).

The counterpart of the JAX package's Pallas ``tiled_matmul``: the same
BLAS-3 surface, ``C = alpha * op(A) @ op(B) + beta * C`` with fp32
accumulation. Where the TPU wrapper zero-pads operands to block multiples,
this one hands the kernel strides and shapes; the kernel masks the ragged
edge itself, and the transposed layouts are strides, not copies.

A CPU tensor is computed by the plain version (`ref.matmul_ref`); a CUDA
tensor launches the kernel or raises. ``tiled_matmul.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ref import matmul_ref


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One thread block's output tile and K step — the Hopper analogue of
    the TPU's VMEM block config. Only the shapes in `TILE_SHAPES` are
    compiled into the kernel."""

    block_m: int = 64
    block_n: int = 64
    block_k: int = 32

    def smem_bytes(self, in_bytes: int = 2) -> int:
        """Static shared memory of one block: the padded A and B tiles,
        plus (bf16) the eight warps' 16x16 fp32 epilogue staging tiles."""
        if in_bytes == 4:   # f32 path: A tile padded by one column
            return 4 * (self.block_m * (self.block_k + 1)
                        + self.block_k * self.block_n)
        return (in_bytes * (self.block_m * (self.block_k + 8)
                            + self.block_k * (self.block_n + 8))
                + 8 * 16 * 16 * 4)

    def as_tuple(self) -> tuple[int, int, int]:
        """(block_m, block_n, block_k)."""
        return (self.block_m, self.block_n, self.block_k)


TILE_SHAPES = ((64, 64, 32),)
DEFAULT_CONFIG = BlockConfig(64, 64, 32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _launch(a, b, c_in, out, m, n, k, sa, sb, sc, alpha, beta, config):
    from repro_torch.kernels._build import load_library

    lib = load_library()
    err = lib.repro_tiled_matmul(
        a.data_ptr(), b.data_ptr(),
        c_in.data_ptr() if c_in is not None else None, out.data_ptr(),
        m, n, k, sa[0], sa[1], sb[0], sb[1], sc[0], sc[1],
        float(alpha), float(beta),
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out.dtype], *config.as_tuple(),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul launch failed: cudaError {err}")


def tiled_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor | None = None,
    *,
    config: BlockConfig = DEFAULT_CONFIG,
    transpose_a: bool = False,
    transpose_b: bool = False,
    alpha: float = 1.0,
    beta: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C  (the paper's GEMM surface).

    a: (M, K), or (K, M) if transpose_a; b: (K, N), or (N, K) if
    transpose_b. Inputs float32 or bfloat16 (both the same), output float32
    or bfloat16 (default ``a.dtype``). `c` (M, N) is rounded to `out_dtype`
    before the beta term, as the TPU kernel does."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("tiled_matmul expects rank-2 operands")
    m, ka = (a.shape[1], a.shape[0]) if transpose_a else a.shape
    n, kb = (b.shape[0], b.shape[1]) if transpose_b else b.shape[::-1]
    if ka != kb:
        raise ValueError(f"contraction mismatch: {ka} vs {kb}")
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")
    if c is not None and tuple(c.shape) != (m, n):
        raise ValueError(f"c has shape {tuple(c.shape)}, expected {(m, n)}")
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"inputs must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    c_in = c.to(out_dtype) if c is not None and beta != 0.0 else None
    devices = {t.device for t in (a, b, c_in) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if a.device.type == "cpu":
        return matmul_ref(a, b, c_in, transpose_a=transpose_a,
                          transpose_b=transpose_b, alpha=alpha, beta=beta,
                          out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul runs on cuda or cpu, not {a.device}")
    if config.as_tuple() not in TILE_SHAPES:
        raise ValueError(f"block config {config.as_tuple()} is not compiled; "
                         f"choose one of {TILE_SHAPES}")
    if -(-m // config.block_m) > _MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the grid's row-block limit")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    sa = a.stride()[::-1] if transpose_a else a.stride()      # (m, k)
    sb = b.stride()[::-1] if transpose_b else b.stride()      # (k, n)
    sc = c_in.stride() if c_in is not None else (0, 0)
    _launch(a, b, c_in, out, m, n, ka, sa, sb, sc, alpha, beta, config)
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
