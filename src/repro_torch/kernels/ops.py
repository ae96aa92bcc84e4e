"""Public GEMM ops — the port's single entry point for matmuls.

Every projection of the model calls `matmul` (or `linear`), which reaches
the hand-written Hopper GEMM through `tiled_matmul`. Dispatch follows the
tensor's device: a CUDA tensor launches the kernel, a CPU tensor (the tests)
runs its plain version. On the card, `tiled_matmul.plan` picks the path,
tile and K-splits of each call from its dtype, layout, alignment and shape
(the bf16 projections of the serving path take ``stream`` for M <= 64 and
``wgmma`` above); a caller that passes ``config=`` gets that compiled tile
or a ValueError.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.tiled_matmul import BlockConfig, tiled_matmul

SSM_SERVE_GRAIN = 8  # min prefill bucket == SSM serve-scan block


@functools.lru_cache(maxsize=None)
def prefill_buckets(max_len: int, min_bucket: int = SSM_SERVE_GRAIN
                    ) -> tuple[int, ...]:
    """Power-of-two row buckets the serving engine pads prefill chunks to,
    up to and including `max_len`. Memoized per (max_len, min_bucket): the
    engine's per-admission bucket lookup bisects this tuple."""
    buckets, b = [], min_bucket
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def chunk_buckets(max_len: int, chunk_tokens: int,
                  grain: int = SSM_SERVE_GRAIN) -> tuple[int, ...]:
    """The chunk sizes chunked admission may issue: the prefill buckets
    capped at `chunk_tokens` (a longer prompt is fed `chunk_tokens` tokens
    per engine step). `grain` sets the bucket floor."""
    caps = [b for b in prefill_buckets(max_len, grain) if b <= chunk_tokens]
    return tuple(caps) if caps else prefill_buckets(max_len, grain)[:1]


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    config: BlockConfig | None = None,
    transpose_b: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """out = a @ op(b) over the last axis of `a`; leading dims are batch.
    fp32 accumulation; the output dtype defaults to ``a.dtype``."""
    *lead, k = a.shape
    n, kb = b.shape if transpose_b else b.shape[::-1]
    if kb != k:
        raise ValueError(f"contraction mismatch {k} vs {kb}")
    out = tiled_matmul(a.reshape(-1, k), b, config=config,
                       transpose_b=transpose_b,
                       out_dtype=out_dtype or a.dtype)
    return out.reshape(*lead, n)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           **kw) -> torch.Tensor:
    """y = x @ w (+ b). w: (K, N)."""
    y = matmul(x, w, **kw)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def gemm(a, b, c=None, *, alpha=1.0, beta=0.0, transpose_a=False,
         transpose_b=False, config: BlockConfig | None = None,
         out_dtype=None) -> torch.Tensor:
    """Full BLAS-3 surface (rank-2 only) — used by benchmarks and tests."""
    return tiled_matmul(a, b, c, config=config,
                        transpose_a=transpose_a, transpose_b=transpose_b,
                        alpha=alpha, beta=beta, out_dtype=out_dtype)
