"""GEMM feature engineering — the paper's Algorithm 1 (PREPROCESSDATA +
COMPUTEGEMMCHARS), extended with the TPU-static features the profiler can
derive without running anything (grid size, VMEM working set, occupancy
analogue, alignment waste).

`config_features_batch` is the native path: it evaluates every feature as a
NumPy column over a whole config list at once and returns the dict-of-columns
table that the profiler/predictor consume directly. The scalar
`config_features` is a batch-of-one wrapper kept for convenience. Both take a
`chip` (ChipSpec or registry name) because the roofline-informed features —
naive compute/memory time, occupancy, alignment waste — are chip-dependent.

The port's copy of the JAX package's `repro.core.features`; only
`graph_candidate_features`, the candidate grid the autotuner ranks on a
device, is torch where the reference's is jnp.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core.chips import DTYPE_BYTES, TPU_V5E, ChipSpec, get_chip
from repro_torch.core.hwsim import (
    VMEM_USABLE_FRACTION,
    GemmConfig,
    chip_peak_array,
    config_arrays,
)

# Columns fed to the models (order matters for the compiled scorer).
NUMERIC_FEATURES = [
    "m", "n", "k",
    "block_m", "block_n", "block_k",
    "stages", "alpha", "beta", "dtype_bytes",
    "mxn", "mxk", "nxk", "mxnxk",
    "total_flops", "bytes_accessed", "arithmetic_intensity",
    "grid_steps", "vmem_working_set", "max_inflight_buffers",
    "alignment_waste", "layout_a_t", "layout_b_t",
    # physics-informed features (beyond-paper; EXPERIMENTS.md §Perf-pred):
    # naive roofline terms from *published* chip specs + tiling algebra.
    # These are static (pre-execution); the learned model supplies the
    # corrections (layout efficiency, VPU fallback, pipeline overlap, ...).
    "refetch_bytes", "naive_compute_ms", "naive_memory_ms",
    "padded_compute_ms", "naive_overhead_ms",
]
TARGETS = ["runtime_ms", "power_w", "energy_j", "tflops"]


def _ceil_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return -(-a // b)


def config_features_batch(
    cfgs: Sequence[GemmConfig],
    chip: ChipSpec | str = TPU_V5E,
    arrays: dict[str, np.ndarray] | None = None,
) -> dict[str, np.ndarray]:
    """Static (pre-execution) feature columns for a batch of GEMM configs."""
    c = get_chip(chip)
    arr = arrays if arrays is not None else config_arrays(cfgs)
    m, n, k = arr["m"], arr["n"], arr["k"]
    bm, bn, bk = arr["block_m"], arr["block_n"], arr["block_k"]
    in_bytes = arr["dtype_bytes"]

    grid_m = _ceil_div(m, bm)
    grid_n = _ceil_div(n, bn)
    grid_steps = grid_m * grid_n * _ceil_div(k, bk)
    single = (bm * bk + bk * bn) * in_bytes + bm * bn * 4
    max_buffers = (c.vmem_bytes * VMEM_USABLE_FRACTION
                   // np.maximum(single, 1)).astype(np.int64)
    total_flops = 2.0 * m * n * k
    bytes_accessed = in_bytes * (m * k + k * n) + 4.0 * m * n
    mxu = c.mxu_dim
    padded = (
        grid_steps
        * _ceil_div(bm, mxu) * _ceil_div(bn, mxu) * _ceil_div(bk, mxu)
        * (2 * mxu ** 3)
    )
    beta = arr["beta"]
    refetch_bytes = (
        grid_n * m * k * in_bytes     # A re-read per N-tile
        + grid_m * k * n * in_bytes   # B re-read per M-tile
        + m * n * 4.0 * np.where(beta != 0.0, 2.0, 1.0)
    )
    peak = chip_peak_array(c, arr["dtype"])
    layout = arr["layout"]
    f64 = np.float64
    return {
        "refetch_bytes": refetch_bytes.astype(f64),
        "naive_compute_ms": total_flops / peak * 1e3,
        "naive_memory_ms": refetch_bytes / c.hbm_bw * 1e3,
        "padded_compute_ms": padded / peak * 1e3,
        "naive_overhead_ms": grid_steps * 1e-7 * 1e3,
        "m": m.astype(f64),
        "n": n.astype(f64),
        "k": k.astype(f64),
        "block_m": bm.astype(f64),
        "block_n": bn.astype(f64),
        "block_k": bk.astype(f64),
        "stages": arr["stages"].astype(f64),
        "alpha": arr["alpha"].astype(f64),
        "beta": beta.astype(f64),
        "dtype_bytes": in_bytes.astype(f64),
        "mxn": (m * n).astype(f64),
        "mxk": (m * k).astype(f64),
        "nxk": (n * k).astype(f64),
        "mxnxk": m.astype(f64) * n * k,
        "total_flops": total_flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": total_flops / np.maximum(bytes_accessed, 1.0),
        "grid_steps": grid_steps.astype(f64),
        "vmem_working_set": single.astype(f64),
        "max_inflight_buffers": max_buffers.astype(f64),
        "alignment_waste": padded / np.maximum(total_flops, 1.0),
        "layout_a_t": np.array([1.0 if s[0] == "t" else 0.0 for s in layout]),
        "layout_b_t": np.array([1.0 if s[1] == "t" else 0.0 for s in layout]),
    }


def config_features(cfg: GemmConfig,
                    chip: ChipSpec | str = TPU_V5E) -> dict[str, float]:
    """Static features for one GEMM config (batch-of-one wrapper)."""
    cols = config_features_batch([cfg], chip=chip)
    return {key: float(col[0]) for key, col in cols.items()}


def features_matrix(cfgs: Sequence[GemmConfig],
                    chip: ChipSpec | str = TPU_V5E) -> np.ndarray:
    """(n_cfgs, len(NUMERIC_FEATURES)) feature matrix (for batched ranking)."""
    cols = config_features_batch(cfgs, chip=chip)
    return np.stack([cols[k] for k in NUMERIC_FEATURES], axis=1)


def graph_candidate_features(mnk, blocks, chip: ChipSpec | str, dtype: str,
                             *, device: str | torch.device,
                             stages=None, float64: bool = True):
    """Torch mirror of `config_features_batch` over an S x C grid.

    For every (shape, block) pair of `mnk` (S, 3) x `blocks` (C, 3) —
    candidate configs with the default knobs (layout "nn", alpha=1,
    beta=0) and `stages` (C,) (default 2, as `GemmConfig`) — build the
    (S, C, len(NUMERIC_FEATURES)) feature tensor plus the (S, C) validity
    mask of the reference's candidate rule (extent clipping and VMEM fit,
    `GemmAutotuner.candidate_configs` on the simulated chips) on `device`,
    so the autotuner can rank whole candidate grids where it scores them.

    The columns are computed as `config_features_batch` computes them:
    integer terms in int64, float terms in float64 in the numpy order, each
    divisor a tensor on the device (CUDA divides by a host scalar through
    its reciprocal). With ``float64=True`` they are bit-identical to
    `features_matrix` wherever the integer-valued terms stay below 2**53;
    ``float64=False`` returns the same columns rounded to float32.
    """
    c = get_chip(chip)
    dev = torch.device(device)
    i64, f64 = torch.int64, torch.float64
    mnk = torch.as_tensor(np.asarray(mnk, dtype=np.int64), device=dev)
    blocks = torch.as_tensor(np.asarray(blocks, dtype=np.int64), device=dev)
    S, C = mnk.shape[0], blocks.shape[0]
    m, n, k = (mnk[:, i, None] for i in range(3))          # (S, 1)
    bm, bn, bk = (blocks[None, :, i] for i in range(3))   # (1, C)
    in_b = int(DTYPE_BYTES[dtype])
    mxu = int(c.mxu_dim)

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=f64, device=dev)

    peak, hbm_bw = const(c.peak_flops[dtype]), const(c.hbm_bw)
    grid_m = -(-m // bm)
    grid_n = -(-n // bn)
    grid_steps = grid_m * grid_n * -(-k // bk)
    single = (bm * bk + bk * bn) * in_b + bm * bn * 4
    max_buffers = torch.floor_divide(
        const(c.vmem_bytes * VMEM_USABLE_FRACTION),
        torch.clamp_min(single, 1).to(f64)).to(i64)
    total_flops = 2.0 * m.to(f64) * n * k
    bytes_accessed = ((in_b * (m * k + k * n)).to(f64)
                      + 4.0 * m.to(f64) * n)
    padded = (grid_steps * -(-bm // mxu) * -(-bn // mxu) * -(-bk // mxu)
              * (2 * mxu ** 3)).to(f64)
    refetch = ((grid_n * m * k * in_b + grid_m * k * n * in_b).to(f64)
               + (m * n).to(f64) * 4.0 * 1.0)
    if stages is None:
        stages = torch.full((1, C), 2.0, dtype=f64, device=dev)
    else:
        stages = torch.as_tensor(np.asarray(stages, dtype=np.float64),
                                 device=dev)[None, :]

    def full(v: float) -> torch.Tensor:
        return torch.full((S, C), v, dtype=f64, device=dev)

    def bcast(a: torch.Tensor) -> torch.Tensor:
        return a.to(f64).expand(S, C)

    cols = {
        "refetch_bytes": bcast(refetch),
        "naive_compute_ms": bcast(total_flops / peak * 1e3),
        "naive_memory_ms": bcast(refetch / hbm_bw * 1e3),
        "padded_compute_ms": bcast(padded / peak * 1e3),
        "naive_overhead_ms": bcast(grid_steps.to(f64) * 1e-7 * 1e3),
        "m": bcast(m), "n": bcast(n), "k": bcast(k),
        "block_m": bcast(bm), "block_n": bcast(bn), "block_k": bcast(bk),
        "stages": bcast(stages), "alpha": full(1.0), "beta": full(0.0),
        "dtype_bytes": full(float(in_b)),
        "mxn": bcast(m * n), "mxk": bcast(m * k), "nxk": bcast(n * k),
        "mxnxk": bcast(m.to(f64) * n * k),
        "total_flops": bcast(total_flops),
        "bytes_accessed": bcast(bytes_accessed),
        "arithmetic_intensity": bcast(
            total_flops / torch.clamp_min(bytes_accessed, 1.0)),
        "grid_steps": bcast(grid_steps),
        "vmem_working_set": bcast(single),
        "max_inflight_buffers": bcast(max_buffers),
        "alignment_waste": bcast(padded / torch.clamp_min(total_flops, 1.0)),
        "layout_a_t": full(0.0), "layout_b_t": full(0.0),
    }
    feats = torch.stack([cols[name] for name in NUMERIC_FEATURES], dim=-1)

    def roundup(x: torch.Tensor, q: int) -> torch.Tensor:
        return torch.clamp_min(-(-x // q) * q, q)

    valid = ((bm <= 2 * roundup(m, 8))
             & (bn <= 2 * roundup(n, 128))
             & (bk <= 2 * roundup(k, 128))
             & (max_buffers >= 1))
    return (feats if float64 else feats.to(torch.float32)), valid


def table_from_configs(cfgs: Sequence[GemmConfig],
                       chip: ChipSpec | str = TPU_V5E
                       ) -> dict[str, np.ndarray]:
    cols = config_features_batch(cfgs, chip=chip)
    return {k: cols[k] for k in NUMERIC_FEATURES}
