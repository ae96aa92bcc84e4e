"""Chip registry: hardware constants for every measurement substrate.

The port's copy of the JAX package's `repro.core.chips`, with one chip
added: the NVIDIA H100 SXM the port runs on (`H100`, registered as
"h100"). `TPU_V5E` and `RTX_4070` are kept so that the simulator, features
and tuner can be held against the reference on its own chips.

The paper's platform is an RTX 4070 (29.15 TFLOP/s fp32, 504.2 GB/s, ridge
point ~59 FLOPs/B, 46 SMs with 48 KiB shared memory each, ~85 W idle rising
to a 200 W TDP). The reproduction's primary target is TPU v5e (197 TFLOP/s
bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI). Both live in a small
registry so the simulator, profiler, predictor, and autotuner can be pointed
at any chip by name (`get_chip("rtx4070")`) and new substrates can be added
with `register_chip`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: dict[str, float]   # dtype -> FLOP/s
    hbm_bw: float                  # B/s
    hbm_bytes: float               # B
    vmem_bytes: float              # B (per core; smem x SMs on GPUs)
    ici_link_bw: float             # B/s per link (one direction)
    ici_links: int                 # links per chip (2D torus: 4)
    clock_hz: float
    mxu_dim: int                   # systolic array edge / GPU tile analogue
    sublane: int                   # second-minor tiling granularity
    lane: int                      # minor tiling granularity
    idle_power_w: float
    mxu_power_w: float             # max dynamic power of compute path
    hbm_power_w: float             # max dynamic power of HBM path
    tdp_w: float
    n_compute_units: int = 1       # SM count on GPUs; cores per chip on TPU
    # aggregate collective bandwidth per chip in GB/s — what one chip can
    # push onto the interconnect during a ring collective (ICI links on TPU,
    # the PCIe/NVLink envelope on GPUs). 0.0 = chip cannot shard.
    link_bw_gbs: float = 0.0
    # fixed per-collective launch/synchronization latency (seconds)
    link_launch_s: float = 2e-6

    def peak(self, dtype: str = "bf16") -> float:
        return self.peak_flops[dtype]

    def ridge_point(self, dtype: str = "bf16") -> float:
        """FLOPs/byte at which compute time == memory time."""
        return self.peak(dtype) / self.hbm_bw

    @property
    def nominal_power_w(self) -> float:
        """Mid-load operating power: idle floor + half the dynamic envelope.

        This is the analytical anchor the predictor's residual mode uses
        for energy (TPU v5e: 60 + (95+45)/2 = 130 W; RTX 4070: 142.5 W).
        """
        return self.idle_power_w + 0.5 * (self.mxu_power_w + self.hbm_power_w)


TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops={
        "bf16": 197e12,
        "int8": 394e12,
        "f32": 197e12 / 4,  # fp32 runs through the MXU at 1/4 bf16 rate
    },
    hbm_bw=819e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
    ici_link_bw=50e9,
    ici_links=4,
    clock_hz=940e6,
    mxu_dim=128,
    sublane=8,
    lane=128,
    idle_power_w=60.0,
    mxu_power_w=95.0,
    hbm_power_w=45.0,
    tdp_w=200.0,
    n_compute_units=1,
    link_bw_gbs=200.0,           # 4 ICI links x 50 GB/s
)

# The paper's chip, calibrated to its measurements: 46 SMs x 48 KiB shared
# memory (the VMEM/occupancy analogue), bf16 via fp32 CUDA cores, and the
# 80-100 W idle floor stepping toward the 200 W TDP under load.
RTX_4070 = ChipSpec(
    name="rtx4070",
    peak_flops={"f32": 29.15e12, "bf16": 29.15e12},
    hbm_bw=504.2e9,
    hbm_bytes=12 * 2**30,
    vmem_bytes=48 * 2**10 * 46,  # 48 KiB smem x 46 SMs
    ici_link_bw=0.0,
    ici_links=0,
    clock_hz=1.92e9,
    mxu_dim=16,                  # warp-tile analogue of the MXU edge
    sublane=8,
    lane=32,
    idle_power_w=85.0,
    mxu_power_w=80.0,
    hbm_power_w=35.0,
    tdp_w=200.0,
    n_compute_units=46,
    link_bw_gbs=32.0,            # PCIe 4.0 x16 — no NVLink on a 4070
)


_REGISTRY: dict[str, ChipSpec] = {}


def register_chip(spec: ChipSpec, *aliases: str) -> ChipSpec:
    """Register `spec` under its canonical name plus any aliases."""
    for key in (spec.name, *aliases):
        _REGISTRY[key.lower()] = spec
    return spec


def get_chip(chip: str | ChipSpec) -> ChipSpec:
    """Resolve a chip by registry name (or pass a ChipSpec through)."""
    if isinstance(chip, ChipSpec):
        return chip
    try:
        return _REGISTRY[chip.lower()]
    except KeyError:
        known = sorted(set(_REGISTRY))
        raise ValueError(f"unknown chip {chip!r}; known: {known}") from None


def available_chips() -> list[str]:
    """Canonical (deduplicated) registered chip names."""
    return sorted({spec.name for spec in _REGISTRY.values()})


# The port's card. Data-sheet numbers (NVIDIA H100 SXM data sheet and the
# Hopper white paper, dense rates): 132 SMs with 227 KiB of shared memory a
# block can use, 80 GB of HBM3 at 3.35 TB/s, 989 TFLOP/s bf16 on the tensor
# cores and 67 TFLOP/s f32 outside them, 700 W, and NVLink 4 at 18 links x
# 25 GB/s each way. clock_hz is the clock the bf16 peak implies (528 tensor
# cores x 1024 FLOP per clock x 1.83 GHz = 989 TFLOP/s).
# Estimates, not data-sheet numbers: idle_power_w, mxu_power_w and
# hbm_power_w (the simulator's power model, until the card's power is read),
# mxu_dim (a wgmma tile's 64-row edge as the MXU-edge analogue) and lane (a
# warp's 32 threads as the lane analogue). vmem_bytes follows RTX_4070's
# convention: shared memory per SM x SMs.
H100 = ChipSpec(
    name="h100",
    peak_flops={"bf16": 989e12, "f32": 67e12},
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    vmem_bytes=227 * 2**10 * 132,
    ici_link_bw=25e9,
    ici_links=18,
    clock_hz=1.83e9,
    mxu_dim=64,
    sublane=8,
    lane=32,
    idle_power_w=70.0,
    mxu_power_w=450.0,
    hbm_power_w=150.0,
    tdp_w=700.0,
    n_compute_units=132,
    link_bw_gbs=450.0,
)


register_chip(TPU_V5E, "v5e")
register_chip(RTX_4070, "rtx_4070", "ada", "4070")
register_chip(H100)


# Dtype strings (str(jnp_array.dtype), a config's "bfloat16", or
# str(torch_tensor.dtype)) -> simulator dtype names. The substrate's
# peak-FLOPs tables are keyed by the short names only, so the autotuner
# canonicalizes before enumerating candidates.
DTYPE_CANON = {"bfloat16": "bf16", "float32": "f32", "float16": "f16",
               "int8": "int8", "s8": "int8", "u8": "int8",
               "torch.bfloat16": "bf16", "torch.float32": "f32"}


def canon_dtype(dtype: str) -> str:
    """Map a jax or torch dtype string to the substrate's dtype name."""
    return DTYPE_CANON.get(dtype, dtype)


DTYPE_BYTES = {"bf16": 2, "f32": 4, "float32": 4, "bfloat16": 2, "int8": 1,
               "f16": 2, "float16": 2, "s8": 1, "u8": 1, "s32": 4, "u32": 4,
               "f64": 8, "pred": 1, "s16": 2, "u16": 2, "s64": 8, "u64": 8,
               "f8e4m3fn": 1, "f8e5m2": 1, "s4": 0.5, "u4": 0.5}
