"""Calibrated analytical GEMM timing/power simulator (multi-chip).

The port's copy of the JAX package's `repro.core.hwsim`: on "tpu_v5e" and
"rtx4070" it gives the reference's tables bit for bit. On the H100 the
port measures runtime on the card instead (`profiler.card_measure_fn`);
there the simulator at the "h100" spec supplies only the power and energy
columns until the card's power is read.

The reference was written for a container with no TPU (or GPU), so — per
the reproduction plan in DESIGN.md §2 — a physics-style analytical model of
the chip plays the role the RTX 4070 plays in the paper: it is *the
measured hardware* that the profiling harness sweeps and the ML models
learn to predict. Any `ChipSpec` from `chips.get_chip` can back the
simulator; TPU v5e is the default target and an RTX-4070-calibrated spec
mirrors the paper's platform. The functional forms encode the paper's
observed phenomena translated to TPU microarchitecture:

  * MXU quantization: a (bm, bn, bk) block matmul consumes
    ceil(bm/128)*ceil(bn/128)*ceil(bk/128) systolic passes — misaligned or
    tiny tiles waste lanes exactly the way sub-warp blocks waste SPs in the
    paper's tile=1/4 study.
  * VMEM-limited concurrency (the paper's Table I SM-occupancy cliff):
    double-buffered block working sets must fit in VMEM; when they don't,
    the pipeline degrades to serial HBM<->compute, and `max_inflight_buffers`
    (our occupancy analogue) drops to 1.
  * Grid overhead: each grid step has a fixed sequencer cost, so tiny tiles
    explode the grid (the paper's "block scheduler flooding" analogue).
  * Roofline coupling: runtime = startup + max(compute, memory) when
    pipelined, + grid overhead; power = idle + duty-cycle-weighted MXU and
    HBM dynamic power, saturating toward TDP for large compute-bound GEMMs
    (the paper's 80-100W base -> stepped saturation behaviour).

Measurement noise (multiplicative lognormal on runtime, additive Gaussian on
power, occasional thermal-drift samples) keeps the learning problem honest —
the ML models see a noisy, non-deterministic "hardware", not a formula.

The analytical model is fully vectorized: `analyze_batch` / `measure_batch`
evaluate whole arrays of `GemmConfig`s at once and return a struct-of-arrays
telemetry table (the profiler's native format). The scalar `analyze` /
`measure` are thin batch-of-one wrappers, so there is a single source of
truth for the formulas.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from repro_torch.core.chips import DTYPE_BYTES, TPU_V5E, ChipSpec, get_chip

# Fixed microarchitectural cost constants (calibration surface).
GRID_STEP_OVERHEAD_S = 8.0e-8     # per grid-step sequencer cost
KERNEL_STARTUP_S = 4.0e-6         # pallas_call launch + pipeline warmup
DMA_ISSUE_OVERHEAD_S = 2.0e-8     # per-block DMA issue cost
VMEM_USABLE_FRACTION = 0.75       # compiler scratch eats the rest
VPU_FALLBACK_PENALTY = 24.0       # sub-sublane blocks miss the MXU fast path
LAYOUT_EFFICIENCY = {             # HBM efficiency per operand layout
    "n": 1.0,                     # contiguous reads
    "t": 0.62,                    # strided (transposed) reads
}

# Struct-of-arrays telemetry column order (matches GemmTelemetry fields).
TELEMETRY_COLUMNS = (
    "runtime_ms", "power_w", "energy_j", "tflops",
    "compute_time_ms", "memory_time_ms", "overhead_ms",
    "mxu_utilization", "hbm_utilization",
    "vmem_working_set_bytes", "max_inflight_buffers", "pipelined",
    "grid_steps", "arithmetic_intensity", "bound", "temperature_c", "valid",
)


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """One GEMM measurement point — mirrors the paper's swept parameters."""

    m: int
    n: int
    k: int
    block_m: int = 128
    block_n: int = 128
    block_k: int = 512
    dtype: str = "bf16"            # input dtype; accumulation is fp32
    layout: str = "nn"             # nn / nt / tn / tt
    alpha: float = 1.0
    beta: float = 0.0
    stages: int = 2                # pipeline depth (double buffering = 2)

    def key(self) -> tuple:
        return dataclasses.astuple(self)


@dataclasses.dataclass
class GemmTelemetry:
    """What the 'hardware' reports for one run (the profiler's row)."""

    runtime_ms: float
    power_w: float
    energy_j: float
    tflops: float
    # ncu-style derived metrics
    compute_time_ms: float
    memory_time_ms: float
    overhead_ms: float
    mxu_utilization: float         # useful FLOPs / peak over runtime
    hbm_utilization: float
    vmem_working_set_bytes: int
    max_inflight_buffers: int      # occupancy analogue (paper Table I)
    pipelined: bool
    grid_steps: int
    arithmetic_intensity: float
    bound: str                     # "compute" | "memory" | "overhead"
    temperature_c: float
    valid: bool                    # False => config uncompilable (VMEM OOM)


def config_arrays(cfgs: Sequence[GemmConfig]) -> dict[str, np.ndarray]:
    """Struct-of-arrays view of a config list (field extraction only)."""
    return {
        "m": np.array([c.m for c in cfgs], dtype=np.int64),
        "n": np.array([c.n for c in cfgs], dtype=np.int64),
        "k": np.array([c.k for c in cfgs], dtype=np.int64),
        "block_m": np.array([c.block_m for c in cfgs], dtype=np.int64),
        "block_n": np.array([c.block_n for c in cfgs], dtype=np.int64),
        "block_k": np.array([c.block_k for c in cfgs], dtype=np.int64),
        "stages": np.array([c.stages for c in cfgs], dtype=np.int64),
        "alpha": np.array([c.alpha for c in cfgs], dtype=np.float64),
        "beta": np.array([c.beta for c in cfgs], dtype=np.float64),
        "dtype": np.array([c.dtype for c in cfgs], dtype=object),
        "layout": np.array([c.layout for c in cfgs], dtype=object),
        "dtype_bytes": np.array([DTYPE_BYTES[c.dtype] for c in cfgs],
                                dtype=np.int64),
        "layout_a_eff": np.array(
            [LAYOUT_EFFICIENCY[c.layout[0]] for c in cfgs], dtype=np.float64),
        "layout_b_eff": np.array(
            [LAYOUT_EFFICIENCY[c.layout[1]] for c in cfgs], dtype=np.float64),
    }


def chip_peak_array(chip: ChipSpec, dtypes: np.ndarray) -> np.ndarray:
    """Per-config peak FLOP/s for a dtype column."""
    return np.array([chip.peak_flops[d] for d in dtypes], dtype=np.float64)


def _ceil_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return -(-a // b)


def _linear_recurrence(x0: float, a: float, b: np.ndarray) -> np.ndarray:
    """Vectorized s_i = a*s_{i-1} + b_i with s_{-1} = x0.

    Chunked closed form (s_i = a^{i+1}(x0 + sum b_j a^{-j-1})) so the decay
    powers stay inside float64 range; contributions older than a chunk decay
    below machine precision anyway.
    """
    out = np.empty_like(b, dtype=np.float64)
    state = float(x0)
    chunk = 256
    for start in range(0, len(b), chunk):
        bb = b[start:start + chunk]
        powers = a ** np.arange(1, len(bb) + 1)
        seg = powers * (state + np.cumsum(bb / powers))
        out[start:start + chunk] = seg
        state = float(seg[-1])
    return out


def telemetry_row(table: dict[str, np.ndarray], i: int) -> GemmTelemetry:
    """Materialize one struct-of-arrays row as a GemmTelemetry."""
    return GemmTelemetry(
        runtime_ms=float(table["runtime_ms"][i]),
        power_w=float(table["power_w"][i]),
        energy_j=float(table["energy_j"][i]),
        tflops=float(table["tflops"][i]),
        compute_time_ms=float(table["compute_time_ms"][i]),
        memory_time_ms=float(table["memory_time_ms"][i]),
        overhead_ms=float(table["overhead_ms"][i]),
        mxu_utilization=float(table["mxu_utilization"][i]),
        hbm_utilization=float(table["hbm_utilization"][i]),
        vmem_working_set_bytes=int(table["vmem_working_set_bytes"][i]),
        max_inflight_buffers=int(table["max_inflight_buffers"][i]),
        pipelined=bool(table["pipelined"][i]),
        grid_steps=int(table["grid_steps"][i]),
        arithmetic_intensity=float(table["arithmetic_intensity"][i]),
        bound=str(table["bound"][i]),
        temperature_c=float(table["temperature_c"][i]),
        valid=bool(table["valid"][i]),
    )


class TpuGemmSimulator:
    """Analytical timing/power model of a tiled GEMM on one chip.

    `chip` accepts a ChipSpec or a registry name ("tpu_v5e", "rtx4070").
    """

    def __init__(self, chip: ChipSpec | str = TPU_V5E, noise: float = 0.03,
                 seed: int | None = 0):
        self.chip = get_chip(chip)
        self.noise = noise
        self._rng = np.random.default_rng(seed)
        self._temp_c = 42.0  # slow thermal state, drifts with load

    # ---------- deterministic core model (vectorized) ----------

    def analyze_batch(self, cfgs: Sequence[GemmConfig],
                      arrays: dict[str, np.ndarray] | None = None
                      ) -> dict[str, np.ndarray]:
        """Noise-free analytical telemetry for a whole batch of configs.

        Returns a struct-of-arrays table (TELEMETRY_COLUMNS). Invalid
        (VMEM-OOM) configs get NaN runtime/power/energy and valid=False,
        exactly like the scalar path.
        """
        c = self.chip
        arr = arrays if arrays is not None else config_arrays(cfgs)
        m, n, k = arr["m"], arr["n"], arr["k"]
        bm, bn, bk = arr["block_m"], arr["block_n"], arr["block_k"]
        in_bytes = arr["dtype_bytes"]
        acc_bytes = 4  # fp32 accumulators
        beta_nz = arr["beta"] != 0.0

        grid_m = _ceil_div(m, bm)
        grid_n = _ceil_div(n, bn)
        steps_k = _ceil_div(k, bk)
        grid_steps = grid_m * grid_n * steps_k

        # --- VMEM working set & occupancy analogue ---
        block_in_bytes = (bm * bk + bk * bn) * in_bytes
        block_out_bytes = bm * bn * acc_bytes
        single = block_in_bytes + block_out_bytes
        usable = c.vmem_bytes * VMEM_USABLE_FRACTION
        max_buffers = (usable // np.maximum(single, 1)).astype(np.int64)
        valid = max_buffers >= 1
        stages = np.minimum(arr["stages"], max_buffers)
        pipelined = valid & (stages >= 2)

        # --- compute time: MXU systolic passes with quantization waste ---
        mxu = c.mxu_dim
        passes_per_step = (
            _ceil_div(bm, mxu) * _ceil_div(bn, mxu) * _ceil_div(bk, mxu)
        )
        pass_flops = 2 * mxu * mxu * mxu
        padded_flops = grid_steps * passes_per_step * pass_flops
        useful_flops = 2.0 * m * n * k
        # sub-sublane blocks fall off the MXU fast path onto the VPU
        vpu_penalty = np.where((bm < c.sublane) | (bn < c.sublane),
                               VPU_FALLBACK_PENALTY, 1.0)
        peak = chip_peak_array(c, arr["dtype"])
        compute_s = padded_flops / peak * vpu_penalty

        # --- memory time: HBM traffic with layout efficiency ---
        lay_a = arr["layout_a_eff"]
        lay_b = arr["layout_b_eff"]
        a_traffic = grid_n * m * k * in_bytes  # A refetched per N-tile
        b_traffic = grid_m * k * n * in_bytes  # B refetched per M-tile
        c_traffic = m * n * acc_bytes
        c_traffic = np.where(beta_nz, c_traffic * 2, c_traffic)  # RMW
        hbm_bytes = a_traffic / lay_a + b_traffic / lay_b + c_traffic
        memory_s = hbm_bytes / c.hbm_bw

        # --- fixed overheads ---
        dma_per_step = 2 + beta_nz.astype(np.int64)
        overhead_s = (
            KERNEL_STARTUP_S
            + grid_steps * GRID_STEP_OVERHEAD_S
            + grid_steps * dma_per_step * DMA_ISSUE_OVERHEAD_S
        )

        inner_s = np.where(pipelined, np.maximum(compute_s, memory_s),
                           compute_s + memory_s)
        runtime_s = inner_s + overhead_s

        actual_bytes = a_traffic + b_traffic + c_traffic
        tflops = useful_flops / runtime_s / 1e12
        mxu_util = useful_flops / (runtime_s * peak)
        hbm_util = actual_bytes / (runtime_s * c.hbm_bw)
        bound = np.where(
            overhead_s > inner_s, "overhead",
            np.where(compute_s >= memory_s, "compute", "memory"),
        ).astype(object)
        bound[~valid] = "invalid"

        # --- power: idle + duty-weighted dynamic terms, TDP-capped ---
        duty_mxu = (np.minimum(compute_s / runtime_s, 1.0)
                    / np.maximum(vpu_penalty ** 0.5, 1.0))
        duty_hbm = np.minimum(memory_s / runtime_s, 1.0)
        dtype_power_scale = np.where(arr["dtype"] == "bf16", 1.0, 0.82)
        power_w = (
            c.idle_power_w
            + c.mxu_power_w * duty_mxu * dtype_power_scale
            + c.hbm_power_w * duty_hbm
        )
        power_w = np.minimum(power_w, c.tdp_w)

        # invalid rows: NaN runtime/power/energy, zeroed derived metrics
        zero = valid.astype(np.float64)
        table = {
            "runtime_ms": np.where(valid, runtime_s * 1e3, np.nan),
            "power_w": np.where(valid, power_w, np.nan),
            "energy_j": np.where(valid, power_w * runtime_s, np.nan),
            "tflops": tflops * zero,
            "compute_time_ms": compute_s * 1e3 * zero,
            "memory_time_ms": memory_s * 1e3 * zero,
            "overhead_ms": overhead_s * 1e3 * zero,
            "mxu_utilization": mxu_util * zero,
            "hbm_utilization": hbm_util * zero,
            "vmem_working_set_bytes": np.where(valid, single * stages,
                                               single).astype(np.int64),
            "max_inflight_buffers": max_buffers,
            "pipelined": pipelined,
            "grid_steps": grid_steps,
            "arithmetic_intensity": (useful_flops
                                     / np.maximum(actual_bytes, 1)) * zero,
            "bound": bound,
            "temperature_c": np.full(len(single), self._temp_c),
            "valid": valid,
        }
        return table

    def measure_batch(self, cfgs: Sequence[GemmConfig],
                      arrays: dict[str, np.ndarray] | None = None
                      ) -> dict[str, np.ndarray]:
        """Noisy batched 'hardware measurement' — what the profiler records.

        Semantics match running the scalar `measure` sequentially over
        `cfgs`: the thermal state walks across the batch in order (invalid
        configs don't touch it), and the same noise processes apply —
        multiplicative lognormal runtime noise, rare long-tail scheduler
        hiccups, additive Gaussian + thermal-coupled power noise. The RNG is
        consumed column-wise rather than row-wise, so draws are
        statistically identical to (not bit-equal with) the scalar loop.
        """
        arr = arrays if arrays is not None else config_arrays(cfgs)
        t = self.analyze_batch(cfgs, arrays=arr)
        valid = t["valid"]
        n_valid = int(valid.sum())
        out = {k: np.copy(v) for k, v in t.items()}
        if n_valid == 0:
            return out
        rng = self._rng
        chip = self.chip

        # thermal state follows load slowly (only valid runs heat the chip)
        power0 = t["power_w"][valid]
        target_temp = 40.0 + 35.0 * (power0 / chip.tdp_w)
        temp_noise = rng.normal(0, 0.3, n_valid)
        temps = _linear_recurrence(self._temp_c, 0.8,
                                   0.2 * target_temp + temp_noise)

        runtime = t["runtime_ms"][valid] * np.exp(
            rng.normal(0.0, self.noise, n_valid))
        # rare scheduler hiccup (long-tail), like a shared-machine blip
        hiccup = rng.random(n_valid) < 0.01
        hiccup_mag = 1.0 + np.abs(rng.normal(0.05, 0.05, n_valid))
        runtime = np.where(hiccup, runtime * hiccup_mag, runtime)

        power = (power0 + rng.normal(0.0, 1.5, n_valid)
                 + 0.08 * (temps - 42.0))
        power = np.clip(power, chip.idle_power_w * 0.9, chip.tdp_w)
        energy = power * runtime / 1e3
        useful_flops = 2.0 * arr["m"] * arr["n"] * arr["k"]
        tflops = useful_flops[valid] / (runtime / 1e3) / 1e12

        out["runtime_ms"][valid] = runtime
        out["power_w"][valid] = power
        out["energy_j"][valid] = energy
        out["tflops"][valid] = tflops
        # row i sees the state after the last valid row <= i (scalar parity)
        states = np.concatenate(([self._temp_c], temps))
        out["temperature_c"] = states[np.cumsum(valid)]
        self._temp_c = float(temps[-1])
        return out

    # ---------- scalar API (thin batch-of-one wrappers) ----------

    def analyze(self, cfg: GemmConfig) -> GemmTelemetry:
        """Noise-free analytical telemetry (the 'oracle' view)."""
        return telemetry_row(self.analyze_batch([cfg]), 0)

    def measure(self, cfg: GemmConfig) -> GemmTelemetry:
        """One noisy 'hardware measurement' — what the profiler records."""
        return telemetry_row(self.measure_batch([cfg]), 0)

    def occupancy_report(self, tiles: list[int], *, bk: int | None = None,
                         dtype: str = "bf16") -> dict[int, int]:
        """Paper Table I analogue: max in-flight VMEM buffers per tile size."""
        cfgs = [GemmConfig(m=4096, n=4096, k=4096, block_m=t, block_n=t,
                           block_k=bk if bk is not None else t, dtype=dtype)
                for t in tiles]
        buffers = self.analyze_batch(cfgs)["max_inflight_buffers"]
        return {t: int(b) for t, b in zip(tiles, buffers)}


# ---------------------------------------------------------------------------
# Collective cost model (sharded serving).
#
# A ring collective on `tp` chips is decomposed the way the SUMMA pipelining
# exemplars decompose a broadcast cycle: a host/launch phase (fixed latency
# per collective issue), a wire phase (ring bytes at the chip's aggregate
# link bandwidth), and a drain phase folded into the wire term — the
# H2D / compute / D2H shape of the paper's transfer analysis, applied to
# chip-to-chip links instead of the PCIe bus. When the projection is split
# into `chunks` interleaved column chunks (double-buffered in
# `distributed.tp`), every chunk's wire time except the last can hide under
# the next chunk's GEMM, bounded by the compute actually available.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParkedEstimate:
    """Energy of a chip fleet parked (or gap-idling) at its idle floor.

    The race-to-idle ledger: a fleet member that is not dispatching work
    still burns `ChipSpec.idle_power_w` per chip for the whole interval,
    so draining a lagging engine wide and parking it converts high-power
    straggler time into cheap idle-floor time."""

    power_w: float         # idle floor of the whole fleet (per-chip x n)
    duration_s: float      # parked interval (model-clock seconds)
    n_chips: int
    energy_j: float        # power_w * duration_s


def parked_cost(duration_s: float, *, chip: ChipSpec | str = TPU_V5E,
                n_chips: int = 1) -> ParkedEstimate:
    """Price `n_chips` of `chip` sitting parked for `duration_s` seconds.

    A parked engine dispatches nothing: no MXU/HBM/ICI duty, so power is
    exactly the chip's idle floor. This is the counterpart of
    `collective_cost`/`TpuGemmSimulator` for the scheduler's third
    decision — whether racing a queue down and idling beats trickling it
    across more engines ("Racing to Idle")."""
    chip = get_chip(chip)
    n = max(int(n_chips), 1)
    dur = max(float(duration_s), 0.0)
    power = chip.idle_power_w * n
    return ParkedEstimate(power_w=power, duration_s=dur, n_chips=n,
                          energy_j=power * dur)


@dataclasses.dataclass(frozen=True)
class CollectiveEstimate:
    """Predicted cost of one step's collective traffic on one chip."""

    wire_bytes: float      # ring bytes leaving this chip per step
    wire_s: float          # wire_bytes / link bandwidth (unoverlapped)
    launch_s: float        # per-collective issue latency, summed
    hidden_s: float        # wire time hidden behind interleaved GEMM chunks
    exposed_s: float       # wire_s + launch_s - hidden_s (adds to step time)
    overlap_factor: float  # hidden_s / wire_s in [0, 1]


def collective_cost(wire_bytes: float, *, chip: ChipSpec | str = TPU_V5E,
                    tp: int = 1, n_collectives: float = 0.0,
                    overlap_chunks: int = 1,
                    compute_s: float = 0.0) -> CollectiveEstimate:
    """Price one step's collective traffic for a `tp`-way sharded fleet.

    `wire_bytes` is the per-chip ring traffic the step issues (already
    scaled by the (tp-1)/tp ring factor — see
    `models.config.collective_wire_bytes`); `n_collectives` counts logical
    collective phases (each pays the chip's launch latency once — chunk
    sub-issues ride the already-open double-buffered channel); `compute_s`
    bounds how much wire time the interleaved-chunk pipeline can hide.
    """
    chip = get_chip(chip)
    if tp <= 1 or wire_bytes <= 0.0 or chip.link_bw_gbs <= 0.0:
        return CollectiveEstimate(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    wire_s = float(wire_bytes) / (chip.link_bw_gbs * 1e9)
    chunks = max(int(overlap_chunks), 1)
    launch_s = float(n_collectives) * chip.link_launch_s
    # double-buffered chunks: all but the trailing 1/chunks of the wire can
    # overlap the next chunk's GEMM, but never more than the compute there is
    hidden_s = min(wire_s * (1.0 - 1.0 / chunks), max(compute_s, 0.0))
    exposed_s = wire_s + launch_s - hidden_s
    overlap = hidden_s / wire_s if wire_s > 0.0 else 0.0
    return CollectiveEstimate(float(wire_bytes), wire_s, launch_s,
                              hidden_s, exposed_s, overlap)
