"""Power/energy model — the paper's energy axis, lifted to step level.

Per-kernel energy comes from `hwsim` (power x runtime). This module adds the
*framework-level* accounting: given a roofline report for a train/serve step,
estimate per-chip power from duty cycles, then energy per step / per token,
and the paper's ETA-style tradeoff metric (energy-delay product) used by the
autotuner's `objective="energy"` / `"edp"` modes.

The port's copy of the JAX package's `repro.core.energy`. Everything here is
an analytical model: on the "h100" its power terms are the spec's estimates
(`chips.H100`), and the card's own power is read by `core.nvml` instead. One
deliberate difference in `gemm_fleet_energy`: a shape with no tuned tile is
priced on the "h100" at the tile `kernels.tiled_matmul.plan` gives it, the
tile the card runs. The reference's default, a 256x256x512 TPU VMEM block,
is no compiled tile of the card's GEMM (the simulator would still price
it: its "h100" VMEM is the shared memory of all 132 SMs together). On every
other chip an untuned shape is priced at the reference's default tile,
copied here as `REFERENCE_DEFAULT_TILE`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.chips import (DTYPE_BYTES, H100, TPU_V5E, ChipSpec,
                                   canon_dtype, get_chip)
from repro_torch.core.roofline import RooflineReport

# ICI/link interface power while the wire is busy (matches the
# `step_power_w` default duty-cycle term).
ICI_POWER_W = 12.0
# the reference kernel's untuned block (its `tiled_matmul.DEFAULT_CONFIG`)
REFERENCE_DEFAULT_TILE = (256, 256, 512)


@dataclasses.dataclass
class EnergyReport:
    """Per-step energy telemetry derived from a roofline report: system
    power, J/step, J/token, and the energy-delay product."""

    name: str
    n_chips: int
    step_s: float
    chip_power_w: float
    system_power_w: float
    energy_per_step_j: float
    tokens_per_step: float
    energy_per_token_j: float
    edp: float                      # energy-delay product (J*s)

    def as_row(self) -> dict:
        """Flatten to a plain dict (CSV/markdown table row)."""
        return dataclasses.asdict(self)


def step_power_w(report: RooflineReport, chip: ChipSpec = TPU_V5E,
                 ici_power_w: float = 12.0) -> float:
    """Duty-cycle power model. At the overlap bound, each subsystem is busy
    for its own term's fraction of the bound time."""
    bound = max(report.bound_s, 1e-12)
    duty_mxu = min(report.compute_s / bound, 1.0)
    duty_hbm = min(report.memory_s / bound, 1.0)
    duty_ici = min(report.collective_s / bound, 1.0)
    p = (chip.idle_power_w
         + chip.mxu_power_w * duty_mxu
         + chip.hbm_power_w * duty_hbm
         + ici_power_w * duty_ici)
    return min(p, chip.tdp_w)


@dataclasses.dataclass(frozen=True)
class StepEnergyEstimate:
    """Predicted cost of one serving step (a prefill or one lockstep decode
    iteration of the whole batch) — the unit the engine's per-request
    energy attribution multiplies by resident steps."""

    name: str
    step_s: float                  # predicted wall time of the step
    power_w: float                 # duty-cycle chip power during the step
    energy_j: float                # fleet energy: power_w * step_s * n_chips
    compute_s: float               # summed GEMM compute terms
    memory_s: float                # summed GEMM memory terms
    n_gemms: float                 # weighted GEMM count
    # sharded-fleet terms (tp=1 single-chip estimates leave these at rest)
    n_chips: int = 1
    collective_s: float = 0.0      # unoverlapped wire time on the links
    exposed_collective_s: float = 0.0   # wire+launch time added to step_s
    overlap_factor: float = 0.0    # fraction of wire hidden behind GEMMs

    def as_row(self) -> dict:
        """Flatten to a plain dict (CSV/markdown table row)."""
        return dataclasses.asdict(self)


def combine_shape_counts(
    *maps: Mapping[tuple[int, int, int], float]
) -> dict[tuple[int, int, int], float]:
    """Merge GEMM shape->count maps by summing counts — the fleet of a
    *fused* serving step that issues several sub-steps back-to-back (e.g.
    one admission-prefill chunk + one lockstep decode)."""
    out: dict[tuple[int, int, int], float] = {}
    for m in maps:
        for shape, w in m.items():
            out[shape] = out.get(shape, 0.0) + float(w)
    return out


def fused_step_energy(*shape_counts: Mapping[tuple[int, int, int], float],
                      chip: ChipSpec | str = TPU_V5E,
                      dtype: str = "bf16",
                      configs: Mapping[tuple[int, int, int], object]
                      | None = None,
                      extra_hbm_bytes: float = 0.0,
                      tp: int = 1,
                      collective_bytes: float = 0.0,
                      n_collectives: float = 0.0,
                      overlap_chunks: int = 1,
                      name: str = "fused_step") -> StepEnergyEstimate:
    """Price one fused serving step: the union of several sub-step GEMM
    fleets (decode rows + chunk rows) run back-to-back through one
    duty-cycle power model, so chunked-admission serving is accounted as
    a single engine step rather than separately-idling phases."""
    return gemm_fleet_energy(combine_shape_counts(*shape_counts),
                             chip=chip, dtype=dtype, configs=configs,
                             extra_hbm_bytes=extra_hbm_bytes, tp=tp,
                             collective_bytes=collective_bytes,
                             n_collectives=n_collectives,
                             overlap_chunks=overlap_chunks, name=name)


def default_tile(m: int, n: int, k: int, chip: ChipSpec | str,
                 dtype: str = "bf16") -> tuple[int, int, int]:
    """The tile `gemm_fleet_energy` prices an untuned (m, n, k) GEMM at: on
    the "h100" the tile `tiled_matmul.plan` gives row-major operands in
    `dtype` (the one the card runs), elsewhere the reference's default."""
    if get_chip(chip).name != H100.name:
        return REFERENCE_DEFAULT_TILE
    import torch

    from repro_torch.kernels.tiled_matmul import plan

    dt = torch.float32 if canon_dtype(dtype) == "f32" else torch.bfloat16
    return plan(m, n, k, (k, 1), (n, 1), 0, 0, dt, dt).tile.as_tuple()


def gemm_fleet_energy(shape_counts: Mapping[tuple[int, int, int], float], *,
                      chip: ChipSpec | str = TPU_V5E,
                      dtype: str = "bf16",
                      configs: Mapping[tuple[int, int, int], object]
                      | None = None,
                      extra_hbm_bytes: float = 0.0,
                      tp: int = 1,
                      collective_bytes: float = 0.0,
                      n_collectives: float = 0.0,
                      overlap_chunks: int = 1,
                      name: str = "step") -> StepEnergyEstimate:
    """Energy of one step built from its GEMM fleet (the paper's per-kernel
    model lifted to a serving step).

    `shape_counts` maps (m, n, k) -> issue count per step (see
    `models.config.gemm_shape_counts`); `configs` optionally maps shapes to
    tuned `BlockConfig`s (e.g. `ServingEngine.pretuned`) so the estimate
    reflects the block sizes the step actually runs; a shape without one is
    priced at `default_tile` (on the "h100", `plan`'s tile; each "h100"
    tile at its real ring depth, `profiler.tile_stages`). Runtime per GEMM
    comes from the measurement substrate's analytical model; power comes
    from `step_power_w` over the fleet's aggregate duty cycles.

    `extra_hbm_bytes` charges non-GEMM HBM traffic the step issues on top
    of the fleet (the KV cache reads of attention), priced at the chip's
    HBM bandwidth and folded into both the memory duty cycle and the
    step's wall time.

    Sharded fleets: with `tp > 1` the shapes are the *per-shard* extents
    and `collective_bytes` / `n_collectives` describe one chip's per-step
    ring traffic, priced by `hwsim.collective_cost` against
    `ChipSpec.link_bw_gbs` with `overlap_chunks`-way interleaved overlap.
    The returned estimate is fleet-level: `step_s` is one lockstep step,
    `energy_j` multiplies the per-chip energy by `tp` chips, and the
    exposed (non-hidden) collective time extends the step.
    """
    from repro_torch.core.hwsim import (GemmConfig, TpuGemmSimulator,
                                        collective_cost)
    from repro_torch.core.profiler import tile_stages

    chip = get_chip(chip)
    dtype = canon_dtype(dtype)
    on_card = chip.name == H100.name
    shapes = sorted(shape_counts)
    weights = [float(shape_counts[s]) for s in shapes]
    cfgs = []
    for m, n, k in shapes:
        blk = (configs or {}).get((m, n, k))
        tile = (tuple(int(x) for x in blk.as_tuple()) if blk
                else default_tile(m, n, k, chip, dtype))
        extra = {"stages": tile_stages(tile)} if on_card else {}
        cfgs.append(GemmConfig(m=int(m), n=int(n), k=int(k),
                               block_m=tile[0], block_n=tile[1],
                               block_k=tile[2], dtype=dtype, **extra))
    sim = TpuGemmSimulator(chip=chip)
    tel = sim.analyze_batch(cfgs)

    bytes_per = float(DTYPE_BYTES.get(dtype, 2))
    peak = chip.peak(dtype if dtype in chip.peak_flops else "bf16")
    step_s = compute_s = memory_s = 0.0
    for i, ((m, n, k), w) in enumerate(zip(shapes, weights)):
        # roofline terms are always finite — the fallback when a block
        # config is invalid (VMEM OOM) on this chip and the simulator
        # reports NaN runtime
        c_s = 2.0 * m * n * k / peak
        m_s = (m * k + k * n + m * n) * bytes_per / chip.hbm_bw
        rt = float(tel["runtime_ms"][i]) * 1e-3
        if not rt > 0.0 or rt != rt:            # NaN/invalid -> bound
            rt = max(c_s, m_s)
            compute_s += w * c_s
            memory_s += w * m_s
        else:
            compute_s += w * float(tel["compute_time_ms"][i]) * 1e-3
            memory_s += w * float(tel["memory_time_ms"][i]) * 1e-3
        step_s += w * rt
    if extra_hbm_bytes > 0.0:
        gather_s = float(extra_hbm_bytes) / chip.hbm_bw
        memory_s += gather_s
        step_s += gather_s
    coll = collective_cost(collective_bytes, chip=chip, tp=tp,
                           n_collectives=n_collectives,
                           overlap_chunks=overlap_chunks,
                           compute_s=step_s)
    step_s += coll.exposed_s
    flops = sum(2.0 * m * n * k * w for (m, n, k), w in zip(shapes, weights))
    byts = (sum((m * k + k * n + m * n) * bytes_per * w
                for (m, n, k), w in zip(shapes, weights))
            + float(extra_hbm_bytes))
    # the fleet runs kernels back-to-back, so duty cycles are relative to
    # total step time: setting collective_s = step_s (with zero ICI power)
    # pins `step_power_w`'s bound to the step without adding power; the real
    # ICI duty (unoverlapped wire time over the step) is added separately
    report = RooflineReport(
        name=name, n_chips=max(int(tp), 1), dtype=dtype, hlo_flops=flops,
        hlo_bytes=byts, collective_wire_bytes=coll.wire_bytes,
        compute_s=min(compute_s, step_s),
        memory_s=min(memory_s, step_s), collective_s=step_s, chip=chip)
    if step_s > 0:
        power = step_power_w(report, chip, ici_power_w=0.0)
        if coll.wire_s > 0.0:
            power = min(power + ICI_POWER_W * min(coll.wire_s / step_s, 1.0),
                        chip.tdp_w)
    else:
        power = chip.idle_power_w
    n_chips = max(int(tp), 1)
    return StepEnergyEstimate(
        name=name, step_s=step_s, power_w=power,
        energy_j=power * step_s * n_chips,
        compute_s=compute_s, memory_s=memory_s,
        n_gemms=float(sum(weights)), n_chips=n_chips,
        collective_s=coll.wire_s, exposed_collective_s=coll.exposed_s,
        overlap_factor=coll.overlap_factor)


def parked_energy_j(duration_s: float, *, chip: ChipSpec | str = TPU_V5E,
                    n_chips: int = 1) -> float:
    """Energy of `n_chips` parked at the idle floor for `duration_s`.

    Thin framework-level wrapper over `hwsim.parked_cost` — the term the
    fleet scheduler charges every engine for the gap between its own
    busy time and the fleet makespan (a parked engine burns its
    `ChipSpec.idle_power_w` whether or not it ever serves)."""
    from repro_torch.core.hwsim import parked_cost

    return parked_cost(duration_s, chip=chip, n_chips=n_chips).energy_j


@dataclasses.dataclass(frozen=True)
class MarginalCostEstimate:
    """Predicted marginal cost of placing one request on a serving engine.

    Built from the engine's per-step fleet estimates by
    `marginal_request_cost` with the *same* per-row-share arithmetic the
    engine's energy attribution uses (chunk call split over lane width,
    decode step split over the slot table), so a routing decision priced
    here agrees with the ledger the request will actually be charged
    against."""

    chunk_calls: int        # bucketed prefill chunk calls the prompt needs
    prefill_s: float        # predicted model-clock seconds of those calls
    prefill_energy_j: float  # this request's per-row share of them
    decode_steps: int       # resident decode iterations (token budget)
    decode_s: float         # predicted model-clock seconds of those steps
    decode_energy_j: float  # this request's per-slot share of them
    energy_j: float         # prefill + decode marginal energy
    tokens: int             # expected generated tokens (denominator)
    j_per_token: float      # energy_j / tokens
    service_s: float        # prefill_s + decode_s (completion headroom)

    def as_row(self) -> dict:
        """Flatten to a plain dict (CSV/markdown table row)."""
        return dataclasses.asdict(self)


def marginal_request_cost(chunk_est: StepEnergyEstimate | None,
                          decode_est: StepEnergyEstimate | None, *,
                          chunk_calls: int, chunk_width: int,
                          decode_steps: int, decode_batch: int,
                          tokens: int) -> MarginalCostEstimate:
    """Marginal (engine, chunk-bucket) placement cost of one request.

    `chunk_est` prices one admission chunk call over `chunk_width` lane
    rows (e.g. `ServingEngine.fused_step_estimate` or `_chunk_cost`);
    `decode_est` one lockstep decode step over `decode_batch` slots. The
    request's marginal share is `chunk_calls` per-row slices of the
    former plus `decode_steps` per-slot slices of the latter — exactly
    the shares the engine attributes at retirement, so minimizing this
    across candidate placements minimizes predicted fleet J/token.
    Either estimate may be None: its terms price as zero."""
    c_j = c_s = 0.0
    if chunk_est is not None and chunk_calls > 0:
        c_j = chunk_calls * chunk_est.energy_j / max(chunk_width, 1)
        c_s = chunk_calls * chunk_est.step_s
    d_j = d_s = 0.0
    if decode_est is not None and decode_steps > 0:
        d_j = decode_steps * decode_est.energy_j / max(decode_batch, 1)
        d_s = decode_steps * decode_est.step_s
    total = c_j + d_j
    return MarginalCostEstimate(
        chunk_calls=int(chunk_calls), prefill_s=c_s, prefill_energy_j=c_j,
        decode_steps=int(decode_steps), decode_s=d_s, decode_energy_j=d_j,
        energy_j=total, tokens=int(tokens),
        j_per_token=total / max(int(tokens), 1),
        service_s=c_s + d_s)


def energy_report(report: RooflineReport, *, tokens_per_step: float,
                  chip: ChipSpec = TPU_V5E,
                  step_s: float | None = None) -> EnergyReport:
    """Price one step of a roofline report on `chip`: duty-cycle power
    times step time, normalized to J/token and EDP."""
    step = step_s if step_s is not None else report.bound_s
    p_chip = step_power_w(report, chip)
    p_sys = p_chip * report.n_chips
    e_step = p_sys * step
    return EnergyReport(
        name=report.name,
        n_chips=report.n_chips,
        step_s=step,
        chip_power_w=p_chip,
        system_power_w=p_sys,
        energy_per_step_j=e_step,
        tokens_per_step=tokens_per_step,
        energy_per_token_j=e_step / max(tokens_per_step, 1e-12),
        edp=e_step * step,
    )
