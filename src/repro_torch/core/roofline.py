"""Three-term roofline report of a step: compute, memory and collective.

    compute term    = FLOPs       / (chips x peak FLOP/s)
    memory term     = bytes       / (chips x HBM B/s)
    collective term = coll_bytes  / (chips x link B/s)

The port's copy of `RooflineReport` and `format_report_table` from the JAX
package's `repro.core.roofline`, which `core.energy` prices steps with.
One deliberate difference: the reference's `roofline_fraction` divides by
the peak of the TPU v5e whatever chip the report was priced on; here a
report names its chip (`chip`, default "tpu_v5e", so reports built as the
reference builds them agree with it there) and `roofline_fraction` uses
that chip's peak.

`roofline_from_cost` stands in for the reference's
`roofline_from_artifacts`: it prices a `core.opanalyze.StepCost` (the
dry-run's count of a step's ops) where the reference prices XLA's cost
analysis and HLO text. The reference's `parse_collectives` reads HLO text
and is not ported; `CollectiveStats` is, and holds the collectives the
step posted on the dry-run's mesh (`StepCost.collective_calls`,
``collective_operand_bytes`` and ``collective_by_op``), priced at the
chip's ``ici_link_bw`` as the reference prices them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.chips import ChipSpec, get_chip


@dataclasses.dataclass
class CollectiveStats:
    """Collective ops of a step by kind: counts, raw operand bytes and
    ring-model wire bytes per chip (the reference's record)."""

    counts: dict[str, int]
    operand_bytes: dict[str, float]   # raw operand bytes by op kind
    wire_bytes: dict[str, float]      # ring-model bytes per chip by op kind

    @property
    def total_wire_bytes(self) -> float:
        """Wire bytes per chip over every kind."""
        return sum(self.wire_bytes.values())

    @property
    def total_operand_bytes(self) -> float:
        """Operand bytes over every kind."""
        return sum(self.operand_bytes.values())


@dataclasses.dataclass
class RooflineReport:
    """One step's FLOPs, bytes and collective bytes, and the time each
    takes at the chip's peaks (`compute_s`, `memory_s`, `collective_s`)."""

    name: str
    n_chips: int
    dtype: str
    hlo_flops: float
    hlo_bytes: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0          # 6*N*D (or 6*N_active*D for MoE)
    collectives: object | None = None
    bytes_per_device: float = 0.0     # from memory_analysis
    chip: ChipSpec | str = "tpu_v5e"  # the chip the terms are priced on

    @property
    def dominant(self) -> str:
        """The largest of the three terms: "compute", "memory" or
        "collective"."""
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time if the three terms fully overlap."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Step time if the three terms do not overlap at all."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def useful_flops_fraction(self) -> float:
        """Model FLOPs over executed FLOPs."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the overlap bound:
        model-FLOPs time at the report's chip's peak / bound time."""
        if self.bound_s <= 0:
            return 0.0
        chip = get_chip(self.chip)
        ideal_s = self.model_flops / (self.n_chips * chip.peak(self.dtype))
        return ideal_s / self.bound_s

    def as_row(self) -> dict:
        """Flatten to a plain dict (CSV/markdown table row)."""
        return {
            "name": self.name,
            "chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "useful_frac": self.useful_flops_fraction,
            "roofline_frac": self.roofline_fraction,
            "bytes_per_device": self.bytes_per_device,
        }


def roofline_from_cost(name: str, cost, *, n_chips: int = 1,
                       model_flops: float = 0.0, dtype: str = "bf16",
                       chip: ChipSpec | str = "h100") -> RooflineReport:
    """The report of one step from its `core.opanalyze.StepCost` (counted
    per chip, on `n_chips` chips): FLOPs at `chip`'s `dtype` peak, bytes
    at its HBM rate, collective wire bytes (0 at one chip) at its link
    rate (the reference's ``coll / ici_link_bw``), and the
    peak-live estimate as ``bytes_per_device``. Every dot FLOP is priced at
    the `dtype` peak, so a step whose products run slower (the port's f32
    attention einsums) gets a lower bound, never a higher one."""
    spec = get_chip(chip)
    link = spec.ici_link_bw
    return RooflineReport(
        name=name,
        n_chips=n_chips,
        dtype=dtype,
        hlo_flops=cost.flops * n_chips,
        hlo_bytes=cost.hbm_bytes * n_chips,
        collective_wire_bytes=cost.collective_bytes * n_chips,
        compute_s=cost.flops / spec.peak(dtype),
        memory_s=cost.hbm_bytes / spec.hbm_bw,
        collective_s=cost.collective_bytes / link if link else 0.0,
        model_flops=model_flops,
        collectives=CollectiveStats(
            dict(getattr(cost, "collective_calls", {})),
            dict(getattr(cost, "collective_operand_bytes", {})),
            dict(cost.collective_by_op)),
        bytes_per_device=float(cost.peak_live_bytes),
        chip=spec.name,
    )


def format_report_table(reports: list[RooflineReport]) -> str:
    """A fixed-width text table of reports, one line each."""
    hdr = (f"{'cell':<42} {'chips':>5} {'compute_s':>10} {'memory_s':>10} "
           f"{'collect_s':>10} {'dominant':>10} {'useful%':>8} {'roofline%':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.name:<42} {r.n_chips:>5} {r.compute_s:>10.4e} "
            f"{r.memory_s:>10.4e} {r.collective_s:>10.4e} {r.dominant:>10} "
            f"{100*r.useful_flops_fraction:>7.1f}% {100*r.roofline_fraction:>8.1f}%"
        )
    return "\n".join(lines)
