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

The reference's HLO-text collective parser and `roofline_from_artifacts`,
which read XLA's cost analysis, are not ported here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.chips import ChipSpec, get_chip


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
