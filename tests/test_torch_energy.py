"""The port's energy model and roofline report against the JAX package's,
on the CPU.

Both are numpy arithmetic: on the reference's chips ("tpu_v5e", "rtx4070")
the same inputs must give the same floats (checked to 1e-12 relative; the
sums run in the same order). Two deliberate differences are pinned on the
"h100": an untuned shape is priced at `plan`'s tile, and
`roofline_fraction` uses the report's own chip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import chips as jchips
from repro.core import energy as jenergy
from repro.core import roofline as jroofline
from repro.kernels.tiled_matmul import BlockConfig as JBlockConfig
from repro.models.config import gemm_shape_counts as jgemm_shape_counts
from repro_torch.configs import get_config
from repro_torch.core import chips, energy, hwsim, roofline
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import TILE_SHAPES, BlockConfig, plan
from repro_torch.models.config import gemm_shape_counts

REF_CHIPS = ("tpu_v5e", "rtx4070")
RTOL = 1e-12


def _close(got, want) -> None:
    """Dataclass rows (or floats) equal to RTOL relative, strings exact."""
    if dataclasses.is_dataclass(got):
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
    elif isinstance(want, (float, int)) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    else:
        assert got == want


def _reports(seed: int = 0, n: int = 12):
    """Pairs of (port, reference) reports on the same random terms."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = dict(name=f"r{i}", n_chips=int(rng.choice([1, 4, 256])),
                  dtype=str(rng.choice(["bf16", "f32"])),
                  hlo_flops=float(rng.uniform(1e9, 1e15)),
                  hlo_bytes=float(rng.uniform(1e6, 1e12)),
                  collective_wire_bytes=float(rng.uniform(0, 1e9)),
                  compute_s=float(rng.uniform(1e-6, 1e-2)),
                  memory_s=float(rng.uniform(1e-6, 1e-2)),
                  collective_s=float(rng.choice([0.0, rng.uniform(0, 1e-2)])),
                  model_flops=float(rng.uniform(0, 1e15)),
                  bytes_per_device=float(rng.uniform(0, 1e10)))
        out.append((roofline.RooflineReport(**kw),
                    jroofline.RooflineReport(**kw)))
    return out


def test_roofline_report_properties_match_the_reference():
    pairs = _reports()
    for got, want in pairs:
        for prop in ("dominant", "bound_s", "serial_s",
                     "useful_flops_fraction", "roofline_fraction"):
            _close(getattr(got, prop), getattr(want, prop))
        _close(got.as_row(), want.as_row())
    assert (roofline.format_report_table([p for p, _ in pairs])
            == jroofline.format_report_table([r for _, r in pairs]))


def test_roofline_fraction_uses_the_reports_chip():
    """The reference divides by the TPU v5e's peak whatever the chip; the
    port by the peak of the chip the report names."""
    got, want = _reports(seed=1, n=1)[0]
    on_h100 = dataclasses.replace(got, chip="h100", dtype="bf16")
    ref = dataclasses.replace(want, dtype="bf16")
    h100 = chips.get_chip("h100")
    assert on_h100.roofline_fraction == pytest.approx(
        on_h100.model_flops / (on_h100.n_chips * h100.peak("bf16"))
        / on_h100.bound_s, rel=RTOL)
    assert on_h100.roofline_fraction == pytest.approx(
        ref.roofline_fraction * jchips.TPU_V5E.peak("bf16")
        / h100.peak("bf16"), rel=1e-12)
    assert on_h100.roofline_fraction < ref.roofline_fraction


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_step_power_and_energy_report_match_the_reference(chip):
    for got, want in _reports(seed=2):
        port_chip, ref_chip = chips.get_chip(chip), jchips.get_chip(chip)
        for ici in (0.0, 12.0):
            _close(energy.step_power_w(got, port_chip, ici_power_w=ici),
                   jenergy.step_power_w(want, ref_chip, ici_power_w=ici))
        for step_s in (None, 3e-3):
            _close(energy.energy_report(got, tokens_per_step=4096.0,
                                        chip=port_chip, step_s=step_s),
                   jenergy.energy_report(want, tokens_per_step=4096.0,
                                         chip=ref_chip, step_s=step_s))


def _serving_counts(port: bool) -> list[dict]:
    """qwen2-7b's GEMM counts of a decode step, a chunk call and a batched
    prefill, through either package's `gemm_shape_counts`."""
    cfg = get_config("qwen2-7b")
    if port:
        fn = gemm_shape_counts
    else:
        from repro.configs import get_config as jget_config

        cfg = jget_config("qwen2-7b")
        fn = jgemm_shape_counts
    return [fn(cfg, 4), fn(cfg, 8 * 64, head_tokens=8),
            fn(cfg, 4 * 512, head_tokens=4)]


def _tuned(counts: dict, block) -> dict:
    """A seeded tuned-tile map over half the shapes of `counts`."""
    rng = np.random.default_rng(3)
    tiles = [(8, 128, 128), (128, 256, 512), (64, 512, 256), (512, 128, 2048)]
    return {s: block(*tiles[int(rng.integers(len(tiles)))])
            for i, s in enumerate(sorted(counts)) if i % 2 == 0}


@pytest.mark.parametrize("tuned", (False, True))
@pytest.mark.parametrize("chip", REF_CHIPS)
def test_fleet_energy_matches_the_reference(chip, tuned):
    sharded = dict(tp=2, collective_bytes=3e6, n_collectives=4.0,
                   overlap_chunks=2)
    for got_c, want_c in zip(_serving_counts(True), _serving_counts(False)):
        assert got_c == want_c
        cfg_p = _tuned(got_c, BlockConfig) if tuned else None
        cfg_j = _tuned(want_c, JBlockConfig) if tuned else None
        for kw in ({}, dict(extra_hbm_bytes=5e8), sharded):
            _close(energy.gemm_fleet_energy(got_c, chip=chip, configs=cfg_p,
                                            name="s", **kw),
                   jenergy.gemm_fleet_energy(want_c, chip=chip,
                                             configs=cfg_j, name="s", **kw))
    dec, ch, _ = _serving_counts(True)
    jdec, jch, _ = _serving_counts(False)
    _close(energy.combine_shape_counts(dec, ch),
           jenergy.combine_shape_counts(jdec, jch))
    cfg_p = _tuned(energy.combine_shape_counts(dec, ch), BlockConfig)
    cfg_j = _tuned(jenergy.combine_shape_counts(jdec, jch), JBlockConfig)
    _close(energy.fused_step_energy(dec, ch, chip=chip,
                                    configs=cfg_p if tuned else None,
                                    extra_hbm_bytes=2e8),
           jenergy.fused_step_energy(jdec, jch, chip=chip,
                                     configs=cfg_j if tuned else None,
                                     extra_hbm_bytes=2e8))


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_parked_and_marginal_cost_match_the_reference(chip):
    for dur, n in ((0.0, 1), (2.5, 1), (7.25, 4)):
        _close(energy.parked_energy_j(dur, chip=chip, n_chips=n),
               jenergy.parked_energy_j(dur, chip=chip, n_chips=n))
    dec, ch, _ = _serving_counts(True)
    jdec, jch, _ = _serving_counts(False)
    ests = (energy.gemm_fleet_energy(ch, chip=chip),
            energy.gemm_fleet_energy(dec, chip=chip))
    jests = (jenergy.gemm_fleet_energy(jch, chip=chip),
             jenergy.gemm_fleet_energy(jdec, chip=chip))
    for calls, steps, toks in ((0, 0, 0), (3, 17, 18), (5, 31, 32)):
        for pick in ((0, 1), (None, 1), (0, None)):
            args = [ests[i] if i is not None else None
                    for i in pick]
            jargs = [jests[i] if i is not None else None for i in pick]
            kw = dict(chunk_calls=calls, chunk_width=8, decode_steps=steps,
                      decode_batch=4, tokens=toks)
            _close(energy.marginal_request_cost(*args, **kw),
                   jenergy.marginal_request_cost(*jargs, **kw))


class TestEnergyModel:
    """The energy cases of the reference's roofline tests, on the port."""

    def _r(self, c=1e-3, m=5e-4, coll=2e-4):
        return roofline.RooflineReport(
            name="e", n_chips=256, dtype="bf16", hlo_flops=1, hlo_bytes=1,
            collective_wire_bytes=1, compute_s=c, memory_s=m,
            collective_s=coll, model_flops=1)

    def test_power_range(self):
        p = energy.step_power_w(self._r())
        assert chips.TPU_V5E.idle_power_w < p <= chips.TPU_V5E.tdp_w

    def test_compute_bound_draws_more_than_idleish(self):
        busy = energy.step_power_w(self._r(c=1e-3, m=1e-3, coll=1e-3))
        light = energy.step_power_w(self._r(c=1e-3, m=1e-5, coll=1e-5))
        assert busy > light

    def test_energy_report_scaling(self):
        er = energy.energy_report(self._r(), tokens_per_step=1e6)
        assert er.system_power_w == pytest.approx(er.chip_power_w * 256)
        assert er.energy_per_token_j == pytest.approx(
            er.energy_per_step_j / 1e6)
        assert er.edp == pytest.approx(er.energy_per_step_j * er.step_s)


def test_h100_prices_untuned_shapes_at_plans_tile():
    """Every qwen2-7b serving shape is priced on the "h100" at the tile
    `plan` gives it, which the simulator takes (finite runtime), so no GEMM
    falls back to its roofline bound. The reference's default tile is no
    compiled tile of the card, so the port never prices it there."""
    fleet = ops.serving_gemm_fleet(get_config("qwen2-7b"), max_batch=4,
                                   max_len=512, chunk_tokens=64,
                                   lane_width=8)
    import torch

    sim = hwsim.TpuGemmSimulator(chip="h100")
    cfgs = []
    for m, n, k in fleet:
        tile = plan(m, n, k, (k, 1), (n, 1), 0, 0, torch.bfloat16,
                    torch.bfloat16).tile.as_tuple()
        assert energy.default_tile(m, n, k, "h100") == tile
        cfgs.append(hwsim.GemmConfig(m=m, n=n, k=k, block_m=tile[0],
                                     block_n=tile[1], block_k=tile[2],
                                     stages=4))
    rt = sim.analyze_batch(cfgs)["runtime_ms"]
    assert np.isfinite(rt).all() and (rt > 0).all()
    assert energy.REFERENCE_DEFAULT_TILE not in TILE_SHAPES
    for chip in REF_CHIPS:
        assert energy.default_tile(4, 512, 3584, chip) == (256, 256, 512)
    # the fleet's energy is the simulator's at those tiles, not the bound
    counts = {s: 1.0 for s in fleet}
    est = energy.gemm_fleet_energy(counts, chip="h100")
    assert est.step_s == pytest.approx(float(rt.sum()) * 1e-3, rel=1e-12)
    tuned = {s: BlockConfig(64, 64, 32) for s in fleet}
    assert energy.gemm_fleet_energy(counts, chip="h100",
                                    configs=tuned).step_s > est.step_s
