"""The card's power reader on the CPU: the window logic against a fake
energy counter and clock, the power row a window makes, the power sample,
and NVML's absence.

The counter here steps every `period` seconds of a fake clock, as NVML's
does on the card (where `chip_smoke.py` phase 9 probes the period). No
test here needs a GPU or NVML; `tests/test_torch_cuda.py` reads the card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import pytest

from repro_torch.core import hwsim, nvml, profiler


class FakeCard:
    """A clock and an energy counter: `watts` drawn continuously, the
    counter publishing the integral (in mJ) at each multiple of `period`.
    Every read costs `read_s` and every pump `pump_s` of the clock; a pump
    finishes one unit of work each `unit_s`."""

    def __init__(self, watts=350.0, period=0.1, read_s=0.006, pump_s=2e-4,
                 unit_s=0.005, stuck=False):
        self.t = 12.345
        self.watts, self.period = watts, period
        self.read_s, self.pump_s, self.unit_s = read_s, pump_s, unit_s
        self.stuck = stuck
        self.units = 0
        self.last = self.t
        self.reads = []

    def clock(self):
        return self.t

    def read_mj(self):
        self.t += self.read_s
        steps = 0 if self.stuck else np.floor(self.t / self.period)
        value = int(round(steps * self.period * self.watts * 1e3))
        self.reads.append(value)
        return value

    def pump(self):
        """The card works all the time (reads included); a pump reports
        the units finished since the last pump."""
        self.t += self.pump_s
        done = int(self.t / self.unit_s) - int(self.last / self.unit_s)
        self.last = self.t
        self.units += done
        return done


@pytest.mark.parametrize("period,read_s", [(0.02, 0.001), (0.05, 0.003),
                                           (0.1, 0.006)])
def test_window_reads_watts_from_the_counter_change(period, read_s):
    """Each end of the window is timed by the read that first sees the new
    step, so the error is about one read's time over the window."""
    card = FakeCard(watts=350.0, period=period, read_s=read_s)
    win = nvml.measure_window(card.read_mj, card.pump, period_s=period,
                              clock=card.clock)
    assert win.watts == pytest.approx(350.0, rel=0.03)
    assert win.joules == pytest.approx(350.0 * win.seconds, rel=0.03)
    # whole periods of the counter, as many as `window_seconds` asks
    periods = round(win.seconds / period)
    assert periods == pytest.approx(nvml.window_seconds(period) / period,
                                    abs=1)
    assert win.seconds == pytest.approx(periods * period, abs=2 * card.read_s)
    assert win.units == pytest.approx(win.seconds / card.unit_s, abs=2)


def test_window_is_sized_to_the_probed_period():
    assert nvml.window_seconds(0.1) == pytest.approx(0.4)
    assert nvml.window_seconds(0.01) == pytest.approx(nvml.MIN_WINDOW_S)
    for period in (0.01, 0.1):
        card = FakeCard(period=period, read_s=5e-4)
        win = nvml.measure_window(card.read_mj, card.pump, period_s=period,
                                  clock=card.clock)
        assert win.seconds >= nvml.window_seconds(period) - period
        assert win.seconds <= nvml.window_seconds(period) + period
    card = FakeCard(period=0.1, read_s=5e-4)
    win = nvml.measure_window(card.read_mj, card.pump, period_s=0.1,
                              periods=20, clock=card.clock)
    assert round(win.seconds / 0.1) == 20
    assert win.watts == pytest.approx(card.watts, rel=0.01)


def test_probe_finds_the_counter_period():
    for period in (0.02, 0.1):
        card = FakeCard(period=period)
        got = nvml.probe_period(card.read_mj, card.pump, clock=card.clock)
        assert got == pytest.approx(period, abs=card.read_s + card.pump_s)


def test_a_stopped_counter_raises():
    card = FakeCard(stuck=True)
    with pytest.raises(nvml.NvmlError, match="did not step"):
        nvml.measure_window(card.read_mj, card.pump, period_s=0.1,
                            clock=card.clock)
    with pytest.raises(nvml.NvmlError, match="stepped 0 times"):
        nvml.probe_period(FakeCard(stuck=True).read_mj, card.pump,
                          clock=card.clock)


def _timed_row(runtime_ms=0.05):
    sim = hwsim.TpuGemmSimulator(chip="h100", noise=0.0)
    cfg = hwsim.GemmConfig(m=64, n=4096, k=4096, block_m=64, block_n=64,
                           block_k=64, stages=4)
    tel = hwsim.telemetry_row(sim.analyze_batch([cfg]), 0)
    return dataclasses.replace(tel, runtime_ms=runtime_ms,
                               temperature_c=float("nan"))


@pytest.mark.parametrize("launches,bound", [(8000, False), (7100, True),
                                            (20000, False)])
def test_power_row_flags_a_launch_bound_window(launches, bound):
    """Watts from the window, joules over the row's runtime, and a busy
    share of launches x runtime / window, flagged below 0.9."""
    win = nvml.PowerWindow(joules=180.0, seconds=0.4, units=0)
    row = profiler.power_row(_timed_row(0.05), win, launches, 55.0)
    assert row.power_w == pytest.approx(450.0)
    assert row.energy_j == pytest.approx(450.0 * 0.05e-3)
    assert row.busy_share == pytest.approx(launches * 0.05e-3 / 0.4)
    assert row.launch_bound is bound
    assert row.temperature_c == 55.0 and row.valid


def test_profile_configs_keeps_the_power_columns():
    """A runner of card power rows tags the table "nvml" and carries the
    busy share and the launch_bound flag per row."""
    cfgs = profiler.h100_sweep_configs()[:40]
    win = nvml.PowerWindow(joules=120.0, seconds=0.4, units=0)

    def measure(cfg):
        tel = _timed_row(0.01 * (1 + cfg.m % 3))
        return profiler.power_row(tel, win, 12000 if cfg.m % 2 else 30000,
                                  50.0)

    measure.power_source = "nvml"
    table = profiler.profile_configs(cfgs, chip="h100", measure_fn=measure)
    assert list(table["power_source"]) == ["nvml"] * len(cfgs)
    assert table["launch_bound"].dtype == bool
    np.testing.assert_array_equal(
        table["launch_bound"], table["busy_share"] < 0.9)
    np.testing.assert_allclose(table["power_w"], 300.0)


def test_power_sample_is_stratified_and_seeded():
    table = profiler.profile_configs(profiler.h100_sweep_configs()[:4000],
                                     chip="h100")
    sample = profiler.power_sample(table, 300, seed=0)
    assert len(sample) == 300
    assert profiler.power_sample(table, 300, seed=0) == sample
    assert profiler.power_sample(table, 300, seed=1) != sample
    assert len({c.key() for c in sample}) == 300
    rows = {(int(m), int(a), int(b), int(c), str(d), str(l)) for m, a, b, c,
            d, l in zip(table["m"], table["block_m"], table["block_n"],
                        table["block_k"], table["dtype"], table["layout"])}
    assert all((c.m, c.block_m, c.block_n, c.block_k, c.dtype, c.layout)
               in rows for c in sample)

    def stratum(path_tile, m):
        return (profiler.TILE_PATHS[path_tile], m)

    have = {stratum((a, b, c), int(m)) for m, a, b, c in zip(
        table["m"], table["block_m"], table["block_n"], table["block_k"])}
    got = [stratum((c.block_m, c.block_n, c.block_k), c.m) for c in sample]
    assert set(got) == have            # every (path, M) stratum sampled
    # each stratum's share follows its rows' share
    for key in have:
        rows_share = np.mean([stratum((a, b, c), int(m)) == key for m, a, b, c
                              in zip(table["m"], table["block_m"],
                                     table["block_n"], table["block_k"])])
        assert got.count(key) == pytest.approx(300 * rows_share, abs=1.5)
    assert all(c.stages == profiler.tile_stages(
        (c.block_m, c.block_n, c.block_k)) for c in sample)
    assert len(profiler.power_sample(table, 10 ** 6)) == len(table["m"])


def test_nvml_missing_or_failing_raises(monkeypatch):
    monkeypatch.setattr(nvml, "_LIB", None)
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    with pytest.raises(nvml.NvmlError, match="cannot load"):
        nvml._lib()

    class FailingInit:
        def __init__(self, name):
            self.nvmlErrorString = lambda rc: b"Driver Not Loaded"

        def nvmlInit_v2(self):
            return 9

    monkeypatch.setattr(nvml.ctypes, "CDLL", FailingInit)
    with pytest.raises(nvml.NvmlError, match="Driver Not Loaded"):
        nvml._lib()
    assert nvml._LIB is None
    assert ctypes.CDLL is FailingInit


def test_power_runner_needs_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="GPU"):
        profiler.card_measure_fn(power=True)
    with pytest.raises(RuntimeError, match="GPU"):
        nvml.open_card()
    with pytest.raises(ValueError, match="cuda"):
        profiler.card_measure_fn(device="cpu", power=True)
