"""The card's own power, read through NVML.

NVML (`libnvidia-ml.so.1`, installed with the NVIDIA driver) is bound here
with ctypes: the card's machine has no `pynvml`. The library is loaded and
initialised on first use, inside the functions, so the module imports on a
machine without it; any NVML failure raises `NvmlError`. There is no quiet
fall back to the simulator's power and no `nvidia-smi` substitute.

`open_card` finds the card of a CUDA device by its PCI bus id (or, where
this torch does not expose the bus id, by its UUID), never by its CUDA
index: under ``CUDA_VISIBLE_DEVICES`` the two indices differ. A `Card`
reads the total energy counter (mJ since the driver loaded), the board's
power (mW), the GPU temperature and the enforced power limit.

The energy counter does not move continuously: NVML averages and samples
the board's power over windows of tens of milliseconds, so the counter
steps at some period. `probe_period` measures that period while the card
works, and `measure_window` times a power window from one counter step to
another, so the window's joules and seconds cover the same interval. Both
take the counter, the work and the clock as functions, so their logic runs
on the CPU against a fake counter.
"""

from __future__ import annotations

import ctypes
import dataclasses
import statistics
import time
from collections.abc import Callable

import torch

from repro_torch.device import resolve_device

LIBRARY = "libnvidia-ml.so.1"
_NVML_TEMPERATURE_GPU = 0
_LIB = None


class NvmlError(RuntimeError):
    """NVML is missing, failed to initialise, or a query failed."""


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        lib.nvmlErrorString.restype = ctypes.c_char_p
        msg = lib.nvmlErrorString(rc) or b"unknown error"
        raise NvmlError(f"{what} failed: {msg.decode()} (NVML return {rc})")


def _lib():
    """The loaded, initialised NVML library (loaded once per process)."""
    global _LIB
    if _LIB is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise NvmlError(f"cannot load {LIBRARY}: {e}") from e
        _check(lib, lib.nvmlInit_v2(), "nvmlInit_v2")
        _LIB = lib
    return _LIB


@dataclasses.dataclass(frozen=True)
class Card:
    """One card's NVML handle and the queries the power runner makes."""

    handle: ctypes.c_void_p
    key: str                    # the PCI bus id (or UUID) it was found by

    def _uint(self, fn: str, *args) -> int:
        lib = _lib()
        out = ctypes.c_uint()
        _check(lib, getattr(lib, fn)(self.handle, *args, ctypes.byref(out)),
               fn)
        return out.value

    def energy_mj(self) -> int:
        """Total energy since the driver loaded, in mJ (64-bit counter)."""
        lib = _lib()
        out = ctypes.c_ulonglong()
        _check(lib, lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(out)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return out.value

    def power_w(self) -> float:
        """The board's power as NVML reports it (its own average), W."""
        return self._uint("nvmlDeviceGetPowerUsage") / 1e3

    def temperature_c(self) -> float:
        """GPU die temperature, degrees C."""
        return float(self._uint("nvmlDeviceGetTemperature",
                                ctypes.c_int(_NVML_TEMPERATURE_GPU)))

    def power_limit_w(self) -> float:
        """The enforced power limit, W."""
        return self._uint("nvmlDeviceGetEnforcedPowerLimit") / 1e3

    def name(self) -> str:
        """The card's product name."""
        lib = _lib()
        buf = ctypes.create_string_buffer(96)
        _check(lib, lib.nvmlDeviceGetName(self.handle, buf, ctypes.c_uint(96)),
               "nvmlDeviceGetName")
        return buf.value.decode()


def bus_id(device: str | torch.device = "cuda") -> str | None:
    """The PCI bus id ("00000000:19:00.0") of a CUDA device as torch reports
    it, or None where this torch's device properties carry no PCI fields."""
    props = torch.cuda.get_device_properties(resolve_device(device))
    fields = [getattr(props, f, None) for f in
              ("pci_domain_id", "pci_bus_id", "pci_device_id")]
    if any(f is None for f in fields):
        return None
    return "{:08x}:{:02x}:{:02x}.0".format(*fields)


def open_card(device: str | torch.device = "cuda") -> Card:
    """The NVML handle of the card behind a CUDA device, found by its PCI
    bus id, else by its UUID (both independent of ``CUDA_VISIBLE_DEVICES``).
    Raises `NvmlError` if NVML cannot be loaded or has no such card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"NVML reads a CUDA device, not {dev}")
    lib = _lib()
    handle = ctypes.c_void_p()
    key = bus_id(dev)
    if key is not None:
        _check(lib, lib.nvmlDeviceGetHandleByPciBusId_v2(
            key.encode(), ctypes.byref(handle)),
            f"nvmlDeviceGetHandleByPciBusId_v2({key})")
    else:
        key = "GPU-" + str(torch.cuda.get_device_properties(dev).uuid)
        _check(lib, lib.nvmlDeviceGetHandleByUUID(
            key.encode(), ctypes.byref(handle)),
            f"nvmlDeviceGetHandleByUUID({key})")
    return Card(handle=handle, key=key)


# ---------------------------------------------------------------------------
# Power windows over the stepping energy counter.
# ---------------------------------------------------------------------------

# a window lasts the larger of WINDOW_PERIODS counter periods and
# MIN_WINDOW_S, after a warm-up of about one period. A window that reads
# above the card's enforced power limit runs on to CAPPED_PERIODS periods:
# the card's power control then holds the draw to the limit over a cycle of
# about a second, high for most of it and low for the rest (on the H100,
# `chip_smoke.py` phase 9's `[power] cycle` lines), so 4 periods read the
# cycle's high part and 10 read one whole cycle
WINDOW_PERIODS = 4
CAPPED_PERIODS = 10
MIN_WINDOW_S = 0.1
# waiting this many periods (plus a second) for the counter to step means it
# has stopped
_STALL_PERIODS = 20
# how long `probe_period` polls the counter
PROBE_S = 1.5


def window_seconds(period_s: float, periods: int = WINDOW_PERIODS) -> float:
    """How long a power window of `periods` counter periods runs for a
    counter that steps every `period_s` seconds."""
    return max(periods * period_s, MIN_WINDOW_S)


def probe_period(read_mj: Callable[[], int], pump: Callable[[], int], *,
                 clock: Callable[[], float] = time.perf_counter) -> float:
    """Median seconds between steps of the energy counter, polled for
    `PROBE_S` while `pump()` keeps the card busy. Raises `NvmlError` when
    the counter steps fewer than three times."""
    steps = []
    last = read_mj()
    t_end = clock() + PROBE_S
    while (t := clock()) < t_end:
        pump()
        e = read_mj()
        if e != last:
            steps.append(t)
            last = e
    if len(steps) < 3:
        raise NvmlError(f"the energy counter stepped {len(steps)} times in "
                        f"{PROBE_S} s of work")
    return statistics.median(b - a for a, b in zip(steps, steps[1:]))


@dataclasses.dataclass(frozen=True)
class PowerWindow:
    """One window between two steps of the energy counter."""

    joules: float               # change in the counter
    seconds: float              # wall time between the two steps
    units: int                  # units of work `pump` finished in it

    @property
    def watts(self) -> float:
        """Mean board power over the window."""
        return self.joules / self.seconds


def measure_window(read_mj: Callable[[], int], pump: Callable[[], int], *,
                   period_s: float, periods: int = WINDOW_PERIODS,
                   limit_w: float | None = None,
                   clock: Callable[[], float] = time.perf_counter
                   ) -> PowerWindow:
    """Run `pump()` (keep the card busy; returns the units of work it saw
    finish) through a warm-up of about one counter period (at least half a
    period, up to the next step of the counter), then from that step to the
    step nearest `window_seconds(period_s, periods)` later: `periods` whole
    periods. Watts are the counter's change over the wall time between the
    two steps. Given the enforced power limit `limit_w`, a window that
    reads above it runs on from the same first step to `CAPPED_PERIODS`
    periods, one cycle of the card's power control, and reads the draw the
    card holds rather than the cycle's high part (fault C3).

    A step is known only to lie between the last read that returned the
    old value and the first that returns the new one, and a pump runs
    between the two: its lag (a replay waiting for room in the queue, the
    host descheduled) is inside the bracket. So each step is timed at the
    bracket's midpoint, the end of the read before it and of the read that
    sees it, and not at the read that sees it: timed there, a slow pump at
    one end and a fast one at the other moved the window's seconds by the
    pump's lag and its watts by as much."""
    stall = _STALL_PERIODS * period_s + 1.0

    def run_for(seconds: float, units: int) -> int:
        t = clock()
        while clock() - t < seconds:
            units += pump()
        return units

    def next_step(units: int) -> tuple[int, float, int]:
        e0 = read_mj()
        t_start = t_old = clock()
        while True:
            e = read_mj()
            t_new = clock()
            if e != e0:
                return e, 0.5 * (t_old + t_new), units
            if t_new - t_start > stall:
                raise NvmlError(f"the energy counter did not step in "
                                f"{stall:.2f} s")
            t_old = t_new
            units += pump()

    run_for(0.5 * period_s, 0)
    e0, t0, _ = next_step(0)
    units = 0
    while True:
        span = window_seconds(period_s, periods) - 0.5 * period_s
        units = run_for(span - (clock() - t0), units)
        e1, t1, units = next_step(units)
        win = PowerWindow(joules=(e1 - e0) / 1e3, seconds=t1 - t0,
                          units=units)
        if (limit_w is None or win.watts <= limit_w
                or periods >= CAPPED_PERIODS):
            return win
        periods = CAPPED_PERIODS
