"""Profiling harness — the CUTLASS-profiler/ncu analogue.

Systematically sweeps GEMM configurations (matrix dims x block configs x
layouts x alpha/beta x dtype), "measures" each on the hardware substrate
(`hwsim.TpuGemmSimulator`) and materializes the training table the paper
collects (16,128 CUTLASS ops -> our default sweep is >= that).

The hot path is fully batched: configs are converted to a struct-of-arrays
once, telemetry comes from `TpuGemmSimulator.measure_batch`, and features
from `config_features_batch` — no per-config Python loop. The substrate is
selectable per chip (`collect_dataset(chip="rtx4070")`).

On real hardware the same harness runs with `measure_fn` swapped for a
wall-clock runner around the kernel (a per-config callable, since real
hardware measures one launch at a time); everything downstream (feature
building, model fitting, autotuning) is measurement-source-agnostic.

The port's copy of the JAX package's `repro.core.profiler` adds that runner
for the H100: `card_measure_fn` times the hand-written GEMM
(`kernels.tiled_matmul`) at one configuration with CUDA events, and
`h100_sweep_configs` is the sweep it profiles — the compiled tiles over
GEMM shapes of the H100's serving range. Runtime is always measured. With
``power=True`` the runner also reads the card's own power through NVML
(`core.nvml`): the GEMM runs back to back for a window of whole energy-
counter periods, and the row's ``power_source`` column says "nvml".
Without it, power and energy are the "h100" simulator's figures and the
column says "model". `power_sample` picks the rows a power sweep measures.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import statistics
import time
from collections.abc import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import nvml
from repro_torch.core.chips import DTYPE_BYTES, TPU_V5E, ChipSpec
from repro_torch.core.features import (
    NUMERIC_FEATURES,
    TARGETS,
    config_features,
    config_features_batch,
)
from repro_torch.core.hwsim import (
    GemmConfig,
    GemmTelemetry,
    TpuGemmSimulator,
    config_arrays,
    telemetry_row,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.tiled_matmul import (
    FAST_STAGES,
    GENERAL,
    TILE_PATHS,
    TILE_SHAPES,
    BlockConfig,
    plan,
    tiled_matmul,
)

# Default sweep axes (the CUTLASS-profiler flag grid, TPU-quantized).
DIM_CHOICES = (256, 512, 1024, 2048, 3072, 4096, 6144, 8192)
BLOCK_M_CHOICES = (8, 64, 128, 256, 512)
BLOCK_N_CHOICES = (128, 256, 512)
BLOCK_K_CHOICES = (128, 512, 2048)
LAYOUTS = ("nn", "nt", "tn", "tt")
ALPHA_BETA = ((1.0, 0.0), (1.0, 1.0), (0.5, 0.5), (2.0, 0.0))
DTYPES = ("bf16", "f32")

# Telemetry columns copied into the profiled table alongside the features.
_TELEMETRY_KEEP = ("runtime_ms", "power_w", "energy_j", "tflops",
                   "mxu_utilization", "hbm_utilization", "temperature_c",
                   "bound")
# Batch chunk size: fixed (never derived from progress_every) so the RNG
# draw order — hence the dataset — is independent of progress printing.
_CHUNK = 8192


def sweep_configs(
    *,
    dims: Iterable[int] = DIM_CHOICES,
    block_m: Iterable[int] = BLOCK_M_CHOICES,
    block_n: Iterable[int] = BLOCK_N_CHOICES,
    block_k: Iterable[int] = BLOCK_K_CHOICES,
    layouts: Iterable[str] = LAYOUTS,
    alpha_beta: Iterable[tuple[float, float]] = ALPHA_BETA,
    dtypes: Iterable[str] = DTYPES,
    n_configs: int | None = None,
    seed: int = 0,
) -> list[GemmConfig]:
    """Cartesian sweep, subsampled to `n_configs` if given.

    Matrix dims are sampled as (m, n, k) triples from `dims` (the paper
    sweeps m/n/k independently) rather than the full cube, to keep the
    blocks x layouts x scalars cube as the dominant factor like CUTLASS'
    kernel-variant grid.
    """
    rng = np.random.default_rng(seed)
    dims = list(dims)
    triples = [(m, n, k) for m in dims for n in dims for k in dims]
    rng.shuffle(triples)
    blocks = list(itertools.product(block_m, block_n, block_k))
    cfgs: list[GemmConfig] = []
    lay = list(layouts)
    ab = list(alpha_beta)
    dts = list(dtypes)
    # round-robin dims against the full (block, layout, ab, dtype) grid
    combo = list(itertools.product(blocks, lay, ab, dts))
    i = 0
    target = n_configs or (len(combo) * 24)
    while len(cfgs) < target:
        (bm, bn, bk), l, (a, b), dt = combo[i % len(combo)]
        m, n, k = triples[i % len(triples)]
        cfgs.append(GemmConfig(m=m, n=n, k=k, block_m=bm, block_n=bn,
                               block_k=bk, dtype=dt, layout=l, alpha=a,
                               beta=b))
        i += 1
    return cfgs


def _batch_table(cfgs: list[GemmConfig], sim: TpuGemmSimulator
                 ) -> dict[str, np.ndarray]:
    """Features + measured telemetry for one chunk, as dict-of-columns."""
    arrays = config_arrays(cfgs)
    table = config_features_batch(cfgs, chip=sim.chip, arrays=arrays)
    table["layout"] = arrays["layout"]
    table["dtype"] = arrays["dtype"]
    tel = sim.measure_batch(cfgs, arrays=arrays)
    for key in _TELEMETRY_KEEP:
        table[key] = tel[key]
    table["valid"] = tel["valid"]
    return table


def profile_configs(
    cfgs: list[GemmConfig],
    sim: TpuGemmSimulator | None = None,
    *,
    measure_fn: Callable[[GemmConfig], GemmTelemetry] | None = None,
    drop_invalid: bool = True,
    progress_every: int = 0,
    chip: ChipSpec | str | None = None,
) -> dict[str, np.ndarray]:
    """Run the sweep; return dict-of-columns (features + targets + extras).

    Without `measure_fn` the whole sweep runs through the vectorized
    `measure_batch` substrate. Passing `measure_fn` (one GemmConfig ->
    GemmTelemetry, e.g. a wall-clock runner on real hardware) falls back to
    the per-config loop.
    """
    sim = sim or TpuGemmSimulator(chip=chip if chip is not None else TPU_V5E,
                                  seed=0)
    t0 = time.time()
    if measure_fn is None:
        chunks = []
        done = 0
        next_report = progress_every
        for start in range(0, len(cfgs), _CHUNK):
            chunks.append(_batch_table(cfgs[start:start + _CHUNK], sim))
            done = min(start + _CHUNK, len(cfgs))
            if progress_every and done >= next_report:
                print(f"profiled {done}/{len(cfgs)} "
                      f"({time.time() - t0:.1f}s)")
                next_report = done + progress_every
        if not chunks:
            raise RuntimeError("no valid configurations in sweep")
        table = {key: np.concatenate([c[key] for c in chunks])
                 for key in chunks[0]}
        if drop_invalid:
            mask = table.pop("valid")
            table = {k: v[mask] for k, v in table.items()}
        else:
            table.pop("valid")
        if not len(table["runtime_ms"]):
            raise RuntimeError("no valid configurations in sweep")
        return table

    # real-hardware path: one measurement per call, rows accumulated; a
    # runner whose power is not its own reading says so (`power_source`)
    power_source = getattr(measure_fn, "power_source", None)
    rows: list[dict[str, float]] = []
    for i, cfg in enumerate(cfgs):
        tel = measure_fn(cfg)
        if drop_invalid and not tel.valid:
            continue
        row = config_features(cfg, chip=sim.chip)
        row["layout"] = cfg.layout
        row["dtype"] = cfg.dtype
        row["runtime_ms"] = tel.runtime_ms
        row["power_w"] = tel.power_w
        row["energy_j"] = tel.energy_j
        row["tflops"] = tel.tflops
        row["mxu_utilization"] = tel.mxu_utilization
        row["hbm_utilization"] = tel.hbm_utilization
        row["temperature_c"] = tel.temperature_c
        row["bound"] = tel.bound
        if isinstance(tel, CardTelemetry):
            row["busy_share"] = tel.busy_share
            row["launch_bound"] = tel.launch_bound
        if power_source is not None:
            row["power_source"] = power_source
        rows.append(row)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"profiled {i + 1}/{len(cfgs)} ({time.time() - t0:.1f}s)")
    if not rows:
        raise RuntimeError("no valid configurations in sweep")
    table = {}
    for key in rows[0]:
        vals = [r[key] for r in rows]
        if isinstance(vals[0], str):
            table[key] = np.array(vals, dtype=object)
        elif isinstance(vals[0], bool):
            table[key] = np.array(vals, dtype=bool)
        else:
            table[key] = np.array(vals, dtype=np.float64)
    return table


def collect_dataset(n_configs: int = 16128, seed: int = 0,
                    sim: TpuGemmSimulator | None = None,
                    progress_every: int = 0,
                    chip: ChipSpec | str = TPU_V5E) -> dict[str, np.ndarray]:
    """The paper's dataset: >=16,128 profiled GEMM operations.

    `chip` selects the measurement substrate ("tpu_v5e", "rtx4070", or any
    registered ChipSpec); an explicit `sim` wins over `chip`.
    """
    cfgs = sweep_configs(n_configs=n_configs, seed=seed)
    sim = sim or TpuGemmSimulator(chip=chip, seed=seed)
    return profile_configs(cfgs, sim, progress_every=progress_every)


def save_dataset(table: dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in table.items()})


def load_dataset(path: str) -> dict[str, np.ndarray]:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def feature_table(table: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Project the profiled table onto model-input columns."""
    out = {k: table[k] for k in NUMERIC_FEATURES if k in table}
    return out


def target_matrix(table: dict[str, np.ndarray]) -> np.ndarray:
    return np.stack([np.asarray(table[t], dtype=np.float64) for t in TARGETS],
                    axis=1)


def paper_split(table: dict[str, np.ndarray], train_n: int = 2076,
                test_n: int = 519, seed: int = 0
                ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The paper's split: 2,076 train / 519 test rows (the port's copy of
    the JAX package's `benchmarks.common.paper_split`).

    Tables with fewer rows than train_n + test_n fall back to a
    proportional 80/20 split.
    """
    n = len(table["runtime_ms"])
    if n < train_n + test_n:
        train_n = max(1, int(n * 0.8))
        test_n = max(1, n - train_n)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    tr_idx, te_idx = perm[:train_n], perm[train_n:train_n + test_n]
    tr = {k: np.asarray(v)[tr_idx] for k, v in table.items()}
    te = {k: np.asarray(v)[te_idx] for k, v in table.items()}
    return tr, te


# ---------------------------------------------------------------------------
# The H100: the hand-written GEMM measured on the card.
# ---------------------------------------------------------------------------

# Rows of the H100 sweep: 4 to 4096, with every row count the serving
# engine issues (4 and 8 decode, 64-512 chunk calls, 2048 batched prefill).
H100_M_CHOICES = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# Caps that keep the sweep inside a few minutes on the card: a config whose
# 2MNK exceeds its dtype's cap is left out (bf16 2**37: about 0.3 ms on the
# wgmma path; f32 2**34: about 1 ms on the general path's CUDA cores), and
# f32 takes the DIM_CHOICES (N, K) pairs only, not the model's widths (the
# LM head's 152064 x 3584 weights are 2.2 GB in f32).
H100_MAX_FLOPS = {"bf16": 2 ** 37, "f32": 2 ** 34}
# the other variants of the paper's grid, one per (shape, dtype) in turn
_H100_VARIANTS = tuple(itertools.product(LAYOUTS, ALPHA_BETA))[1:]


def tile_stages(tile: tuple[int, int, int]) -> int:
    """The shared-memory ring depth a compiled tile runs with: the fast
    paths' `FAST_STAGES`, the general path's double buffer."""
    return 2 if TILE_PATHS[tuple(tile)] == GENERAL else FAST_STAGES


def h100_sweep_configs() -> list[GemmConfig]:
    """The H100 sweep: every compiled tile (`TILE_SHAPES`, at its real ring
    depth) over (m, n, k) triples with m from `H100_M_CHOICES` and (n, k)
    from `DIM_CHOICES` squared plus qwen2-7b's serving projections.

    Each bf16 triple is swept at the serving configuration (layout "nn",
    alpha 1, beta 0) and at one more of the paper's (layout, alpha, beta)
    variants, taken in turn; each f32 triple (on `DIM_CHOICES` only) at one
    variant, also in turn. Tiles whose path cannot take a configuration
    stay in the list: the card's `measure_fn` marks them invalid and the
    profiler drops them. Configs over `H100_MAX_FLOPS` are left out. The
    order is shuffled with a fixed seed, so slow drift on the card does
    not line up with any feature.
    """
    from repro_torch.configs import get_config
    from repro_torch.models.config import gemm_shape_counts

    grid_pairs = {(n, k) for n in DIM_CHOICES for k in DIM_CHOICES}
    model_pairs = {(n, k) for _, n, k in gemm_shape_counts(
        get_config("qwen2-7b"), 1)}
    cfgs: list[GemmConfig] = []
    turn = 0
    for m in H100_M_CHOICES:
        for n, k in sorted(grid_pairs | model_pairs):
            for dt in ("bf16", "f32"):
                if 2 * m * n * k > H100_MAX_FLOPS[dt] or (
                        dt == "f32" and (n, k) not in grid_pairs):
                    continue
                variants = [_H100_VARIANTS[turn % len(_H100_VARIANTS)]]
                turn += 1
                if dt == "bf16":
                    variants.insert(0, ("nn", (1.0, 0.0)))
                for layout, (alpha, beta) in variants:
                    for tile in TILE_SHAPES:
                        cfgs.append(GemmConfig(
                            m=m, n=n, k=k, block_m=tile[0],
                            block_n=tile[1], block_k=tile[2], dtype=dt,
                            layout=layout, alpha=alpha, beta=beta,
                            stages=tile_stages(tile)))
    order = np.random.default_rng(0).permutation(len(cfgs))
    return [cfgs[i] for i in order]


def time_ms(fn: Callable[[], object], flush: torch.Tensor,
            reps: int) -> float:
    """Median milliseconds of `fn` over `reps` runs on the current stream,
    timed with CUDA events after one warm-up run, with the L2 cache flushed
    (a write of `flush`, 256 MB for the H100's 50 MB L2) before each run. A
    ~1 ms device sleep after the flush keeps the card busy while the host
    issues `fn`, so the host's time in the wrapper never shows up as idle
    time between the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_TORCH_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# Power windows. A unit of work is a CUDA graph of back-to-back launches of
# one GEMM that takes about POWER_UNIT_S on the card (at most
# MAX_UNIT_LAUNCHES launches), and POWER_DEPTH units stay queued, so the card
# stays fed whatever a launch costs the host, and through a read of the
# energy counter (milliseconds on the H100 machine; `chip_smoke.py` phase 9
# prints it). A window whose launches x kernel time cover less than
# LAUNCH_BOUND_BELOW of it measured a card that idled between launches; its
# row is flagged `launch_bound`.
POWER_UNIT_S = 5e-3
POWER_DEPTH = 4
MAX_UNIT_LAUNCHES = 1024
LAUNCH_BOUND_BELOW = 0.9


@dataclasses.dataclass
class CardTelemetry(GemmTelemetry):
    """A row measured for power on the card: the device's busy share of the
    power window (launches x kernel time / window) and whether it fell
    below `LAUNCH_BOUND_BELOW`."""

    busy_share: float = float("nan")
    launch_bound: bool = False


def power_row(tel: GemmTelemetry, win, launches: int,
              temperature_c: float) -> CardTelemetry:
    """A timed row with its power window (`nvml.PowerWindow`) in which
    `launches` of the GEMM finished: `power_w` is the window's watts,
    `energy_j` that power over the row's runtime, and the busy share
    launches x `runtime_ms` / window, flagged `launch_bound` below
    `LAUNCH_BOUND_BELOW` (the share passes 1 where back-to-back launches
    with a warm L2 run faster than the flushed `runtime_ms`)."""
    busy = launches * tel.runtime_ms / (1e3 * win.seconds)
    return CardTelemetry(**{
        **dataclasses.asdict(tel), "power_w": win.watts,
        "energy_j": win.watts * tel.runtime_ms / 1e3,
        "temperature_c": temperature_c},
        busy_share=busy, launch_bound=busy < LAUNCH_BOUND_BELOW)


def graph_pump(fn: Callable[[], object], kernel_ms: float
               ) -> tuple[Callable[[], int], int]:
    """Capture `fn` (one launch on the current stream) into a CUDA graph of
    enough back-to-back launches to last about `POWER_UNIT_S`, given that
    one launch takes `kernel_ms`. Returns ``(pump, launches per unit)``:
    `pump()` keeps `POWER_DEPTH` replays queued on the current stream and
    returns how many finished since its last call. `fn` must have run once
    before (so its scratch is allocated), and its launches must keep fixed
    pointers across replays (the split-K counters do; its workspace and
    output come from the graph's pool)."""
    n = int(min(MAX_UNIT_LAUNCHES,
                max(1, math.ceil(POWER_UNIT_S * 1e3 / max(kernel_ms, 1e-6)))))
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    # capture_begin/end rather than `torch.cuda.graph`, which collects
    # garbage and empties the allocator's cache on every capture
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(n):
                fn()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    inflight: collections.deque = collections.deque()

    def pump() -> int:
        done = 0
        while inflight and inflight[0].query():
            inflight.popleft()
            done += 1
        while len(inflight) < POWER_DEPTH:
            graph.replay()
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
        return done

    return pump, n


def probe_energy_period(card, device: str | torch.device = "cuda") -> float:
    """The period of the card's energy counter (`nvml.probe_period`), polled
    while a steady bf16 GEMM (2048 x 4096 x 4096, about 0.1 ms a launch)
    runs back to back."""
    dev = resolve_device(device)
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn((2048, 4096), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((4096, 4096), generator=g, device=dev).to(torch.bfloat16)
    fn = lambda: tiled_matmul(a, b)
    fn()
    torch.cuda.synchronize()
    pump, _ = graph_pump(fn, 0.1)
    period = nvml.probe_period(card.energy_mj, pump)
    torch.cuda.synchronize()
    return period


def card_measure_fn(*, device: str | torch.device = "cuda", reps: int = 5,
                    power: bool = False, period_s: float | None = None
                    ) -> Callable[[GemmConfig], GemmTelemetry]:
    """The wall-clock runner: `measure(cfg) -> GemmTelemetry` launches
    `tiled_matmul(..., config=BlockConfig(block_m, block_n, block_k))` on
    operands of the config's shape, layout, dtype, alpha and beta, and
    times it with `time_ms` (one warm-up, the median of `reps` runs, L2
    flushed). Operands are views of seeded random buffers on `device` (the
    card; the runner raises without one), grown as shapes need, so a sweep
    allocates them once.

    `runtime_ms`, `tflops` and the utilizations are measured. Without
    `power`, `power_w` and `energy_j` are the "h100" simulator's noise-free
    figures at that configuration, `temperature_c` is NaN, and the runner's
    ``power_source`` attribute ("model") marks them so in the profiled
    table. With ``power=True`` they are the card's (``power_source``
    "nvml"), read through NVML (`core.nvml`, which raises if NVML is
    missing): after the timing, the same GEMM runs back to back (CUDA
    graph replays, `graph_pump`) through a warm-up of about one
    energy-counter period and a window of whole periods
    (`nvml.measure_window`). `power_w` is the counter's change over
    the window's wall time — the whole board, idle floor included, as the
    paper's NVML reading was — and `energy_j` is `power_w` x `runtime_ms`,
    the simulator's and the paper's definition. The row is a
    `CardTelemetry` with the window's busy share and `launch_bound` flag,
    and `temperature_c` from NVML. `period_s` is the counter's period
    (`probe_energy_period` measures it when None, and the runner's
    ``period_s`` attribute holds it).

    A tile whose path cannot take the configuration — `plan` raises
    ValueError — gives an invalid row and launches nothing; any other error
    propagates. Split-K launches share one counter buffer per device, so
    the runner must own the stream while it measures.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the card's measure_fn times on cuda, not {dev}")
    card = None
    if power:
        card = nvml.open_card(dev)
        if period_s is None:
            period_s = probe_energy_period(card, dev)
    sim = TpuGemmSimulator(chip="h100", noise=0.0)
    peak = sim.chip.peak_flops
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    pools: dict[tuple[str, str], torch.Tensor] = {}

    def pool(role: str, dt: torch.dtype, numel: int) -> torch.Tensor:
        key = (role, str(dt))
        buf = pools.get(key)
        if buf is None or buf.numel() < numel:
            pools.pop(key, None)
            buf = torch.randn(numel, generator=gen, device=dev).to(dt)
            pools[key] = buf
        return buf[:numel]

    def measure(cfg: GemmConfig) -> GemmTelemetry:
        m, n, k = cfg.m, cfg.n, cfg.k
        dt = _TORCH_DTYPES[cfg.dtype]
        ta, tb = cfg.layout[0] == "t", cfg.layout[1] == "t"
        a = pool("a", dt, m * k).view((k, m) if ta else (m, k))
        b = pool("b", dt, k * n).view((n, k) if tb else (k, n))
        c = pool("c", dt, m * n).view(m, n) if cfg.beta != 0.0 else None
        tile = BlockConfig(cfg.block_m, cfg.block_n, cfg.block_k)
        model = telemetry_row(sim.analyze_batch([cfg]), 0)
        try:
            plan(m, n, k, a.stride()[::-1] if ta else a.stride(),
                 b.stride()[::-1] if tb else b.stride(),
                 a.data_ptr() % 16, b.data_ptr() % 16, dt, dt, config=tile)
        except ValueError:
            return dataclasses.replace(
                model, runtime_ms=float("nan"), power_w=float("nan"),
                energy_j=float("nan"), tflops=0.0, bound="invalid",
                temperature_c=float("nan"), valid=False)

        def fn():
            return tiled_matmul(a, b, c, config=tile, transpose_a=ta,
                                transpose_b=tb, alpha=cfg.alpha,
                                beta=cfg.beta, out_dtype=dt)

        ms = time_ms(fn, flush, reps)
        flops = 2.0 * m * n * k
        in_b = DTYPE_BYTES[cfg.dtype]
        nbytes = in_b * (m * k + k * n) + in_b * m * n * (
            2 if cfg.beta != 0.0 else 1)
        compute_ms = flops / peak[cfg.dtype] * 1e3
        memory_ms = nbytes / sim.chip.hbm_bw * 1e3
        tel = dataclasses.replace(
            model, runtime_ms=ms, tflops=flops / (ms / 1e3) / 1e12,
            compute_time_ms=compute_ms, memory_time_ms=memory_ms,
            overhead_ms=max(ms - max(compute_ms, memory_ms), 0.0),
            mxu_utilization=compute_ms / ms, hbm_utilization=memory_ms / ms,
            bound="compute" if compute_ms >= memory_ms else "memory",
            temperature_c=float("nan"), valid=True)
        if card is None:
            return tel
        pump, per_unit = graph_pump(fn, ms)
        win = nvml.measure_window(card.energy_mj, pump, period_s=period_s)
        torch.cuda.synchronize()
        return power_row(tel, win, win.units * per_unit,
                         card.temperature_c())

    measure.power_source = "nvml" if power else "model"
    measure.period_s = period_s
    return measure


def power_sample(table: dict[str, np.ndarray], n: int, seed: int = 0
                 ) -> list[GemmConfig]:
    """A seeded sample of `n` valid rows of a profiled table, as the
    `GemmConfig`s to measure for power: stratified by kernel path and by M,
    each (path, M) stratum taking its share of `n` in proportion to its
    rows (at least one row each while `n` allows). Returns every row when
    `n` is not below the table's length."""
    paths = np.array([TILE_PATHS[(int(a), int(b), int(c))] for a, b, c in
                      zip(table["block_m"], table["block_n"],
                          table["block_k"])])
    ms = np.asarray(table["m"]).astype(np.int64)
    rows = len(ms)
    rng = np.random.default_rng(seed)
    if n >= rows:
        chosen = np.arange(rows)
    else:
        strata: dict[tuple[str, int], list[int]] = {}
        for i, key in enumerate(zip(paths, ms)):
            strata.setdefault(key, []).append(i)
        keys = sorted(strata)
        share = {key: len(strata[key]) * n / rows for key in keys}
        take = {key: min(len(strata[key]), max(1, int(share[key])))
                for key in keys}
        # hand the rounding's leftovers to the strata with the largest
        # remainders, then trim from the largest if the floor of one
        # overshot
        left = n - sum(take.values())
        for key in sorted(keys, key=lambda k_: share[k_] - int(share[k_]),
                          reverse=True):
            if left <= 0:
                break
            if take[key] < len(strata[key]):
                take[key] += 1
                left -= 1
        while sum(take.values()) > n:
            big = max(keys, key=lambda k_: take[k_])
            take[big] -= 1
        chosen = np.sort(np.concatenate([
            rng.choice(strata[key], size=take[key], replace=False)
            for key in keys if take[key]]))
    layouts = np.asarray(table["layout"])
    dtypes = np.asarray(table["dtype"])
    return [GemmConfig(
        m=int(table["m"][i]), n=int(table["n"][i]), k=int(table["k"][i]),
        block_m=int(table["block_m"][i]), block_n=int(table["block_n"][i]),
        block_k=int(table["block_k"][i]), dtype=str(dtypes[i]),
        layout=str(layouts[i]), alpha=float(table["alpha"][i]),
        beta=float(table["beta"][i]),
        stages=tile_stages((int(table["block_m"][i]),
                            int(table["block_n"][i]),
                            int(table["block_k"][i]))))
        for i in chosen]


def measure_many(measure: Callable[[GemmConfig], GemmTelemetry]
                 ) -> Callable[[list[GemmConfig]], dict[str, np.ndarray]]:
    """A per-config runner as the tuner's batched verification hook
    (`GemmAutotuner.tune_many(measure_fn=...)`): one call with the flat
    top-k list, a dict of "runtime_ms", "power_w" and "energy_j" arrays
    back, in order."""

    def run(cfgs: list[GemmConfig]) -> dict[str, np.ndarray]:
        tels = [measure(c) for c in cfgs]
        return {key: np.array([getattr(t, key) for t in tels])
                for key in ("runtime_ms", "power_w", "energy_j")}

    return run
