"""Predictor-guided GEMM block-config autotuner — the paper's payoff.

For a GEMM shape (m, n, k, dtype), enumerate the block configs the chip can
run, rank them with the trained multi-output predictor (one batched model
call), verify the top-k against the measurement substrate, and cache the
winner. Objectives mirror the paper's findings: "runtime" (3.2x speedup
claim), "energy"/"power" (22% power-reduction claim), "edp" (energy-delay
product).

The port's copy of the JAX package's `repro.core.autotuner`. On the
simulated chips ("tpu_v5e", "rtx4070") it enumerates the reference's
candidate grid and verifies against the simulator, so its winners can be
held against the reference's. On the "h100" the candidates are the hand-
written GEMM's compiled tiles that `plan` accepts for the shape (one
`stream` tile: the narrowest that holds M), and the measurement substrate
is the card itself: the top-k are timed with CUDA events
(`profiler.card_measure_fn`), and the process-wide H100 tuner times all of
them (`H100_VERIFY_TOP_K`). For the "energy", "power" and "edp" objectives
each candidate is also measured for power through NVML
(`card_measure_fn(power=True)`), so those objectives rank joules the card
measured; "runtime" keeps the runtime-only runner. The tuner picks a tile, as the reference
does; `plan` still sets the path and the K-splits for it.

`rank()` scores through the torch scorer on the tuner's device when that
is the card (float64, bit-identical to numpy `predict`), and through numpy
on the CPU. `rank_in_graph()` builds the candidate feature grid with torch
ops on the tuner's device, scores it there and takes the top-k there, with
the same winners as the trace-time ranking. `tune_many()` tunes a whole
fleet of shapes with one scorer call and one batched verification sweep.
The winner cache (in memory and the JSON sidecar) is keyed by the
predictor's artifact fingerprint and LRU-bounded, so retraining invalidates
stale winners and long-lived processes can't grow the sidecar without
limit.

`get_tuner(chip=...)` is the per-chip process-wide tuner that
`kernels.ops.warm_gemm_cache` tunes with; on first use it loads (or trains
and persists) the predictor artifact under artifacts/.
"""

from __future__ import annotations

import json
import math
import os
import threading
from collections import OrderedDict
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.chips import H100, ChipSpec, canon_dtype, get_chip
from repro_torch.core.features import features_matrix, graph_candidate_features
from repro_torch.core.hwsim import GemmConfig, TpuGemmSimulator
from repro_torch.core.predictor import ArtifactError, PerfPredictor
from repro_torch.core.profiler import (
    card_measure_fn,
    measure_many,
    tile_stages,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.tiled_matmul import (
    DEFAULT_CONFIG,
    STREAM,
    TILE_PATHS,
    WGMMA,
    TILE_SHAPES,
    BlockConfig,
    plan,
)

_BM = (8, 16, 32, 64, 128, 256, 512, 1024)
_BN = (128, 256, 512, 1024)
_BK = (128, 256, 512, 1024, 2048)

DEFAULT_ARTIFACTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "artifacts")
# untuned default: the general path's tile, the one compiled tile that takes
# every GEMM (the role the reference's BlockConfig(128, 128, 128) plays)
BASELINE = DEFAULT_CONFIG
# the JAX package's untuned default, BlockConfig(128, 128, 128): what its
# degraded mode prices on the reference's chips
REFERENCE_BASELINE = BlockConfig(128, 128, 128)

_CACHE_FILE_VERSION = 1


def baseline_configs(shapes, chip: ChipSpec | str,
                     dtype: str = "bf16") -> dict[tuple, BlockConfig]:
    """Map every (m, n, k) shape to its untuned tile on `chip`: the
    degraded-mode table a serving engine prices with when a predictor
    artifact is corrupt (`ServingEngine.retune`), so pricing and scheduling
    keep working and the fallback shows in reports.

    The reference maps every shape to its BASELINE. Here the table only
    prices and launches nothing (`matmul` reads the installed winners, and
    a degraded retune installs none), so each shape gets the tile an
    untuned shape is priced at (`energy.default_tile`): on the "h100" the
    one `plan` launches, on the reference's chips the reference's BASELINE,
    so the degraded prices there equal the reference's."""
    from repro_torch.core.energy import default_tile

    on_card = get_chip(chip).name == H100.name
    return {tuple(int(x) for x in s):
            (BlockConfig(*default_tile(*s, chip, dtype)) if on_card
             else REFERENCE_BASELINE)
            for s in shapes}
_TORCH_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# the most candidates `h100_candidate_tiles` returns (the general tile, one
# stream tile, the wgmma tiles): an H100 tuner verifies this many, so it
# times every candidate and its winner is never slower on the card than
# `plan`'s own tile, whatever the forest's ranking
H100_VERIFY_TOP_K = 2 + sum(TILE_PATHS[t] == WGMMA for t in TILE_SHAPES)


def _roundup(x: int, q: int) -> int:
    return max(q, math.ceil(x / q) * q)


def h100_candidate_tiles(m: int, n: int, k: int, dtype: str = "bf16"
                         ) -> list[tuple[int, int, int]]:
    """The compiled tiles `plan` accepts for an (m, n, k) GEMM of row-major
    contiguous operands in `dtype`, in `TILE_SHAPES` order, keeping one
    `stream` tile: the narrowest that holds M (a wider one only pads more
    rows). On the fast layout (bf16, N and K multiples of 8) that is the
    general 64x64x32, that stream tile for M <= 64, and the three wgmma
    tiles; otherwise the general tile alone."""
    dt = _TORCH_DTYPES.get(canon_dtype(dtype))
    if dt is None:
        return []
    tiles = []
    for tile in TILE_SHAPES:
        try:
            plan(m, n, k, (k, 1), (n, 1), 0, 0, dt, dt,
                 config=BlockConfig(*tile))
        except ValueError:
            continue
        tiles.append(tile)
    stream = [t for t in tiles if TILE_PATHS[t] == STREAM][:1]
    return [t for t in tiles if TILE_PATHS[t] != STREAM or t in stream]


class GemmAutotuner:
    def __init__(
        self,
        predictor: PerfPredictor,
        sim: TpuGemmSimulator | None = None,
        verify_top_k: int = 3,
        cache_path: str | None = None,
        chip: ChipSpec | str | None = None,
        candidate_cache_size: int = 512,
        scorer: str = "auto",
        winner_cache_size: int = 4096,
        device: str | torch.device = "cuda",
    ):
        """`chip` defaults to the H100 (`sim`'s chip when a simulator is
        given). `device` is where the tuner scores candidates and, on the
        H100, times them (the card unless the caller asks for the CPU).

        `scorer` selects the batched prediction path for `rank`: "torch"
        (the float64 torch scorer on `device`), "numpy" (the vectorized
        stacked-descent estimator), or "auto" (torch when `device` is the
        card, numpy on the CPU — the counterpart of the reference's jit
        scorer on accelerators). Both give the same bits.

        The verification substrate follows the chip: the simulator on the
        simulated chips, the card (`profiler.card_measure_fn` on `device`)
        on the H100. `tune_many(measure_fn=...)` overrides it per call.

        `winner_cache_size` bounds the tuned-winner cache (memory + JSON
        sidecar) with LRU eviction, mirroring the candidate-table cache.
        """
        self.predictor = predictor
        self.sim = sim or TpuGemmSimulator(
            chip=chip if chip is not None else H100, seed=0)
        self.chip = self.sim.chip
        self.device = resolve_device(device)
        self.verify_top_k = verify_top_k
        self.cache_path = cache_path
        if scorer not in ("auto", "torch", "numpy"):
            raise ValueError(f"unknown scorer {scorer!r}")
        self.scorer = scorer
        self.artifact_fingerprint = predictor.fingerprint()
        self._winner_cache_size = winner_cache_size
        self._cache: OrderedDict[str, tuple[int, int, int]] = OrderedDict()
        # the card's runners, keyed by whether they read power
        self._card_measure: dict[bool, Callable] = {}
        # the last verification sweep: (configs, telemetry arrays)
        self.last_verification: tuple[list[GemmConfig], dict] | None = None
        # (m, n, k, dtype) -> (candidate configs, feature table) — one bucket
        # per GEMM-call signature on this tuner's (chip, dtype) grid.
        self._cand_cache: OrderedDict[
            tuple[int, int, int, str], tuple[list[GemmConfig], np.ndarray]
        ] = OrderedDict()
        self._cand_cache_size = candidate_cache_size
        self._lock = threading.Lock()
        if cache_path and os.path.exists(cache_path):
            self._cache = self._load_cache_file(cache_path)

    @property
    def on_card(self) -> bool:
        """True when the chip is the H100: compiled tiles, card-timed."""
        return self.chip.name == H100.name

    # ---------- winner cache (fingerprint-versioned, LRU-bounded) ----------
    def _load_cache_file(self, path: str
                         ) -> "OrderedDict[str, tuple[int, int, int]]":
        """Read the winner sidecar; discard it when it predates the current
        artifact (or the pre-versioned flat format). Entries keep their
        file order (oldest first) and are trimmed to the LRU bound."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return OrderedDict()
        if (not isinstance(payload, dict)
                or payload.get("cache_version") != _CACHE_FILE_VERSION
                or payload.get("artifact_fingerprint")
                != self.artifact_fingerprint):
            return OrderedDict()
        entries = OrderedDict(
            (k, tuple(v)) for k, v in payload.get("entries", {}).items())
        while len(entries) > self._winner_cache_size:
            entries.popitem(last=False)
        return entries

    def _cache_get(self, key: str) -> tuple[int, int, int] | None:
        """LRU lookup (caller holds self._lock)."""
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, key: str, val: tuple[int, int, int]) -> None:
        """LRU insert + eviction (caller holds self._lock)."""
        self._cache[key] = val
        self._cache.move_to_end(key)
        while len(self._cache) > self._winner_cache_size:
            self._cache.popitem(last=False)

    def _write_cache_locked(self) -> None:
        """Persist the winner cache (caller holds self._lock)."""
        if not self.cache_path:
            return
        os.makedirs(os.path.dirname(self.cache_path) or ".", exist_ok=True)
        with open(self.cache_path, "w") as f:
            json.dump({
                "cache_version": _CACHE_FILE_VERSION,
                "artifact_fingerprint": self.artifact_fingerprint,
                "chip": self.chip.name,
                "entries": self._cache,
            }, f, indent=0)

    # ---------- candidates ----------
    def _config(self, m: int, n: int, k: int, block, dtype: str
                ) -> GemmConfig:
        """A candidate GemmConfig; on the H100 at the tile's ring depth."""
        bm, bn, bk = (int(x) for x in block)
        return GemmConfig(
            m=m, n=n, k=k, block_m=bm, block_n=bn, block_k=bk, dtype=dtype,
            stages=tile_stages((bm, bn, bk)) if self.on_card else 2)

    def candidate_configs(self, m: int, n: int, k: int,
                          dtype: str = "bf16") -> list[GemmConfig]:
        """The chip's candidate blocks for one shape. H100: the compiled
        tiles of `h100_candidate_tiles`. Simulated chips: VMEM-valid
        blocks clipped to the (padded) problem extents, as the reference
        enumerates them."""
        dtype = canon_dtype(dtype)
        if self.on_card:
            return [self._config(m, n, k, t, dtype)
                    for t in h100_candidate_tiles(m, n, k, dtype)]
        bm_cap = _roundup(m, 8)
        bn_cap = _roundup(n, 128)
        bk_cap = _roundup(k, 128)
        cand = [
            GemmConfig(m=m, n=n, k=k, block_m=bm, block_n=bn, block_k=bk,
                       dtype=dtype)
            for bm in _BM if bm <= bm_cap * 2
            for bn in _BN if bn <= bn_cap * 2
            for bk in _BK if bk <= bk_cap * 2
        ]
        if not cand:
            return []
        valid = self.sim.analyze_batch(cand)["valid"]
        return [cfg for cfg, ok in zip(cand, valid) if ok]

    def candidate_table(self, m: int, n: int, k: int, dtype: str
                        ) -> tuple[list[GemmConfig], np.ndarray]:
        """Candidate list + precomputed feature table for one shape bucket
        (LRU-cached: the grid is static per (chip, dtype), so repeat calls
        — cache misses after retraining, other objectives — skip both the
        validity filter and feature building)."""
        dtype = canon_dtype(dtype)
        key = (m, n, k, dtype)
        with self._lock:
            hit = self._cand_cache.get(key)
            if hit is not None:
                self._cand_cache.move_to_end(key)
                return hit
        cfgs = self.candidate_configs(m, n, k, dtype)
        X = (features_matrix(cfgs, chip=self.chip) if cfgs
             else np.zeros((0, len(self.predictor.feature_names))))
        with self._lock:
            self._cand_cache[key] = (cfgs, X)
            self._cand_cache.move_to_end(key)
            while len(self._cand_cache) > self._cand_cache_size:
                self._cand_cache.popitem(last=False)
        return cfgs, X

    # ---------- scoring ----------
    @staticmethod
    def _objective_scores(pred: dict, objective: str):
        if objective == "runtime":
            return pred["runtime_ms"]
        if objective in ("energy", "power"):
            return pred["energy_j"] if objective == "energy" else pred["power_w"]
        if objective == "edp":
            return pred["energy_j"] * pred["runtime_ms"]
        raise ValueError(f"unknown objective {objective!r}")

    def _use_torch_scorer(self) -> bool:
        if not self.predictor.supports_compile():
            return False
        if self.scorer != "auto":
            return self.scorer == "torch"
        return self.device.type == "cuda"

    def _predict_features(self, X: np.ndarray) -> np.ndarray:
        """(N, F) raw features -> (N, T) predictions via the float64 torch
        scorer on the tuner's device or the vectorized stacked-descent
        estimator — see the `scorer` constructor arg."""
        if self._use_torch_scorer():
            fn = self.predictor.torch_predictor(device=self.device, x64=True)
            return fn(X).cpu().numpy()
        table = {name: X[:, i]
                 for i, name in enumerate(self.predictor.feature_names)}
        return self.predictor.predict_matrix(table)

    def _scores_from_matrix(self, Y, objective: str):
        idx = {t: i for i, t in enumerate(self.predictor.target_names)}
        pred = {t: Y[:, i] for t, i in idx.items()}
        return self._objective_scores(pred, objective)

    def rank(self, cfgs: Sequence[GemmConfig], objective: str = "runtime",
             features: np.ndarray | None = None) -> np.ndarray:
        """Ascending-score candidate order from one batched scorer call."""
        X = (features if features is not None
             else features_matrix(cfgs, chip=self.chip))
        Y = self._predict_features(X)
        # stable: coarse tree predictors tie often, and in-graph ranking
        # breaks ties by index — keep both paths' orders identical.
        return np.argsort(self._scores_from_matrix(Y, objective),
                          kind="stable")

    # ---------- in-graph ranking on the tuner's device ----------
    def _graph_blocks(self) -> tuple[np.ndarray, np.ndarray]:
        """The static (C, 3) candidate block grid and its (C,) ring depths:
        the compiled tiles on the H100, the reference's block grid on the
        simulated chips. Shape-dependent pruning is the validity mask."""
        if self.on_card:
            blocks = np.array(TILE_SHAPES, dtype=np.int64)
            return blocks, np.array([tile_stages(t) for t in TILE_SHAPES],
                                    dtype=np.float64)
        blocks = np.array([(bm, bn, bk) for bm in _BM for bn in _BN
                           for bk in _BK], dtype=np.int64)
        return blocks, np.full(len(blocks), 2.0)

    def rank_in_graph(self, shapes: Sequence[tuple[int, int, int]], *,
                      dtype: str = "bf16", objective: str = "runtime",
                      top_k: int | None = None, x64: bool = True
                      ) -> tuple[list[list[GemmConfig]], np.ndarray]:
        """Rank the candidate grid for a fleet of shapes on the tuner's
        device.

        The candidate feature grid is built with torch ops
        (`graph_candidate_features`) over the static block grid, scored
        through the torch scorer, and the objective's top-k taken there,
        with ties broken by grid index as the trace-time ranking breaks
        them. ``x64=True`` (default) scores in float64, bit-identical to
        `rank()`, so both return the same winners; ``x64=False`` is the
        approximate float32 scorer. The validity mask is the reference's
        candidate rule on the simulated chips, and on the H100 the tiles
        of `h100_candidate_tiles` (from `plan`, on the host).

        Returns ``(top_cfgs, top_scores)``: per shape, up to `top_k`
        candidate `GemmConfig`s in ascending predicted-objective order
        (fewer when the valid set is smaller; empty when no candidate
        fits) and the (S, top_k) score matrix (+inf past the valid set).
        """
        dtype = canon_dtype(dtype)
        self._objective_scores(
            {t: np.zeros(1) for t in ("runtime_ms", "power_w", "energy_j")},
            objective)
        blocks, stages = self._graph_blocks()
        k = min(top_k if top_k is not None else self.verify_top_k,
                len(blocks))
        S = len(shapes)
        if S == 0:
            return [], np.zeros((0, k))
        mnk = np.array([tuple(int(x) for x in s) for s in shapes],
                       dtype=np.int64)
        feats, valid = graph_candidate_features(
            mnk, blocks, self.chip, dtype, device=self.device, stages=stages)
        if self.on_card:
            tiles = [tuple(int(x) for x in b) for b in blocks]
            mask = np.array([[t in ok for t in tiles] for ok in (
                set(h100_candidate_tiles(m, n, kk, dtype))
                for m, n, kk in mnk)])
            valid = torch.as_tensor(mask, device=self.device)
        C, F = feats.shape[1], feats.shape[2]
        Y = self.predictor.torch_predictor(device=self.device, x64=x64)(
            feats.reshape(S * C, F))
        score = self._scores_from_matrix(Y, objective).reshape(S, C)
        score = torch.where(valid, score,
                            torch.full_like(score, float("inf")))
        top, idx = torch.sort(score, dim=1, stable=True)
        scores = top[:, :k].cpu().numpy()
        idx = idx[:, :k].cpu().numpy()
        top_cfgs: list[list[GemmConfig]] = []
        for i, (m, n, kk) in enumerate(mnk):
            top_cfgs.append([
                self._config(int(m), int(n), int(kk), blocks[idx[i, j]],
                             dtype)
                for j in range(k) if np.isfinite(scores[i, j])])
        return top_cfgs, scores

    # ---------- tuning ----------
    @staticmethod
    def _key(m: int, n: int, k: int, dtype: str, objective: str) -> str:
        return f"{m},{n},{k},{dtype},{objective}"

    def _verify(self, cfgs: list[GemmConfig], measure_fn=None,
                objective: str = "runtime") -> dict:
        """Measure the flat top-k list on the chip's substrate (on the
        card, with its power read for every objective but "runtime")."""
        if measure_fn is not None:
            return measure_fn(cfgs)
        if self.on_card:
            power = objective != "runtime"
            if power not in self._card_measure:
                self._card_measure[power] = measure_many(
                    card_measure_fn(device=self.device, power=True) if power
                    else card_measure_fn(device=self.device))
            return self._card_measure[power](cfgs)
        return self.sim.measure_batch(cfgs)

    def best_config(self, m: int, n: int, k: int, *, dtype: str = "bf16",
                    objective: str = "runtime", rank_mode: str = "auto",
                    measure_fn=None) -> BlockConfig:
        return self.tune_many([(m, n, k)], dtype=dtype, objective=objective,
                              rank_mode=rank_mode, measure_fn=measure_fn)[0]

    def tune_many(self, shapes: Sequence[tuple[int, int, int]], *,
                  dtype: str = "bf16", objective: str = "runtime",
                  rank_mode: str = "auto", measure_fn=None
                  ) -> list[BlockConfig]:
        """Tune a fleet of (m, n, k) shapes in one pass: all uncached
        shapes share one batched ranking pass and one batched top-k
        verification sweep, then land in the winner cache together.

        `rank_mode` selects the ranking path: "graph" scores candidates
        on the tuner's device (`rank_in_graph`), "trace" ranks in Python
        over the cached candidate tables, and "auto" (default) picks
        "graph" exactly when the torch scorer is the rank backend (a
        tuner on the card; see `scorer`). Both modes produce the same
        winners.

        `measure_fn`, when given, replaces the chip's substrate for the
        verification sweep. It is called once with the flat list of top-k
        `GemmConfig`s (all shapes concatenated) and must return a
        telemetry-like mapping with "runtime_ms", "power_w", and
        "energy_j" arrays aligned with the input order.
        """
        dtype = canon_dtype(dtype)
        if rank_mode not in ("auto", "graph", "trace"):
            raise ValueError(f"unknown rank_mode {rank_mode!r}")
        out: list[BlockConfig | None] = [None] * len(shapes)
        todo: list[int] = []
        with self._lock:
            for i, (m, n, k) in enumerate(shapes):
                hit = self._cache_get(self._key(m, n, k, dtype, objective))
                if hit is not None:
                    out[i] = BlockConfig(*hit)
                else:
                    todo.append(i)
        if not todo:
            return out  # type: ignore[return-value]

        use_graph = (rank_mode == "graph"
                     or (rank_mode == "auto" and self._use_torch_scorer()))
        # rank: per-uncached-shape top-k candidates, ascending predicted
        # objective. An empty top list means no candidate fits (BASELINE
        # fallback — cached too: the empty set is deterministic per
        # bucket, so never re-enumerate).
        groups: list[tuple[int, list[GemmConfig]]] = []
        if use_graph:
            tops_all, _ = self.rank_in_graph(
                [shapes[i] for i in todo], dtype=dtype, objective=objective)
            for i, top in zip(todo, tops_all):
                if top:
                    groups.append((i, top))
                else:
                    out[i] = BASELINE
        else:
            trace_groups: list[tuple[int, list[GemmConfig], np.ndarray]] = []
            for i in todo:
                m, n, k = shapes[i]
                cfgs, X = self.candidate_table(m, n, k, dtype)
                if not cfgs:
                    out[i] = BASELINE
                else:
                    trace_groups.append((i, cfgs, X))
            if trace_groups:
                # one scorer call over every candidate of every shape
                scores = self._scores_from_matrix(
                    self._predict_features(
                        np.concatenate([X for _, _, X in trace_groups])),
                    objective)
                off = 0
                for i, cfgs, _X in trace_groups:
                    # stable sort: tie-break by index like in-graph top-k
                    order = np.argsort(scores[off:off + len(cfgs)],
                                       kind="stable")
                    groups.append(
                        (i, [cfgs[j] for j in order[:self.verify_top_k]]))
                    off += len(cfgs)

        winners: dict[int, tuple[int, int, int]] = {}
        if groups:
            # one batched verification sweep across all shapes
            flat = [c for _, top in groups for c in top]
            tel = self._verify(flat, measure_fn, objective)
            self.last_verification = (flat, tel)
            meas = self._objective_scores(
                {t: np.asarray(tel[t], dtype=np.float64)
                 for t in ("runtime_ms", "power_w", "energy_j")},
                objective)
            off = 0
            for i, top in groups:
                s = meas[off:off + len(top)]
                w = top[int(np.argmin(s))]
                winners[i] = (w.block_m, w.block_n, w.block_k)
                out[i] = BlockConfig(*winners[i])
                off += len(top)

        with self._lock:
            for i in todo:
                m, n, k = shapes[i]
                best = winners.get(i)
                if best is None:  # BASELINE fallback
                    best = BASELINE.as_tuple()
                self._cache_put(self._key(m, n, k, dtype, objective), best)
            self._write_cache_locked()
        return out  # type: ignore[return-value]

    def tune_report(self, m: int, n: int, k: int, *, dtype: str = "bf16",
                    objective: str = "runtime") -> dict:
        """Tuned-vs-baseline gains (the paper's 3.2x / 22% claims), priced
        by the chip's simulator: on the H100 a model's estimate, not a
        reading (the card's own comparison is `chip_smoke.py` phase 8)."""
        dtype = canon_dtype(dtype)
        best = self.best_config(m, n, k, dtype=dtype, objective=objective)
        tb = self.sim.analyze(self._config(m, n, k, BASELINE.as_tuple(),
                                           dtype))
        tt = self.sim.analyze(self._config(m, n, k, best.as_tuple(), dtype))
        return {
            "m": m, "n": n, "k": k, "dtype": dtype, "objective": objective,
            "chip": self.chip.name,
            "artifact_fingerprint": self.artifact_fingerprint,
            "baseline": BASELINE.as_tuple(),
            "best": best.as_tuple(),
            "baseline_runtime_ms": tb.runtime_ms,
            "tuned_runtime_ms": tt.runtime_ms,
            "speedup": tb.runtime_ms / tt.runtime_ms,
            "baseline_power_w": tb.power_w,
            "tuned_power_w": tt.power_w,
            "power_reduction_pct": 100.0 * (1 - tt.power_w / tb.power_w),
            "baseline_energy_j": tb.energy_j,
            "tuned_energy_j": tt.energy_j,
            "energy_reduction_pct": 100.0 * (1 - tt.energy_j / tb.energy_j),
        }


# ---------- process-wide per-chip tuners ----------
_GLOBAL: dict[str, GemmAutotuner] = {}
_GLOBAL_LOCK = threading.Lock()


def fit_card_predictor(table: dict[str, np.ndarray]) -> PerfPredictor:
    """The H100's predictor, fitted on a table the card measured: the
    paper's Random Forest (100 trees of depth 6) in the paper's direct
    regression on log targets. The reference's residual on the naive
    roofline anchor is not used here: on the card's sweep, where the
    general path's transposed bf16 rows run up to 9x slower than nn at the
    same shape and tile, its held-out runtime R2 falls to 0.29-0.69 over
    split seeds 0-3, against 0.81-0.88 direct (PERF.md, Findings)."""
    return PerfPredictor(model="rf", residual=False,
                         chip=H100.name).fit(table)


def build_default_predictor(artifacts_dir: str = DEFAULT_ARTIFACTS_DIR,
                            n_train: int = 4000,
                            force_retrain: bool = False,
                            chip: ChipSpec | str = H100,
                            device: str | torch.device = "cuda"
                            ) -> PerfPredictor:
    """Load the persisted per-chip predictor artifact or train one on a
    fresh sweep of the chip's substrate: `n_train` simulated configs on the
    simulated chips, fitted as the reference fits them (residual on the
    roofline anchor, small forest); on the H100 the card itself, timed over
    `profiler.h100_sweep_configs` on `device` (`n_train` does not apply)
    and fitted by `fit_card_predictor`. Invalid/legacy/tampered artifacts
    trigger a retrain."""
    chip = get_chip(chip)
    os.makedirs(artifacts_dir, exist_ok=True)
    path = os.path.join(artifacts_dir, f"perf_predictor_{chip.name}.npz")
    if os.path.exists(path) and not force_retrain:
        try:
            return PerfPredictor.load(path)
        except ArtifactError:
            pass
    from repro_torch.core.profiler import (collect_dataset,
                                           h100_sweep_configs,
                                           profile_configs)

    if chip.name == H100.name:
        table = profile_configs(
            h100_sweep_configs(), chip=chip,
            measure_fn=card_measure_fn(device=device))
        pred = fit_card_predictor(table)
    else:
        table = collect_dataset(n_configs=n_train, seed=0, chip=chip)
        pred = PerfPredictor(model="rf", residual=True, fast=True,
                             chip=chip.name).fit(table)
    pred.save(path)
    return pred


def get_tuner(artifacts_dir: str = DEFAULT_ARTIFACTS_DIR,
              chip: ChipSpec | str = H100,
              device: str | torch.device = "cuda") -> GemmAutotuner:
    """The process-wide tuner of `chip` (built on first use, on `device`:
    the card unless the caller asks for the CPU). The H100's verifies
    every candidate on the card; the simulated chips' the top 3."""
    chip = get_chip(chip)
    with _GLOBAL_LOCK:
        tuner = _GLOBAL.get(chip.name)
        if tuner is None:
            device = resolve_device(device)
            predictor = build_default_predictor(artifacts_dir, chip=chip,
                                                device=device)
            tuner = GemmAutotuner(
                predictor,
                chip=chip,
                cache_path=os.path.join(
                    artifacts_dir, f"tuner_cache_{chip.name}.json"),
                device=device,
                verify_top_k=H100_VERIFY_TOP_K if chip.name == H100.name
                else 3,
            )
            _GLOBAL[chip.name] = tuner
        return tuner


def set_tuner(tuner: GemmAutotuner | None,
              chip: ChipSpec | str | None = None) -> None:
    """Install (or clear, with tuner=None and chip=None) global tuners."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if tuner is None and chip is None:
            _GLOBAL = {}
        elif tuner is None:
            _GLOBAL.pop(get_chip(chip).name, None)
        else:
            _GLOBAL[get_chip(chip).name if chip is not None
                    else tuner.chip.name] = tuner
