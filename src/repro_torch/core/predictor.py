"""Multi-target performance predictor — the paper's Algorithm 2 pipeline.

  Pipeline([('preprocessor', StandardScaler over numeric features),
            ('regressor', MultiOutput(RandomForest(n_estimators=100,
                                                   max_depth=6)))])

predicting [runtime_ms, power_w, energy_j, tflops] simultaneously.
`model=` selects the Table VI architecture: rf / gbdt / linreg / stacking.

Persistence is pickle-free: `save`/`load` speak a versioned artifact format —
one ``.npz`` holding the estimator's flat-array state (see
``repro_torch.core.mlperf.state``) plus a ``__meta__`` JSON record (schema
version, chip, feature/target schema, model name, log/residual flags,
content fingerprint). `load` validates the metadata and refuses artifacts whose
feature schema doesn't match the running code or whose arrays were tampered
with; the fingerprint also versions downstream caches (the autotuner keys its
winner cache by it, so retraining invalidates stale winners).

The port's copy of the JAX package's `repro.core.predictor`, with the same
artifact format, schema version and fingerprint: an artifact saved by
either package loads in the other and predicts the same. Fitting and
`predict` are numpy in both; where the reference scores through jax, the
port scores through torch on a device (`torch_predictor`).
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from repro_torch.core.chips import TPU_V5E, get_chip
from repro_torch.core.features import NUMERIC_FEATURES, TARGETS
from repro_torch.core.mlperf import (
    GradientBoostedTreesRegressor,
    LinearRegression,
    RandomForestRegressor,
    StackingRegressor,
    StandardScaler,
    estimator_from_state,
    pack_nested,
    regression_report,
    unpack_nested,
)
from repro_torch.core.mlperf.compiled import lower_estimator, supports_compile
from repro_torch.device import resolve_device

ARTIFACT_FORMAT = "repro.perf_predictor"
ARTIFACT_SCHEMA_VERSION = 1
_META_KEY = "__meta__"


class ArtifactError(ValueError):
    """A predictor artifact is malformed, tampered, or schema-incompatible."""


def artifact_fingerprint(meta: dict, state: dict) -> str:
    """Content hash of an artifact's (meta flags, state arrays) — the
    exact digest `PerfPredictor.fingerprint` would produce for a loaded
    copy. Schema upgraders use this to restamp ``meta["fingerprint"]``
    after transforming arrays (see docs/artifacts.md)."""
    h = hashlib.sha256()
    h.update(json.dumps({
        "model": meta["model"],
        "chip": meta.get("chip"),
        "nominal_power_w": meta.get("nominal_power_w"),
        "feature_names": list(meta["feature_names"]),
        "target_names": list(meta["target_names"]),
        "log_targets": bool(meta["log_targets"]),
        "residual": bool(meta["residual"]),
    }, sort_keys=True).encode())
    for key, arr in sorted(state.items()):
        h.update(key.encode())
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


# Schema migrations: version N -> a callable producing the version-N+1
# (meta, state) pair. When ARTIFACT_SCHEMA_VERSION is bumped, register the
# v(N-1) -> v(N) upgrader here so existing artifacts load without a
# retrain; `load` walks the chain until it reaches the current version and
# refuses artifacts with no path. An upgrader must bump
# meta["schema_version"] itself and restamp meta["fingerprint"] via
# `artifact_fingerprint` whenever it rewrites arrays or flag fields —
# the tamper check runs after the chain. Contract + example in
# docs/artifacts.md.
_SCHEMA_UPGRADERS: dict[int, object] = {}


def make_model(name: str, random_state: int = 0, fast: bool = False):
    """Table VI model zoo. `fast` shrinks ensembles for unit tests."""
    ne = 24 if fast else 100
    if name == "rf":
        return RandomForestRegressor(n_estimators=ne, max_depth=6,
                                     random_state=random_state, n_jobs=-1)
    if name == "rf_deep":  # beyond-paper: depth 12 (see EXPERIMENTS §Perf)
        return RandomForestRegressor(n_estimators=ne, max_depth=12,
                                     random_state=random_state, n_jobs=-1)
    if name == "gbdt":
        return GradientBoostedTreesRegressor(
            n_estimators=60 if fast else 300, max_depth=5,
            random_state=random_state)
    if name == "linreg":
        return LinearRegression()
    if name == "stacking":
        return StackingRegressor(
            [
                RandomForestRegressor(n_estimators=ne, max_depth=10,
                                      random_state=random_state),
                GradientBoostedTreesRegressor(
                    n_estimators=60 if fast else 250, max_depth=5,
                    random_state=random_state),
                LinearRegression(),
            ],
            n_folds=4,
        )
    raise ValueError(f"unknown model {name!r}")


MODEL_NAMES = ("rf", "rf_deep", "gbdt", "linreg", "stacking")


def _chip_nominal_power(chip: str | None) -> float:
    """Anchor power from the chip the table was collected on (the old code
    hardcoded 130.0, which is only right for TPU v5e)."""
    if chip is not None:
        try:
            return get_chip(chip).nominal_power_w
        except ValueError:
            pass  # unregistered chip name: fall back to the default chip
    return TPU_V5E.nominal_power_w


def _exp(x: torch.Tensor) -> torch.Tensor:
    """`torch.exp`, taken on the host for float64 on the card. CUDA's
    float64 `exp` is not numpy's: on the H100 it differs from numpy in the
    last bit on a share of inputs, while the CPU's torch `exp` matches
    numpy's. The float64 scorer's contract is numpy's bits (`chip_smoke.py`
    phase 8 checks them on the card), so its (N, log-targets) block takes
    one round trip to the host."""
    if x.dtype == torch.float64 and x.device.type != "cpu":
        return torch.exp(x.cpu()).to(x.device)
    return torch.exp(x)


class PerfPredictor:
    """fit(table) / predict(table) over dict-of-columns GEMM tables.

    Targets are learned in log-space for runtime/energy (they span 5+ orders
    of magnitude; the paper's high mean-%-error on energy is exactly the
    linear-space pathology) — `log_targets=False` reproduces the paper's
    exact setup for the faithful baseline.
    """

    LOG_TARGETS = ("runtime_ms", "energy_j", "tflops")

    def __init__(self, model: str = "rf", log_targets: bool = True,
                 residual: bool = False, random_state: int = 0,
                 fast: bool = False, chip: str | None = None):
        """residual=True predicts log(target / analytical_anchor) for the
        log-scale targets — the anchor (a naive roofline estimate from
        published chip specs) carries the 5-orders-of-magnitude dynamic
        range and the forest learns bounded corrections. This is the
        beyond-paper hybrid analytical+ML mode (EXPERIMENTS.md §Perf-pred);
        residual=False is the paper-faithful direct-regression mode.
        """
        self.model_name = model
        self.chip_name = chip  # substrate the training table came from
        self.nominal_power_w = _chip_nominal_power(chip)
        self.log_targets = log_targets
        self.residual = residual
        self.scaler = StandardScaler()
        # Targets are standardized too: with a shared multi-output tree the
        # split criterion sums variance across targets, so an unscaled target
        # (power_w, var ~1e3) would monopolize every split.
        self.y_scaler = StandardScaler()
        self.model = make_model(model, random_state=random_state, fast=fast)
        self.feature_names = list(NUMERIC_FEATURES)
        self.target_names = list(TARGETS)
        self._fitted = False
        self._reset_caches()

    def _reset_caches(self) -> None:
        self._torch_cache: dict[tuple[str, bool], object] = {}
        self._fingerprint: str | None = None

    # ----- table <-> matrix -----
    def _X(self, table: dict[str, np.ndarray]) -> np.ndarray:
        cols = [np.asarray(table[k], dtype=np.float64)
                for k in self.feature_names]
        return np.stack(cols, axis=1)

    def _anchors(self, table: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Analytical anchors per log-target (naive roofline estimates)."""
        rt = (np.maximum(np.asarray(table["naive_compute_ms"], np.float64),
                         np.asarray(table["naive_memory_ms"], np.float64))
              + np.asarray(table["naive_overhead_ms"], np.float64))
        rt = np.maximum(rt, 1e-9)
        flops = np.asarray(table["total_flops"], np.float64)
        return {
            "runtime_ms": rt,
            "energy_j": rt / 1e3 * self.nominal_power_w,
            "tflops": flops / (rt / 1e3) / 1e12,
        }

    def _encode_y(self, Y: np.ndarray,
                  table: dict[str, np.ndarray] | None = None) -> np.ndarray:
        Y = Y.copy()
        anchors = self._anchors(table) if (self.residual and table) else {}
        if self.log_targets:
            for i, t in enumerate(self.target_names):
                if t in self.LOG_TARGETS:
                    y = np.maximum(Y[:, i], 1e-12)
                    if t in anchors:
                        y = y / np.maximum(anchors[t], 1e-12)
                    Y[:, i] = np.log(y)
        return Y

    def _decode_y(self, Y: np.ndarray,
                  table: dict[str, np.ndarray] | None = None) -> np.ndarray:
        Y = Y.copy()
        anchors = self._anchors(table) if (self.residual and table) else {}
        if self.log_targets:
            for i, t in enumerate(self.target_names):
                if t in self.LOG_TARGETS:
                    y = np.exp(Y[:, i])
                    if t in anchors:
                        y = y * np.maximum(anchors[t], 1e-12)
                    Y[:, i] = y
        return Y

    # ----- public API -----
    def fit(self, table: dict[str, np.ndarray],
            targets: np.ndarray | None = None) -> "PerfPredictor":
        X = self._X(table)
        if targets is None:
            targets = np.stack(
                [np.asarray(table[t], dtype=np.float64)
                 for t in self.target_names], axis=1)
        Xs = self.scaler.fit_transform(X)
        self.model.fit(
            Xs, self.y_scaler.fit_transform(self._encode_y(targets, table)))
        self._fitted = True
        self._reset_caches()
        return self

    def predict(self, table: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        Y = self.predict_matrix(table)
        return {t: Y[:, i] for i, t in enumerate(self.target_names)}

    def predict_matrix(self, table: dict[str, np.ndarray]) -> np.ndarray:
        assert self._fitted, "predictor not fitted"
        X = self.scaler.transform(self._X(table))
        Y = np.asarray(self.model.predict(X), dtype=np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        return self._decode_y(self.y_scaler.inverse_transform(Y), table)

    def predict_matrix_reference(self, table: dict[str, np.ndarray]
                                 ) -> np.ndarray:
        """Pre-refactor prediction path: the estimator's per-tree Python
        loop instead of the stacked descent. Kept as the parity/latency
        baseline for tests and benchmarks."""
        assert self._fitted, "predictor not fitted"
        X = self.scaler.transform(self._X(table))
        predict = getattr(self.model, "predict_per_tree_loop",
                          self.model.predict)
        Y = np.asarray(predict(X), dtype=np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        return self._decode_y(self.y_scaler.inverse_transform(Y), table)

    def evaluate(self, table: dict[str, np.ndarray]) -> dict:
        """Table IV: per-target R2/MSE/MAE/median%/mean% report."""
        truth = np.stack(
            [np.asarray(table[t], dtype=np.float64)
             for t in self.target_names], axis=1)
        pred = self.predict_matrix(table)
        return regression_report(truth, pred, self.target_names)

    # ----- torch scorer (every lowered estimator family) -----
    def supports_compile(self) -> bool:
        """True when the fitted model has a compiled lowering — all of the
        Table VI zoo (forest, GBDT, linreg/ridge, stacking) does."""
        return supports_compile(self.model)

    def torch_components(self, *, device: str | torch.device = "cuda",
                         x64: bool = False):
        """(params, apply) for embedding the decoded predictor in a larger
        torch computation on `device` (e.g. the autotuner's in-graph
        ranker).

        `apply(params, Xs, X_raw) -> (N, T)`: estimator forward (via the
        compiled lowering) + target decode (y-descaling, log-target exp,
        residual anchor multiply), in the numpy path's order of operations.
        `params` is a dict of tensors on `device`; the decode's divisors
        are among them, because CUDA divides by a host scalar through its
        reciprocal (see `compiled`). The float64 `exp` runs on the host
        (`_exp`).
        """
        device = resolve_device(device)
        lowered = lower_estimator(self.model, float64=x64, device=device)
        ft = torch.float64 if x64 else torch.float32

        def t(v):
            return torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   dtype=ft, device=device)

        params = {
            "est": lowered.params,
            "y_mean": t(self.y_scaler.mean_),
            "y_scale": t(self.y_scaler.scale_),
            "nominal_power": t(self.nominal_power_w),
            "ms_per_s": t(1e3),
            "flop_per_tflop": t(1e12),
        }
        i_nc = self.feature_names.index("naive_compute_ms")
        i_nm = self.feature_names.index("naive_memory_ms")
        i_no = self.feature_names.index("naive_overhead_ms")
        i_fl = self.feature_names.index("total_flops")
        residual = self.residual
        target_names = list(self.target_names)
        log_idx = [i for i, t_ in enumerate(target_names)
                   if self.log_targets and t_ in self.LOG_TARGETS]
        est_apply = lowered.apply

        def apply(p, Xs, X_raw):
            Y = est_apply(p["est"], Xs).reshape(Xs.shape[0], -1)
            Y = Y * p["y_scale"] + p["y_mean"]
            E = _exp(Y[:, log_idx])
            anchors = {}
            if residual:
                rt = (torch.maximum(X_raw[:, i_nc], X_raw[:, i_nm])
                      + X_raw[:, i_no])
                rt = torch.clamp_min(rt, 1e-9)
                anchors = {
                    "runtime_ms": rt,
                    "energy_j": rt / p["ms_per_s"] * p["nominal_power"],
                    "tflops": (X_raw[:, i_fl] / (rt / p["ms_per_s"])
                               / p["flop_per_tflop"]),
                }
            cols = [Y[:, i] for i in range(len(target_names))]
            for j, i in enumerate(log_idx):
                cols[i] = E[:, j]
                if target_names[i] in anchors:
                    cols[i] = cols[i] * torch.clamp_min(
                        anchors[target_names[i]], 1e-12)
            return torch.stack(cols, dim=1)

        return params, apply

    def torch_predictor(self, *, device: str | torch.device = "cuda",
                        x64: bool = False):
        """Scorer over *raw* features on `device` (the card unless the
        caller asks for the CPU): fn(X_raw (N, F)) -> (N, T) tensor of
        decoded predictions, for any estimator family in the zoo. Built
        once per (device, precision) and cached on the instance (refit
        invalidates). ``x64=True`` runs in float64 — branch decisions,
        accumulations and the decode bit-identical to `predict_matrix` —
        which is what the autotuner's scorer uses.
        """
        if not self.supports_compile():
            raise TypeError(
                f"no compiled lowering for model "
                f"{type(self.model).__name__!r}")
        device = resolve_device(device)
        key = (str(device), x64)
        fn = self._torch_cache.get(key)
        if fn is None:
            fn = self._build_torch_predictor(device, x64)
            self._torch_cache[key] = fn
        return fn

    def _build_torch_predictor(self, device: torch.device, x64: bool):
        params, apply = self.torch_components(device=device, x64=x64)
        ft = torch.float64 if x64 else torch.float32
        mean = torch.as_tensor(self.scaler.mean_, dtype=torch.float64,
                               device=device)
        scale = torch.as_tensor(self.scaler.scale_, dtype=torch.float64,
                                device=device)

        # features are standardized in float64, as `predict_matrix` does,
        # and only then cast to the scorer's precision
        def fn(X_raw) -> torch.Tensor:
            X = torch.as_tensor(X_raw, dtype=torch.float64, device=device)
            Xs = (X - mean) / scale
            return apply(params, Xs.to(ft), X.to(ft))

        return fn

    # ----- persistence: versioned .npz artifact -----
    def to_state(self) -> dict[str, np.ndarray]:
        """Everything `predict` needs, as flat numpy arrays."""
        assert self._fitted, "predictor not fitted"
        state = {
            **pack_nested("scaler", self.scaler.to_state()),
            **pack_nested("y_scaler", self.y_scaler.to_state()),
            **pack_nested("model", self.model.to_state()),
        }
        return state

    def meta(self) -> dict:
        """The artifact's JSON metadata record."""
        return {
            "format": ARTIFACT_FORMAT,
            "schema_version": ARTIFACT_SCHEMA_VERSION,
            "model": self.model_name,
            "chip": self.chip_name,
            "nominal_power_w": self.nominal_power_w,
            "feature_names": list(self.feature_names),
            "target_names": list(self.target_names),
            "log_targets": bool(self.log_targets),
            "residual": bool(self.residual),
            "fingerprint": self.fingerprint(),
        }

    def fingerprint(self) -> str:
        """Deterministic content hash of the fitted state + schema/flags.

        Versions the artifact: downstream caches (tuner winners) key on it,
        so retraining — or any array tampering — invalidates them.
        """
        if self._fingerprint is None:
            self._fingerprint = artifact_fingerprint({
                "model": self.model_name,
                "chip": self.chip_name,
                "nominal_power_w": self.nominal_power_w,
                "feature_names": list(self.feature_names),
                "target_names": list(self.target_names),
                "log_targets": bool(self.log_targets),
                "residual": bool(self.residual),
            }, self.to_state())
        return self._fingerprint

    def save(self, path: str) -> None:
        """Write the versioned artifact (.npz arrays + JSON metadata)."""
        meta = self.meta()
        with open(path, "wb") as f:
            np.savez_compressed(f, **{_META_KEY: np.array(json.dumps(meta))},
                                **self.to_state())

    @classmethod
    def load(cls, path: str) -> "PerfPredictor":
        """Load + validate an artifact. Raises ArtifactError on a missing
        or mismatched schema — never unpickles anything."""
        try:
            with np.load(path, allow_pickle=False) as z:
                if _META_KEY not in z.files:
                    raise ArtifactError(
                        f"{path} is not a perf-predictor artifact (no "
                        "__meta__ record; legacy pickle checkpoints are "
                        "not supported — retrain to produce one)")
                meta = json.loads(str(z[_META_KEY][()]))
                state = {k: z[k] for k in z.files if k != _META_KEY}
        except (OSError, ValueError, KeyError) as e:
            if isinstance(e, ArtifactError):
                raise
            raise ArtifactError(f"cannot read artifact {path}: {e}") from e
        if meta.get("format") != ARTIFACT_FORMAT:
            raise ArtifactError(
                f"{path}: unexpected artifact format {meta.get('format')!r}")
        version = meta.get("schema_version")
        while (isinstance(version, int)
               and version < ARTIFACT_SCHEMA_VERSION
               and version in _SCHEMA_UPGRADERS):
            meta, state = _SCHEMA_UPGRADERS[version](meta, state)
            if meta.get("schema_version") != version + 1:
                raise ArtifactError(
                    f"{path}: schema upgrader for v{version} produced "
                    f"version {meta.get('schema_version')}, expected "
                    f"{version + 1}")
            version = meta["schema_version"]
        if version != ARTIFACT_SCHEMA_VERSION:
            raise ArtifactError(
                f"{path}: schema version {meta.get('schema_version')} has "
                f"no upgrade path to supported {ARTIFACT_SCHEMA_VERSION} — "
                "retrain the predictor")
        if list(meta.get("feature_names", [])) != list(NUMERIC_FEATURES):
            raise ArtifactError(
                f"{path}: feature schema mismatch — artifact was trained on "
                f"{meta.get('feature_names')}, this build expects "
                f"{list(NUMERIC_FEATURES)}; retrain the predictor")
        if list(meta.get("target_names", [])) != list(TARGETS):
            raise ArtifactError(
                f"{path}: target schema mismatch — retrain the predictor")
        obj = cls.__new__(cls)
        try:
            obj.model_name = meta["model"]
            obj.chip_name = meta.get("chip")
            obj.nominal_power_w = float(
                meta.get("nominal_power_w",
                         _chip_nominal_power(obj.chip_name)))
            obj.log_targets = bool(meta["log_targets"])
            obj.residual = bool(meta["residual"])
            obj.feature_names = list(meta["feature_names"])
            obj.target_names = list(meta["target_names"])
        except (KeyError, TypeError, ValueError) as e:
            raise ArtifactError(
                f"{path}: incomplete artifact metadata: {e}") from e
        try:
            obj.scaler = StandardScaler.from_state(
                unpack_nested(state, "scaler"))
            obj.y_scaler = StandardScaler.from_state(
                unpack_nested(state, "y_scaler"))
            obj.model = estimator_from_state(unpack_nested(state, "model"))
        except (KeyError, ValueError, IndexError) as e:
            raise ArtifactError(f"{path}: corrupt estimator state: {e}") from e
        obj._fitted = True
        obj._reset_caches()
        if meta.get("fingerprint") != obj.fingerprint():
            raise ArtifactError(
                f"{path}: fingerprint mismatch — artifact arrays or metadata "
                "were modified after save")
        return obj
