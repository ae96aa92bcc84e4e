"""Random forest regressor (multi-output, bagging + feature subsampling).

Matches the paper's configuration surface: `RandomForestRegressor(
n_estimators=100, max_depth=6, n_jobs=-1)` wrapped in MultiOutputRegressor.
Multi-output is native here (one tree predicts all targets), which preserves
inter-target structure (runtime/power/energy are physically coupled); a
`per_target=True` mode replicates sklearn's independent-model behaviour
exactly for comparison.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.mlperf.state import (
    CLASS_KEY,
    class_tag,
    register_estimator,
    scalar,
)
from repro_torch.core.mlperf.tree import (
    Binner,
    DecisionTreeRegressor,
    cast_flat_ensemble,
    concat_flat_trees,
    estimators_from_state,
    flatten_ensemble,
    predict_stacked,
)


@register_estimator
class RandomForestRegressor:
    def __init__(
        self,
        n_estimators: int = 100,
        max_depth: int = 6,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        max_features: int | float | str | None = 1.0,
        bootstrap: bool = True,
        max_bins: int = 255,
        random_state: int | None = None,
        n_jobs: int | None = None,  # accepted for API parity; single-core env
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.max_bins = max_bins
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.estimators_: list[DecisionTreeRegressor] = []
        self.binner_: Binner | None = None
        self.n_targets_: int | None = None
        self._stacked: dict[str, np.ndarray] | None = None

    def fit(self, X, y, sample_weight=None):
        self._stacked = None
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if y.ndim == 1:
            y = y[:, None]
        self.n_targets_ = y.shape[1]
        n = len(X)
        if sample_weight is None:
            sample_weight = np.ones(n)
        rng = np.random.default_rng(self.random_state)
        # Shared binning across the whole forest: bin once, reuse per tree.
        self.binner_ = Binner(self.max_bins).fit(X)
        Xb = self.binner_.transform(X)
        self.estimators_ = []
        for i in range(self.n_estimators):
            tree = DecisionTreeRegressor(
                max_depth=self.max_depth,
                min_samples_split=self.min_samples_split,
                min_samples_leaf=self.min_samples_leaf,
                max_features=self.max_features,
                max_bins=self.max_bins,
                random_state=int(rng.integers(0, 2**31 - 1)),
            )
            if self.bootstrap:
                # bagging via multiplicity weights (no row copying)
                counts = np.bincount(
                    rng.integers(0, n, size=n), minlength=n
                ).astype(np.float64)
                w = counts * sample_weight
            else:
                w = sample_weight
            tree.fit(X, y, sample_weight=w, binner=self.binner_, Xb=Xb)
            self.estimators_.append(tree)
        return self

    def _stacked_arrays(self) -> dict[str, np.ndarray]:
        if self._stacked is None:
            self._stacked = flatten_ensemble(
                [t.tree_ for t in self.estimators_])
        return self._stacked

    def predict(self, X) -> np.ndarray:
        """Mean prediction over all trees — one stacked descent, no
        Python per-tree loop (same leaves as `predict_per_tree_loop`)."""
        assert self.estimators_, "not fitted"
        X = np.asarray(X, dtype=np.float64)
        leaves = predict_stacked(self._stacked_arrays(), X,
                                 max_depth=self.max_depth)  # (T, N, K)
        acc = leaves.sum(axis=0) / len(self.estimators_)
        return acc[:, 0] if self.n_targets_ == 1 else acc

    def predict_per_tree_loop(self, X) -> np.ndarray:
        """Pre-vectorization reference path (per-tree Python loop), kept
        for parity tests and rank-latency benchmarks."""
        assert self.estimators_, "not fitted"
        X = np.asarray(X, dtype=np.float64)
        acc = np.zeros((len(X), self.n_targets_))
        for tree in self.estimators_:
            acc += tree.tree_.predict_raw(X)
        acc /= len(self.estimators_)
        return acc[:, 0] if self.n_targets_ == 1 else acc

    @property
    def feature_importances_(self) -> np.ndarray:
        imps = np.stack([t.feature_importances_ for t in self.estimators_])
        imp = imps.mean(axis=0)
        s = imp.sum()
        return imp / s if s > 0 else imp

    # ---- flat export for compiled prediction (see compiled.py) ----
    def to_flat_arrays(self, *, float64: bool = False
                       ) -> dict[str, np.ndarray]:
        """Global-id flat ensemble (see `flatten_ensemble`) plus the
        descent step count: feature/threshold/left/right over concatenated
        nodes, `roots` (T,), value (total_nodes, n_targets), max_depth.
        `float64=True` keeps exact thresholds/values so x64 traversal takes
        bit-identical branches vs the numpy reference.
        """
        return {
            **cast_flat_ensemble(self._stacked_arrays(), float64=float64),
            "max_depth": np.int32(self.max_depth),
        }

    # ---- flat-array state contract (see mlperf.state) ----
    def to_state(self) -> dict[str, np.ndarray]:
        assert self.estimators_, "not fitted"
        state = concat_flat_trees([t.tree_ for t in self.estimators_])
        state[CLASS_KEY] = class_tag(type(self))
        state["n_features"] = scalar(np.int64(self.estimators_[0].n_features_))
        state["n_targets"] = scalar(np.int64(self.n_targets_))
        state["max_depth"] = scalar(np.int64(self.max_depth))
        return state

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray]
                   ) -> "RandomForestRegressor":
        estimators = estimators_from_state(state)
        obj = cls(n_estimators=len(estimators),
                  max_depth=int(state["max_depth"][()]))
        obj.n_targets_ = int(state["n_targets"][()])
        obj.estimators_ = estimators
        return obj
