"""Gradient-boosted regression trees (squared loss) — the XGBoost stand-in
for the paper's Table VI comparison.

Boosting on squared loss fits each round's tree to the current residuals with
shrinkage. Multi-output targets share tree structure (residual vector per
row), which mirrors multi-output XGBoost's `multi_strategy="multi_output_tree"`.
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
class GradientBoostedTreesRegressor:
    def __init__(
        self,
        n_estimators: int = 200,
        learning_rate: float = 0.1,
        max_depth: int = 4,
        min_samples_leaf: int = 3,
        subsample: float = 0.9,
        max_features: int | float | str | None = None,
        max_bins: int = 255,
        random_state: int | None = None,
    ):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.subsample = subsample
        self.max_features = max_features
        self.max_bins = max_bins
        self.random_state = random_state
        self.estimators_: list[DecisionTreeRegressor] = []
        self.base_: np.ndarray | None = None
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
        binner = Binner(self.max_bins).fit(X)
        Xb = binner.transform(X)
        self.base_ = y.mean(axis=0)
        pred = np.tile(self.base_, (n, 1))
        self.estimators_ = []
        for i in range(self.n_estimators):
            resid = y - pred
            w = sample_weight.copy()
            if self.subsample < 1.0:
                mask = rng.random(n) < self.subsample
                w = w * mask
                if w.sum() == 0:
                    continue
            tree = DecisionTreeRegressor(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                max_features=self.max_features,
                max_bins=self.max_bins,
                random_state=int(rng.integers(0, 2**31 - 1)),
            )
            tree.fit(X, resid, sample_weight=w, binner=binner, Xb=Xb)
            upd = tree.tree_.predict_binned(Xb)
            pred = pred + self.learning_rate * upd
            self.estimators_.append(tree)
        return self

    def _stacked_arrays(self) -> dict[str, np.ndarray]:
        if self._stacked is None:
            self._stacked = flatten_ensemble(
                [t.tree_ for t in self.estimators_])
        return self._stacked

    def predict(self, X) -> np.ndarray:
        """base + sum of lr-scaled per-round trees — one stacked descent
        across every boosting round (same leaves as
        `predict_per_tree_loop`). Leaves are scaled *before* the
        tree-axis sum so the compiled lowering (which bakes lr into the
        exported leaf values) accumulates bit-identical addends."""
        assert self.base_ is not None, "not fitted"
        X = np.asarray(X, dtype=np.float64)
        acc = np.tile(self.base_, (len(X), 1))
        if self.estimators_:
            leaves = predict_stacked(self._stacked_arrays(), X,
                                     max_depth=self.max_depth)  # (T, N, K)
            acc = acc + (self.learning_rate * leaves).sum(axis=0)
        return acc[:, 0] if self.n_targets_ == 1 else acc

    def predict_per_tree_loop(self, X) -> np.ndarray:
        """Pre-vectorization reference path (per-round Python loop), kept
        for parity tests and rank-latency benchmarks."""
        assert self.base_ is not None, "not fitted"
        X = np.asarray(X, dtype=np.float64)
        acc = np.tile(self.base_, (len(X), 1))
        for tree in self.estimators_:
            acc += self.learning_rate * tree.tree_.predict_raw(X)
        return acc[:, 0] if self.n_targets_ == 1 else acc

    # ---- flat export for jit prediction (see compiled.py) ----
    def to_flat_arrays(self, *, float64: bool = False
                       ) -> dict[str, np.ndarray]:
        """Global-id flat ensemble for the weighted-sum descent: the same
        layout forests export, plus the boosting offset `base` (K,). The
        compiled scorer computes ``base + learning_rate * sum(leaves)``
        with the identical accumulation order as the numpy `predict`.
        `float64=True` keeps exact thresholds/values (x64 bit-parity);
        otherwise thresholds get the one-ulp fp32 nudge.
        """
        assert self.base_ is not None, "not fitted"
        base = np.asarray(self.base_, dtype=np.float64)
        flat = (cast_flat_ensemble(self._stacked_arrays(), float64=float64)
                if self.estimators_ else
                {"feature": np.zeros(0, np.int64),
                 "threshold": np.zeros(0),
                 "left": np.zeros(0, np.int64),
                 "right": np.zeros(0, np.int64),
                 "value": np.zeros((0, len(base))),
                 "roots": np.zeros(0, np.int64)})
        return {
            **flat,
            "base": base if float64 else base.astype(np.float32),
            "max_depth": np.int32(self.max_depth),
        }

    # ---- flat-array state contract (see mlperf.state) ----
    def to_state(self) -> dict[str, np.ndarray]:
        assert self.base_ is not None, "not fitted"
        state = concat_flat_trees([t.tree_ for t in self.estimators_])
        state[CLASS_KEY] = class_tag(type(self))
        state["base"] = np.asarray(self.base_, dtype=np.float64)
        state["learning_rate"] = scalar(np.float64(self.learning_rate))
        state["n_features"] = scalar(np.int64(self.estimators_[0].n_features_))
        state["n_targets"] = scalar(np.int64(self.n_targets_))
        state["max_depth"] = scalar(np.int64(self.max_depth))
        return state

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray]
                   ) -> "GradientBoostedTreesRegressor":
        estimators = estimators_from_state(state)
        obj = cls(n_estimators=len(estimators),
                  learning_rate=float(state["learning_rate"][()]),
                  max_depth=int(state["max_depth"][()]))
        obj.base_ = np.asarray(state["base"], dtype=np.float64)
        obj.n_targets_ = int(state["n_targets"][()])
        obj.estimators_ = estimators
        return obj

    def staged_score_path(self, X, y, metric) -> list[float]:
        """Score after each boosting round (for early-stopping analysis)."""
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if y.ndim == 1:
            y = y[:, None]
        acc = np.tile(self.base_, (len(X), 1))
        scores = []
        for tree in self.estimators_:
            acc = acc + self.learning_rate * tree.tree_.predict_raw(X)
            scores.append(metric(y, acc))
        return scores
