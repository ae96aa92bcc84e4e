"""Stacking ensemble: out-of-fold base-model predictions -> ridge meta-learner.

The paper's best model (Table VI, "Stacking Ensemble"): prediction =
sum_i w_i * M_i(x) with learned weights. We learn the combination per target
with a ridge meta-learner on K-fold out-of-fold predictions, which avoids the
leakage a naive refit-on-train stacking would have.
"""

from __future__ import annotations

import copy

import numpy as np

from repro_torch.core.mlperf.linreg import Ridge
from repro_torch.core.mlperf.state import (
    CLASS_KEY,
    class_tag,
    estimator_from_state,
    pack_nested,
    register_estimator,
    scalar,
    unpack_nested,
)


@register_estimator
class StackingRegressor:
    def __init__(
        self,
        base_estimators: list,
        meta_alpha: float = 1e-3,
        n_folds: int = 5,
        passthrough: bool = False,
        random_state: int | None = 0,
    ):
        self.base_estimators = base_estimators
        self.meta_alpha = meta_alpha
        self.n_folds = n_folds
        self.passthrough = passthrough
        self.random_state = random_state
        self.fitted_bases_: list = []
        self.meta_: list[Ridge] = []
        self.n_targets_: int | None = None

    def _meta_features(self, preds: list[np.ndarray], X: np.ndarray) -> np.ndarray:
        Z = np.concatenate([p.reshape(len(X), -1) for p in preds], axis=1)
        if self.passthrough:
            Z = np.concatenate([Z, X], axis=1)
        return Z

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if y.ndim == 1:
            y = y[:, None]
        self.n_targets_ = y.shape[1]
        n = len(X)
        rng = np.random.default_rng(self.random_state)
        fold = rng.integers(0, self.n_folds, size=n)

        # out-of-fold predictions per base model
        oof = [np.zeros((n, self.n_targets_)) for _ in self.base_estimators]
        for k in range(self.n_folds):
            tr, va = fold != k, fold == k
            if va.sum() == 0 or tr.sum() == 0:
                continue
            for bi, proto in enumerate(self.base_estimators):
                est = copy.deepcopy(proto)
                est.fit(X[tr], y[tr])
                p = est.predict(X[va])
                oof[bi][va] = p.reshape(va.sum(), -1)

        Z = self._meta_features(oof, X)
        self.meta_ = []
        for t in range(self.n_targets_):
            m = Ridge(alpha=self.meta_alpha)
            m.fit(Z, y[:, t])
            self.meta_.append(m)

        # refit bases on all data for inference
        self.fitted_bases_ = []
        for proto in self.base_estimators:
            est = copy.deepcopy(proto)
            est.fit(X, y)
            self.fitted_bases_.append(est)
        return self

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        preds = [est.predict(X).reshape(len(X), -1) for est in self.fitted_bases_]
        Z = self._meta_features(preds, X)
        out = np.stack([m.predict(Z) for m in self.meta_], axis=1)
        return out[:, 0] if self.n_targets_ == 1 else out

    # ---- flat-array state contract (see mlperf.state) ----
    def to_state(self) -> dict[str, np.ndarray]:
        assert self.fitted_bases_, "not fitted"
        state: dict[str, np.ndarray] = {
            CLASS_KEY: class_tag(type(self)),
            "n_bases": scalar(np.int64(len(self.fitted_bases_))),
            "n_targets": scalar(np.int64(self.n_targets_)),
            "passthrough": scalar(np.bool_(self.passthrough)),
            # meta ridges are per-target with 1-d coefs: stack to (T, Z)
            "meta_coef": np.stack(
                [np.asarray(m.coef_, dtype=np.float64) for m in self.meta_]),
            "meta_intercept": np.array(
                [float(np.ravel(m.intercept_)[0]) for m in self.meta_]),
        }
        for i, est in enumerate(self.fitted_bases_):
            state.update(pack_nested(f"base{i}", est.to_state()))
        return state

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray]) -> "StackingRegressor":
        obj = cls([], passthrough=bool(state["passthrough"][()]))
        obj.n_targets_ = int(state["n_targets"][()])
        obj.fitted_bases_ = [
            estimator_from_state(unpack_nested(state, f"base{i}"))
            for i in range(int(state["n_bases"][()]))
        ]
        meta_coef = np.asarray(state["meta_coef"], dtype=np.float64)
        meta_intercept = np.asarray(state["meta_intercept"], dtype=np.float64)
        obj.meta_ = []
        for t in range(obj.n_targets_):
            m = Ridge(alpha=obj.meta_alpha)
            m.coef_ = meta_coef[t]
            m.intercept_ = float(meta_intercept[t])
            obj.meta_.append(m)
        return obj
