"""Ordinary least squares and ridge regression (multi-output).

The paper's baseline model (Tables II/III report its coefficients for the
tiled-matmul study, Table VI its R^2 on the CUTLASS dataset).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.mlperf.state import CLASS_KEY, class_tag, register_estimator


def ordered_affine(X: np.ndarray, coef: np.ndarray,
                   intercept) -> np.ndarray:
    """X @ coef + intercept with a fixed feature-by-feature accumulation.

    BLAS matmuls reassociate the inner sum (blocking, SIMD lanes), so two
    builds — or numpy vs the torch scorer — can disagree in the last ulp.
    Summing per-feature products in declared order pins the result and
    lets the compiled lowering (`compiled._ordered_affine`, the same
    products and adds as separate eager ops) reproduce predictions
    bit-for-bit in float64. F is the feature count
    (tens), so the Python loop over vectorized columns costs nothing at
    serving batch sizes.
    """
    squeeze = coef.ndim == 1
    coef2 = coef[:, None] if squeeze else coef
    acc = np.zeros((len(X), coef2.shape[1]), dtype=np.float64)
    for f in range(coef2.shape[0]):
        acc = acc + X[:, f][:, None] * coef2[f][None, :]
    out = acc[:, 0] if squeeze else acc
    return out + intercept


@register_estimator
class LinearRegression:
    def __init__(self, fit_intercept: bool = True):
        self.fit_intercept = fit_intercept
        self.coef_: np.ndarray | None = None      # (n_features, n_targets) or (n_features,)
        self.intercept_: np.ndarray | float = 0.0

    def fit(self, X, y, sample_weight=None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 1
        if squeeze:
            y = y[:, None]
        if sample_weight is not None:
            sw = np.sqrt(np.asarray(sample_weight, dtype=np.float64))
            X = X * sw[:, None]
            y = y * sw[:, None]
        if self.fit_intercept:
            Xd = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        else:
            Xd = X
        beta, *_ = np.linalg.lstsq(Xd, y, rcond=None)
        if self.fit_intercept:
            self.coef_ = beta[:-1]
            self.intercept_ = beta[-1]
        else:
            self.coef_ = beta
            self.intercept_ = np.zeros(y.shape[1])
        if squeeze:
            self.coef_ = self.coef_[:, 0]
            self.intercept_ = float(np.ravel(self.intercept_)[0])
        self._squeeze = squeeze
        return self

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        return ordered_affine(X, self.coef_, self.intercept_)

    # ---- flat-array state contract (see mlperf.state) ----
    def to_state(self) -> dict[str, np.ndarray]:
        assert self.coef_ is not None, "not fitted"
        return {
            CLASS_KEY: class_tag(type(self)),
            "coef": np.asarray(self.coef_, dtype=np.float64),
            "intercept": np.asarray(self.intercept_, dtype=np.float64),
        }

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray]):
        obj = cls()
        obj.coef_ = np.asarray(state["coef"], dtype=np.float64)
        intercept = np.asarray(state["intercept"], dtype=np.float64)
        obj.intercept_ = float(intercept[()]) if intercept.ndim == 0 \
            else intercept
        return obj


@register_estimator
class Ridge(LinearRegression):
    def __init__(self, alpha: float = 1.0, fit_intercept: bool = True):
        super().__init__(fit_intercept=fit_intercept)
        self.alpha = alpha

    def fit(self, X, y, sample_weight=None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 1
        if squeeze:
            y = y[:, None]
        if sample_weight is not None:
            sw = np.sqrt(np.asarray(sample_weight, dtype=np.float64))
            X = X * sw[:, None]
            y = y * sw[:, None]
        n, d = X.shape
        if self.fit_intercept:
            xm = X.mean(axis=0)
            ym = y.mean(axis=0)
            Xc, yc = X - xm, y - ym
        else:
            Xc, yc = X, y
        A = Xc.T @ Xc + self.alpha * np.eye(d)
        beta = np.linalg.solve(A, Xc.T @ yc)
        self.coef_ = beta
        self.intercept_ = ym - xm @ beta if self.fit_intercept else np.zeros(y.shape[1])
        if squeeze:
            self.coef_ = self.coef_[:, 0]
            self.intercept_ = float(np.ravel(self.intercept_)[0])
        return self
