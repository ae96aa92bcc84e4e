"""Preprocessing pipeline mirroring the paper's Algorithms 1 & 2.

- `TabularPreprocessor`: sanitize numerics, percentile clipping (0.01/0.99),
  median imputation, categorical -> one-hot; computes the derived GEMM
  characteristics (total_flops, bytes_accessed, arithmetic_intensity) when
  the raw m/n/k columns are present.
- `StandardScaler` + `Pipeline`: the paper's
  Pipeline([('preprocessor', ...), ('regressor', ...)]).
- `train_test_split`: 80/20 with random-state control.
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    def __init__(self):
        self.mean_: np.ndarray | None = None
        self.scale_: np.ndarray | None = None

    def fit(self, X):
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std > 0, std, 1.0)
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        return (X - self.mean_) / self.scale_

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        return np.asarray(X) * self.scale_ + self.mean_

    # ---- flat-array state contract (see mlperf.state) ----
    def to_state(self) -> dict[str, np.ndarray]:
        assert self.mean_ is not None, "not fitted"
        return {"mean": np.asarray(self.mean_, dtype=np.float64),
                "scale": np.asarray(self.scale_, dtype=np.float64)}

    @classmethod
    def from_state(cls, state) -> "StandardScaler":
        obj = cls()
        obj.mean_ = np.asarray(state["mean"], dtype=np.float64)
        obj.scale_ = np.asarray(state["scale"], dtype=np.float64)
        return obj


class TabularPreprocessor:
    """Dict-of-columns table -> (feature_matrix, feature_names).

    Numerical columns: clip to [q_lo, q_hi] percentiles (fit-time), impute
    missing with the fit-time median. Categorical (string) columns: one-hot
    with an explicit vocabulary learned at fit time (unknowns -> all-zero).
    """

    def __init__(self, clip_quantiles: tuple[float, float] = (0.01, 0.99)):
        self.clip_quantiles = clip_quantiles
        self.numeric_cols_: list[str] = []
        self.categorical_cols_: list[str] = []
        self.clip_lo_: dict[str, float] = {}
        self.clip_hi_: dict[str, float] = {}
        self.median_: dict[str, float] = {}
        self.vocab_: dict[str, list] = {}
        self.feature_names_: list[str] = []

    @staticmethod
    def _is_numeric(col: np.ndarray) -> bool:
        return np.issubdtype(np.asarray(col).dtype, np.number) or np.issubdtype(
            np.asarray(col).dtype, np.bool_
        )

    def fit(self, table: dict[str, np.ndarray]):
        self.numeric_cols_, self.categorical_cols_ = [], []
        for name, col in table.items():
            col = np.asarray(col)
            if self._is_numeric(col):
                self.numeric_cols_.append(name)
                v = col.astype(np.float64)
                finite = v[np.isfinite(v)]
                if finite.size == 0:
                    lo = hi = med = 0.0
                else:
                    lo = float(np.quantile(finite, self.clip_quantiles[0]))
                    hi = float(np.quantile(finite, self.clip_quantiles[1]))
                    med = float(np.median(finite))
                self.clip_lo_[name], self.clip_hi_[name] = lo, hi
                self.median_[name] = med
            else:
                self.categorical_cols_.append(name)
                self.vocab_[name] = sorted({str(x) for x in col})
        self.feature_names_ = list(self.numeric_cols_) + [
            f"{c}={v}" for c in self.categorical_cols_ for v in self.vocab_[c]
        ]
        return self

    def transform(self, table: dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(table.values())))
        cols = []
        for name in self.numeric_cols_:
            v = np.asarray(table[name], dtype=np.float64).copy()
            v = np.where(np.isfinite(v), v, self.median_[name])
            v = np.clip(v, self.clip_lo_[name], self.clip_hi_[name])
            cols.append(v)
        for name in self.categorical_cols_:
            raw = [str(x) for x in table[name]]
            for v in self.vocab_[name]:
                cols.append(np.array([1.0 if x == v else 0.0 for x in raw]))
        return np.stack(cols, axis=1) if cols else np.zeros((n, 0))

    def fit_transform(self, table):
        return self.fit(table).transform(table)


def compute_gemm_characteristics(table: dict[str, np.ndarray],
                                 bytes_per_elem: float = 4.0) -> dict[str, np.ndarray]:
    """Paper Algorithm 1, COMPUTEGEMMCHARS: derived features from m/n/k."""
    m = np.asarray(table["m"], dtype=np.float64)
    n = np.asarray(table["n"], dtype=np.float64)
    k = np.asarray(table["k"], dtype=np.float64)
    out = dict(table)
    out["total_flops"] = 2.0 * m * n * k
    out["bytes_accessed"] = bytes_per_elem * (m * k + k * n + m * n)
    out["arithmetic_intensity"] = out["total_flops"] / np.maximum(out["bytes_accessed"], 1.0)
    return out


class Pipeline:
    """('preprocessor' -> 'scaler' -> 'regressor'), the paper's Algorithm 2."""

    def __init__(self, preprocessor: TabularPreprocessor, regressor,
                 scaler: StandardScaler | None = None):
        self.preprocessor = preprocessor
        self.scaler = scaler or StandardScaler()
        self.regressor = regressor

    def fit(self, table: dict[str, np.ndarray], y: np.ndarray):
        X = self.preprocessor.fit_transform(table)
        Xs = self.scaler.fit_transform(X)
        self.regressor.fit(Xs, y)
        return self

    def predict(self, table: dict[str, np.ndarray]) -> np.ndarray:
        X = self.preprocessor.transform(table)
        return self.regressor.predict(self.scaler.transform(X))


def train_test_split(*arrays, test_size: float = 0.2, random_state: int | None = 0):
    first = arrays[0]
    n = len(next(iter(first.values()))) if isinstance(first, dict) else len(first)
    rng = np.random.default_rng(random_state)
    perm = rng.permutation(n)
    n_test = int(round(n * test_size))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    out = []
    for a in arrays:
        if isinstance(a, dict):
            out.append({k: np.asarray(v)[train_idx] for k, v in a.items()})
            out.append({k: np.asarray(v)[test_idx] for k, v in a.items()})
        else:
            a = np.asarray(a)
            out.append(a[train_idx])
            out.append(a[test_idx])
    return out
