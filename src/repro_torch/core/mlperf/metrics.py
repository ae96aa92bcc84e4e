"""Regression metrics used throughout the paper (Table IV)."""

from __future__ import annotations

import numpy as np


def _2d(a):
    a = np.asarray(a, dtype=np.float64)
    return a[:, None] if a.ndim == 1 else a


def r2_score(y_true, y_pred, multioutput: str = "uniform_average"):
    yt, yp = _2d(y_true), _2d(y_pred)
    ss_res = ((yt - yp) ** 2).sum(axis=0)
    ss_tot = ((yt - yt.mean(axis=0)) ** 2).sum(axis=0)
    r2 = 1.0 - ss_res / np.where(ss_tot > 0, ss_tot, 1.0)
    r2 = np.where(ss_tot > 0, r2, 0.0)
    if multioutput == "raw_values":
        return r2
    return float(r2.mean())


def mse(y_true, y_pred, multioutput: str = "uniform_average"):
    yt, yp = _2d(y_true), _2d(y_pred)
    v = ((yt - yp) ** 2).mean(axis=0)
    return v if multioutput == "raw_values" else float(v.mean())


def mae(y_true, y_pred, multioutput: str = "uniform_average"):
    yt, yp = _2d(y_true), _2d(y_pred)
    v = np.abs(yt - yp).mean(axis=0)
    return v if multioutput == "raw_values" else float(v.mean())


def _pct_errors(y_true, y_pred, eps: float = 1e-12):
    yt, yp = _2d(y_true), _2d(y_pred)
    return 100.0 * np.abs(yp - yt) / np.maximum(np.abs(yt), eps)


def median_pct_error(y_true, y_pred, multioutput: str = "uniform_average"):
    v = np.median(_pct_errors(y_true, y_pred), axis=0)
    return v if multioutput == "raw_values" else float(v.mean())


def mean_pct_error(y_true, y_pred, multioutput: str = "uniform_average"):
    v = _pct_errors(y_true, y_pred).mean(axis=0)
    return v if multioutput == "raw_values" else float(v.mean())


def regression_report(y_true, y_pred, target_names: list[str] | None = None) -> dict:
    """Per-target dict of {R2, MSE, MAE, MedPctErr, MeanPctErr} — Table IV."""
    yt, yp = _2d(y_true), _2d(y_pred)
    t = yt.shape[1]
    names = target_names or [f"target_{i}" for i in range(t)]
    rep = {}
    for i, name in enumerate(names):
        rep[name] = {
            "r2": float(r2_score(yt[:, i], yp[:, i])),
            "mse": float(mse(yt[:, i], yp[:, i])),
            "mae": float(mae(yt[:, i], yp[:, i])),
            "median_pct_err": float(median_pct_error(yt[:, i], yp[:, i])),
            "mean_pct_err": float(mean_pct_error(yt[:, i], yp[:, i])),
        }
    return rep


def pearson_corr(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def correlation_matrix(table: dict[str, np.ndarray], rows: list[str],
                       cols: list[str]) -> np.ndarray:
    """Paper Table V / Fig 6: corr between dimension products and metrics."""
    out = np.zeros((len(rows), len(cols)))
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            out[i, j] = pearson_corr(table[r], table[c])
    return out
