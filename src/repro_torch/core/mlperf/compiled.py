"""Lowering registry: any fitted estimator -> one torch scorer on a device.

The port's counterpart of the JAX package's `repro.core.mlperf.compiled`.
Every estimator family in the mlperf zoo registers a *lowering* here — a
function that exports the fitted model to flat tensors on a device (the
same global-id layout the state contract uses) plus a pure torch
`apply(params, X)` that reproduces the numpy `predict`:

  * tree / forest / GBDT — one stacked level-synchronous descent over the
    concatenated ensemble (leaves self-loop, `max_depth` gather steps),
    combined per family: mean over trees (forest), ``base + sum`` of
    learning-rate-scaled leaves (GBDT).
  * linreg / ridge — a single affine map, accumulated feature by feature
    in declared order, mirroring `linreg.ordered_affine`: a matmul does
    not fix its summation order, and the float64 contract below is
    *bit*-exactness.
  * stacking — every base model's descent, then the meta-ridge combine as
    one fixed-order affine over the stacked predictions.

Two precisions:

  * ``float64=False`` — float32 tensors; thresholds are nudged one fp32
    ulp (see `tree.cast_flat_ensemble`) so fp64-trained splits survive
    rounding.
  * ``float64=True`` — tensors stay float64, and every gather, comparison
    and accumulation happens in the same order as the numpy reference, so
    the scorer is bit-identical to `est.predict`, on the CPU and on the
    card. Eager torch runs each operation as its own kernel, so a product
    is never contracted with the add that follows it into an FMA; the
    tree-axis sum is a loop of in-order adds (`tensor.sum` reduces in an
    order of its own); and a divisor is a tensor on the device, never a
    Python number, because CUDA divides by a host scalar through its
    reciprocal.

`lower_estimator` dispatches on the estimator class through the registry;
`TorchEstimator` (torchpredict.py) wraps the result in a ready-to-call
object.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Lowered(NamedTuple):
    """Flat tensor params + a pure `apply(params, X) -> (N, K)` torch fn."""

    params: dict
    apply: Callable
    n_targets: int


_LOWERINGS: dict[str, Callable] = {}


def register_lowering(cls_name: str):
    """Decorator: register `fn(est, float64, device) -> Lowered` for a
    class name."""

    def deco(fn):
        _LOWERINGS[cls_name] = fn
        return fn

    return deco


def compilable_families() -> list[str]:
    """Estimator class names that can serve through the torch scorer."""
    return sorted(_LOWERINGS)


def supports_compile(est) -> bool:
    return type(est).__name__ in _LOWERINGS


def lower_estimator(est, *, float64: bool = False,
                    device: str | torch.device = "cuda") -> Lowered:
    """Export any registered fitted estimator for torch prediction on
    `device` (the card unless the caller asks for the CPU)."""
    name = type(est).__name__
    try:
        fn = _LOWERINGS[name]
    except KeyError:
        raise TypeError(
            f"no compiled lowering for estimator {name!r}; "
            f"known: {compilable_families()}"
        ) from None
    return fn(est, float64, resolve_device(device))


def _tensors(arrays: dict[str, np.ndarray], device: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# shared torch building blocks
# ---------------------------------------------------------------------------


def _descend(p: dict, X: torch.Tensor, *, max_depth: int, n_trees: int
             ) -> torch.Tensor:
    """Stacked flat-array descent: leaf values for every (tree, sample)
    pair, shape (T, N, K). All cursors advance together, one int64 gather
    per node array per level; leaves self-loop so a fixed `max_depth` step
    count lands every cursor on its leaf (mirror of
    `tree.predict_stacked`)."""
    N, F = X.shape
    Xr = X.reshape(-1)
    node = p["roots"].repeat_interleave(N)               # (T*N,)
    row = (torch.arange(N, dtype=torch.int64, device=X.device) * F
           ).repeat(n_trees)
    feature, threshold = p["feature"], p["threshold"]
    left, right = p["left"], p["right"]
    for _ in range(max_depth):
        x = Xr[row + feature[node]]
        node = torch.where(x <= threshold[node], left[node], right[node])
    return p["value"][node].reshape(n_trees, N, -1)      # (T, N, K)


def _sum_trees(leaves: torch.Tensor) -> torch.Tensor:
    """Sum over the tree axis in tree order, one add at a time: numpy's
    `leaves.sum(axis=0)` accumulates slice by slice in order, and a torch
    reduction does not promise that order."""
    acc = leaves[0]
    for i in range(1, leaves.shape[0]):
        acc = acc + leaves[i]
    return acc


def _ordered_affine(X: torch.Tensor, coef: torch.Tensor,
                    intercept: torch.Tensor) -> torch.Tensor:
    """X @ coef + intercept — the torch mirror of `linreg.ordered_affine`:
    per-feature products added in declared order, then the intercept.
    coef: (F, K); intercept: (K,)."""
    acc = torch.zeros((X.shape[0], coef.shape[1]), dtype=X.dtype,
                      device=X.device)
    for f in range(coef.shape[0]):
        acc = acc + X[:, f, None] * coef[None, f, :]
    return acc + intercept[None, :]


# ---------------------------------------------------------------------------
# per-family lowerings
# ---------------------------------------------------------------------------


def _tree_params(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {k: flat[k] for k in
            ("feature", "threshold", "left", "right", "value", "roots")}


@register_lowering("RandomForestRegressor")
def _lower_forest(est, float64: bool, device: torch.device) -> Lowered:
    flat = est.to_flat_arrays(float64=float64)
    max_depth = int(flat["max_depth"])
    n_trees = len(flat["roots"])
    params = _tree_params(flat)
    # the divisor as a tensor on the device (see the module docstring)
    params["count"] = np.asarray(float(n_trees), dtype=flat["value"].dtype)

    def apply(p, X):
        leaves = _descend(p, X, max_depth=max_depth, n_trees=n_trees)
        return _sum_trees(leaves) / p["count"]

    return Lowered(_tensors(params, device), apply, int(est.n_targets_))


@register_lowering("GradientBoostedTreesRegressor")
def _lower_gbdt(est, float64: bool, device: torch.device) -> Lowered:
    flat = est.to_flat_arrays(float64=float64)
    max_depth = int(flat["max_depth"])
    n_trees = len(flat["roots"])
    # Pre-scale leaf values by the learning rate HERE, in numpy: the numpy
    # `predict` multiplies leaves elementwise by lr before summing, so
    # gathering pre-scaled values gives bit-identical addends and keeps
    # the combine add-only.
    value = flat["value"]
    params = {**_tree_params(flat),
              "value": value.dtype.type(est.learning_rate) * value,
              "base": flat["base"]}

    def apply(p, X):
        base = p["base"][None, :].expand(X.shape[0], -1)
        if n_trees == 0:
            return base
        leaves = _descend(p, X, max_depth=max_depth, n_trees=n_trees)
        return base + _sum_trees(leaves)

    return Lowered(_tensors(params, device), apply, int(est.n_targets_))


@register_lowering("DecisionTreeRegressor")
def _lower_tree(est, float64: bool, device: torch.device) -> Lowered:
    from repro_torch.core.mlperf.tree import (cast_flat_ensemble,
                                              flatten_ensemble)

    flat = cast_flat_ensemble(flatten_ensemble([est.tree_]), float64=float64)
    max_depth = int(est.max_depth)

    def apply(p, X):
        return _descend(p, X, max_depth=max_depth, n_trees=1)[0]

    return Lowered(_tensors(_tree_params(flat), device), apply,
                   int(est.n_targets_))


def _affine_params(coef, intercept, float64: bool) -> dict[str, np.ndarray]:
    coef = np.asarray(coef, dtype=np.float64)
    if coef.ndim == 1:
        coef = coef[:, None]
    intercept = np.atleast_1d(np.asarray(intercept, dtype=np.float64))
    intercept = np.broadcast_to(intercept, (coef.shape[1],)).copy()
    if not float64:
        coef = coef.astype(np.float32)
        intercept = intercept.astype(np.float32)
    return {"coef": coef, "intercept": intercept}


@register_lowering("LinearRegression")
def _lower_linear(est, float64: bool, device: torch.device) -> Lowered:
    params = _affine_params(est.coef_, est.intercept_, float64)

    def apply(p, X):
        return _ordered_affine(X, p["coef"], p["intercept"])

    return Lowered(_tensors(params, device), apply, params["coef"].shape[1])


# Ridge shares LinearRegression's prediction surface exactly.
register_lowering("Ridge")(_lower_linear)


@register_lowering("StackingRegressor")
def _lower_stacking(est, float64: bool, device: torch.device) -> Lowered:
    lowered = [_LOWERINGS[type(b).__name__](b, float64, device)
               for b in est.fitted_bases_]
    base_applies = [low.apply for low in lowered]
    # meta ridges are per-target with 1-d coefs over Z; stack to (Z, T) so
    # one ordered affine over Z-columns reproduces every per-target dot.
    meta = _affine_params(
        np.stack([np.asarray(m.coef_, dtype=np.float64) for m in est.meta_],
                 axis=1),
        np.array([float(np.ravel(m.intercept_)[0]) for m in est.meta_]),
        float64)
    params = {"bases": [low.params for low in lowered],
              **_tensors(meta, device)}
    passthrough = bool(est.passthrough)

    def apply(p, X):
        preds = [ap(bp, X).reshape(X.shape[0], -1)
                 for ap, bp in zip(base_applies, p["bases"])]
        Z = torch.cat(preds + ([X] if passthrough else []), dim=1)
        return _ordered_affine(Z, p["coef"], p["intercept"])

    return Lowered(params, apply, int(est.n_targets_))
