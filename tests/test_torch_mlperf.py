"""The port's ML stack against the JAX package's, on the CPU.

The estimators, the predictor and its artifact format are numpy copies, so
on the same seeded table they must fit the same state arrays, and the same
artifact must predict the same bits in both packages. One difference is
deliberate: the reference's tree puts each split's raw-space threshold one
bin too high (see `tree.Binner.threshold_value`), so the port's fitted
trees match the reference's in every array but ``threshold``, and route
every training row in raw space as binned training did. The port's
compiled scorer is torch where the reference's is
jax: in float64 it must equal numpy `predict` bit for bit for every family
(the reference's x64 jit scorer is no oracle here: `enable_x64` is gone
from the installed jax), and in float32 it is held against the JAX f32
scorer within 1e-5 relative (both round the same float64 model to float32
at different points; trees whose thresholds sit within an ulp of a sample
can branch differently, which the residual decode turns into relative
differences well under that bound on these tables).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.core import predictor as jpredictor
from repro.core import profiler as jprofiler
from repro.core.mlperf import (
    GradientBoostedTreesRegressor as JGBDT,
    LinearRegression as JLinear,
    RandomForestRegressor as JForest,
    Ridge as JRidge,
    StackingRegressor as JStacking,
    estimator_from_state as jestimator_from_state,
)
from repro_torch.core import predictor as tpredictor
from repro_torch.core import profiler as tprofiler
from repro_torch.core.mlperf import (
    GradientBoostedTreesRegressor,
    LinearRegression,
    RandomForestRegressor,
    Ridge,
    StackingRegressor,
    compilable_families,
    estimator_from_state,
    registered_estimator_names,
)
from repro_torch.core.mlperf.torchpredict import TorchEstimator

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN_FAMILIES = ("rf", "gbdt", "linreg", "stacking")
FAMILIES = ("forest", "gbdt", "linreg", "ridge", "stacking")
F32_RTOL = 1e-5


def _model(pkg: str, name: str):
    """A small fitted-size model of one family, from either package."""
    F, G, L, R, S = ((JForest, JGBDT, JLinear, JRidge, JStacking)
                     if pkg == "jax" else
                     (RandomForestRegressor, GradientBoostedTreesRegressor,
                      LinearRegression, Ridge, StackingRegressor))
    if name == "forest":
        return F(n_estimators=6, max_depth=5, random_state=0)
    if name == "gbdt":
        return G(n_estimators=8, max_depth=4, random_state=0)
    if name == "linreg":
        return L()
    if name == "ridge":
        return R(alpha=0.5)
    return S([F(n_estimators=4, max_depth=4, random_state=0), L()],
             n_folds=2)


@pytest.fixture(scope="module")
def tables():
    """The same seeded simulator table from both packages, per chip."""
    out = {}
    for chip in ("tpu_v5e", "rtx4070"):
        t = tprofiler.collect_dataset(n_configs=400, seed=3, chip=chip)
        j = jprofiler.collect_dataset(n_configs=400, seed=3, chip=chip)
        out[chip] = (t, j)
    return out


def _xy(table, names):
    """Standardized features and log targets (runtime, power)."""
    X = np.stack([table[k] for k in names], axis=1)
    Xs = (X - X.mean(0)) / np.where(X.std(0) > 0, X.std(0), 1.0)
    Y = np.stack([table[k] for k in ("runtime_ms", "power_w")], axis=1)
    return Xs, np.log(Y)


def test_every_serializable_family_compiles():
    assert set(registered_estimator_names()) <= set(compilable_families())


def _assert_routes_as_binned(threshold, feature, bin_, edges, X) -> None:
    """Each split's raw threshold sends every row of X whose binned code
    is <= its bin (x below edge e[bin]) left and every other row right."""
    for t, f, b in zip(threshold, feature, bin_):
        col = X[:, f]
        left = col < edges[f][b]
        assert (col[left] <= t).all() and (col[~left] > t).all(), (f, b, t)


def _trees(est) -> list:
    """The fitted DecisionTreeRegressors of a forest, a GBDT or a
    stacking ensemble's forest base."""
    if hasattr(est, "fitted_bases_"):
        return [t for b in est.fitted_bases_
                for t in getattr(b, "estimators_", [])]
    return list(getattr(est, "estimators_", []))


@pytest.mark.parametrize("family", FAMILIES)
def test_estimators_fit_the_same_models_as_the_reference(family, tables):
    """The same trees, split for split, with each raw-space threshold
    sending the training rows to the side the reference's binned split
    sent them (checked against the reference's own bin edges); linear
    models equal outright. (A stacking ensemble's meta weights come from its bases'
    out-of-fold raw predictions, so only its bases are compared.)"""
    t, _ = tables["tpu_v5e"]
    X, Y = _xy(t, tpredictor.NUMERIC_FEATURES)
    port = _model("torch", family).fit(X, Y)
    ref = _model("jax", family).fit(X, Y)
    ps, rs = port.to_state(), ref.to_state()
    assert sorted(ps) == sorted(rs)
    for key in ps:
        if not key.endswith("threshold") and not key.startswith("meta_"):
            np.testing.assert_array_equal(ps[key], rs[key], err_msg=key)
    if family in ("linreg", "ridge"):
        np.testing.assert_array_equal(ps["coef"], rs["coef"])
        np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    for pt, rt in zip(_trees(port), _trees(ref)):
        split = rt.tree_.feature >= 0
        _assert_routes_as_binned(
            pt.tree_.threshold[split], rt.tree_.feature[split],
            rt.tree_.threshold_bin[split], rt.binner_.bin_edges_, X)
    assert len(_trees(port)) == len(_trees(ref))
    # a state from either package rebuilds in the other, predicting alike
    np.testing.assert_array_equal(estimator_from_state(rs).predict(X),
                                  ref.predict(X))
    np.testing.assert_array_equal(jestimator_from_state(ps).predict(X),
                                  port.predict(X))


def _h100_like_table() -> dict:
    """A seeded 2,600-config draw of the H100 sweep, profiled through the
    h100 simulator: the card's feature columns at their sweep values."""
    cfgs = tprofiler.h100_sweep_configs()
    pick = np.random.default_rng(0).choice(len(cfgs), 2600, replace=False)
    return tprofiler.profile_configs([cfgs[i] for i in sorted(pick)],
                                     chip="h100")


def _routing_table(kind: str, tables) -> tuple:
    """Features of one kind with a target: values on the bin edges (a
    binary flag, a three-valued tile edge, a small integer, as the GEMM
    features are), the continuous standardized simulator table of `_xy`,
    or the standardized features of an H100-sweep-like table."""
    if kind == "discrete":
        rng = np.random.default_rng(0)
        X = np.stack([rng.integers(0, 2, 600), rng.choice([8, 64, 128], 600),
                      rng.integers(0, 20, 600)], axis=1).astype(np.float64)
        return X, 3.0 * X[:, 0] + np.log(X[:, 1]) + 0.1 * X[:, 2]
    if kind == "continuous":
        return _xy(tables["tpu_v5e"][0], tpredictor.NUMERIC_FEATURES)
    h = _h100_like_table()
    pred = tpredictor.PerfPredictor(model="rf", chip="h100")
    return pred.scaler.fit_transform(pred._X(h)), np.log(h["runtime_ms"])


@pytest.mark.parametrize("kind", ("discrete", "continuous", "h100-like"))
def test_raw_thresholds_route_training_rows_as_binned_training_did(kind,
                                                                   tables):
    """Every training row takes the same leaf in raw space as in binned
    space, whether the features sit on the bin edges or between them, so
    the forest predicts what it learned."""
    X, y = _routing_table(kind, tables)
    for est in (RandomForestRegressor(n_estimators=5, max_depth=6,
                                      random_state=0),
                GradientBoostedTreesRegressor(n_estimators=5, max_depth=4,
                                              random_state=0)):
        est.fit(X, y)
        for tree in est.estimators_:
            np.testing.assert_array_equal(
                tree.tree_.predict_raw(X),
                tree.tree_.predict_binned(tree.binner_.transform(X)))
    if kind == "discrete":
        forest = RandomForestRegressor(n_estimators=20, max_depth=6,
                                       random_state=0).fit(X, y)
        assert np.corrcoef(forest.predict(X), y)[0, 1] > 0.99


@pytest.mark.parametrize("family", FAMILIES)
def test_float64_torch_estimator_is_bit_identical_to_numpy(family, tables):
    t, _ = tables["rtx4070"]
    Xs, Y = _xy(t, tpredictor.NUMERIC_FEATURES)
    est = _model("torch", family).fit(Xs, Y)
    want = np.asarray(est.predict(Xs)).reshape(len(Xs), -1)
    got = TorchEstimator(est, x64=True, device="cpu").predict(Xs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", GOLDEN_FAMILIES)
@pytest.mark.parametrize("chip", ("tpu_v5e", "rtx4070"))
def test_float64_torch_scorer_is_bit_identical_to_predict(model, chip,
                                                          tables):
    """The decoded predictor (descaling, exp, residual anchors) as the
    tuner scores it, for every Table VI family on both reference chips."""
    t, _ = tables[chip]
    pred = tpredictor.PerfPredictor(model=model, residual=True, fast=True,
                                    chip=chip)
    pred.model = _model("torch", {"rf": "forest"}.get(model, model))
    pred.fit(t)
    X = np.stack([t[k] for k in pred.feature_names], axis=1)
    got = pred.torch_predictor(device="cpu", x64=True)(X)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), pred.predict_matrix(t))
    assert pred.torch_predictor(device="cpu", x64=True) is \
        pred.torch_predictor(device="cpu", x64=True)


@pytest.mark.parametrize("model", GOLDEN_FAMILIES)
def test_float32_torch_scorer_matches_the_jax_f32_scorer(model, tables,
                                                          tmp_path):
    t, _ = tables["tpu_v5e"]
    port = tpredictor.PerfPredictor(model=model, residual=True, fast=True,
                                    chip="tpu_v5e")
    port.model = _model("torch", {"rf": "forest"}.get(model, model))
    port.fit(t)
    path = str(tmp_path / "pred.npz")
    port.save(path)
    ref = jpredictor.PerfPredictor.load(path)
    X = np.stack([t[k] for k in port.feature_names], axis=1)
    got = port.torch_predictor(device="cpu")(X)
    assert got.dtype == torch.float32
    want = np.asarray(ref.jax_predictor()(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)


@pytest.mark.parametrize("family", GOLDEN_FAMILIES)
def test_golden_artifacts_predict_exactly_golden_expected(family):
    with np.load(os.path.join(FIXTURES, "golden_expected.npz"),
                 allow_pickle=False) as z:
        expected = {k: z[k] for k in z.files}
    pred = tpredictor.PerfPredictor.load(
        os.path.join(FIXTURES, f"golden_{family}.npz"))
    assert pred.model_name == family
    assert list(expected["feature_names"]) == pred.feature_names
    X = expected["X"]
    table = {name: X[:, i] for i, name in enumerate(pred.feature_names)}
    want = expected[f"{family}/predict"]
    np.testing.assert_array_equal(pred.predict_matrix(table), want)
    np.testing.assert_array_equal(
        pred.torch_predictor(device="cpu", x64=True)(X).numpy(), want)


def test_golden_ridge_state_predicts_exactly():
    with np.load(os.path.join(FIXTURES, "golden_expected.npz"),
                 allow_pickle=False) as z:
        X, want = z["ridge/X"], z["ridge/predict"]
    with np.load(os.path.join(FIXTURES, "golden_ridge_state.npz"),
                 allow_pickle=False) as z:
        ridge = estimator_from_state({k: z[k] for k in z.files})
    assert isinstance(ridge, Ridge)
    np.testing.assert_array_equal(ridge.predict(X), want)
    np.testing.assert_array_equal(
        TorchEstimator(ridge, x64=True, device="cpu").predict(X),
        np.asarray(want).reshape(len(X), -1))


@pytest.mark.parametrize("direction", ("jax->port", "port->jax"))
def test_artifacts_cross_load_with_the_same_fingerprint(direction, tables,
                                                        tmp_path):
    t, j = tables["rtx4070"]
    src_mod, dst_mod = ((jpredictor, tpredictor) if direction == "jax->port"
                        else (tpredictor, jpredictor))
    src = src_mod.PerfPredictor(model="rf", residual=True, fast=True,
                                chip="rtx4070")
    src.fit(j if src_mod is jpredictor else t)
    path = str(tmp_path / "pred.npz")
    src.save(path)
    dst = dst_mod.PerfPredictor.load(path)
    assert dst.fingerprint() == src.fingerprint()
    assert tpredictor.ARTIFACT_FORMAT == jpredictor.ARTIFACT_FORMAT
    assert (tpredictor.ARTIFACT_SCHEMA_VERSION
            == jpredictor.ARTIFACT_SCHEMA_VERSION)
    np.testing.assert_array_equal(dst.predict_matrix(t),
                                  src.predict_matrix(t))


def test_corrupt_artifact_is_refused(tables, tmp_path):
    t, _ = tables["tpu_v5e"]
    pred = tpredictor.PerfPredictor(model="linreg", chip="tpu_v5e").fit(t)
    path = str(tmp_path / "pred.npz")
    pred.save(path)
    with np.load(path, allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    state["model/coef"] = state["model/coef"] + 1.0
    np.savez(path, **state)
    with pytest.raises(tpredictor.ArtifactError, match="fingerprint"):
        tpredictor.PerfPredictor.load(path)


def test_scorer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    est = LinearRegression().fit(np.eye(3), np.arange(3.0))
    with pytest.raises(RuntimeError, match="GPU"):
        TorchEstimator(est)
