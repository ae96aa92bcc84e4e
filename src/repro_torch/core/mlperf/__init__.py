"""From-scratch ML stack (no sklearn in this environment).

Implements the paper's modelling pipeline:
  StandardScaler -> MultiOutput(RandomForestRegressor(n_estimators=100, max_depth=6))
plus the comparison models from Table VI (linear regression, gradient-boosted
trees standing in for XGBoost, and a stacking ensemble).

All estimators follow a minimal fit/predict protocol and operate on float64
numpy arrays. Trees are histogram-based (quantile binning) so training the
paper-scale dataset (~16k rows) takes seconds on one CPU core. Fitted models
can be exported to flat tensors for prediction on a device (see
`compiled.py` and `torchpredict.py`), which the autotuner uses.

The port's copy of the JAX package's `repro.core.mlperf`: fitting and numpy
prediction are the same code; only the compiled scorer is torch.
"""

from repro_torch.core.mlperf.state import (
    estimator_from_state,
    pack_nested,
    register_estimator,
    registered_estimator_names,
    unpack_nested,
)
from repro_torch.core.mlperf.compiled import (
    compilable_families,
    lower_estimator,
    supports_compile,
)
from repro_torch.core.mlperf.tree import DecisionTreeRegressor, Binner
from repro_torch.core.mlperf.forest import RandomForestRegressor
from repro_torch.core.mlperf.gbdt import GradientBoostedTreesRegressor
from repro_torch.core.mlperf.linreg import LinearRegression, Ridge
from repro_torch.core.mlperf.stacking import StackingRegressor
from repro_torch.core.mlperf.pipeline import (
    StandardScaler,
    TabularPreprocessor,
    Pipeline,
    train_test_split,
)
from repro_torch.core.mlperf.metrics import (
    r2_score,
    mse,
    mae,
    median_pct_error,
    mean_pct_error,
    regression_report,
)

__all__ = [
    "estimator_from_state",
    "pack_nested",
    "register_estimator",
    "registered_estimator_names",
    "unpack_nested",
    "compilable_families",
    "lower_estimator",
    "supports_compile",
    "DecisionTreeRegressor",
    "Binner",
    "RandomForestRegressor",
    "GradientBoostedTreesRegressor",
    "LinearRegression",
    "Ridge",
    "StackingRegressor",
    "StandardScaler",
    "TabularPreprocessor",
    "Pipeline",
    "train_test_split",
    "r2_score",
    "mse",
    "mae",
    "median_pct_error",
    "mean_pct_error",
    "regression_report",
]
