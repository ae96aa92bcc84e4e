"""Torch inference for the whole mlperf zoo, on a device.

The port's counterpart of the JAX package's `jaxpredict.py`. The numpy
originals predict on the host; `TorchEstimator` wraps any fitted estimator
that has a registered lowering (see `compiled.py`): the model is exported
to flat tensors on a device (tree ensembles in the global-id layout,
linear models as coefficient matrices, stacking as the composition of its
bases) and evaluated there. The performance predictor can so score a whole
candidate grid on the card, where the autotuner builds it
(`GemmAutotuner.rank_in_graph`).

Two precisions:

  * default (float32) — tree thresholds are nudged one ulp so most
    fp64-trained splits survive fp32 rounding, but near-threshold samples
    can still flip branches.
  * ``x64=True`` — tensors stay float64 and every accumulation runs in the
    numpy reference's order, so predictions are bit-identical to
    `est.predict`. This is what the autotuner's scorer uses.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mlperf.compiled import lower_estimator
from repro_torch.device import resolve_device


class TorchEstimator:
    """Wraps any lowered mlperf estimator for inference on `device` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, est, *, x64: bool = False,
                 device: str | torch.device = "cuda"):
        self.x64 = x64
        self.device = resolve_device(device)
        lowered = lower_estimator(est, float64=x64, device=self.device)
        self.params = lowered.params
        self._apply = lowered.apply
        self.n_targets = int(lowered.n_targets)

    def __call__(self, X) -> torch.Tensor:
        X = torch.as_tensor(
            X, dtype=torch.float64 if self.x64 else torch.float32,
            device=self.device)
        if X.ndim == 1:
            X = X[None]
        return self._apply(self.params, X)

    def predict(self, X) -> np.ndarray:
        return self(X).cpu().numpy()
