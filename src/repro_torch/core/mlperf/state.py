"""Pickle-free estimator serialization: the flat-array state contract.

Every estimator in the mlperf zoo implements

    est.to_state()            -> dict[str, np.ndarray]
    Cls.from_state(state)     -> predict-ready estimator

where the state dict contains ONLY numpy arrays (scalars as 0-d arrays,
class tags as 0-d unicode arrays). That makes any fitted model a plain
bag of arrays that round-trips through ``np.savez`` with
``allow_pickle=False`` — no code execution on load, no version-brittle
byte blobs, and the same arrays double as the content fingerprint for
artifact versioning (see ``repro.core.predictor``).

Nested estimators (stacking bases) are namespaced with '/'-separated key
prefixes via `pack_nested`/`unpack_nested`. `estimator_from_state`
dispatches on the reserved ``__class__`` key through a registry that the
estimator modules populate at import time.

States restore the *prediction* surface (plus feature importances for
trees); refitting a restored estimator starts from scratch like a fresh
instance, it does not resume.
"""

from __future__ import annotations

import numpy as np

CLASS_KEY = "__class__"

_REGISTRY: dict[str, type] = {}


def register_estimator(cls: type) -> type:
    """Class decorator: make `cls` reachable from `estimator_from_state`."""
    _REGISTRY[cls.__name__] = cls
    return cls


def registered_estimator_names() -> list[str]:
    """Class names reachable from `estimator_from_state` (the serialization
    registry; `compiled.compilable_families` is the lowering analogue —
    the parity suite asserts every serializable family also compiles)."""
    return sorted(_REGISTRY)


def class_tag(cls: type) -> np.ndarray:
    return np.array(cls.__name__)


def scalar(x) -> np.ndarray:
    """Store a python scalar as a 0-d numpy array."""
    return np.asarray(x)


def pack_nested(prefix: str, state: dict[str, np.ndarray]
                ) -> dict[str, np.ndarray]:
    """Namespace a child state under `prefix/`."""
    return {f"{prefix}/{k}": v for k, v in state.items()}


def unpack_nested(state: dict[str, np.ndarray], prefix: str
                  ) -> dict[str, np.ndarray]:
    """Extract the child state stored under `prefix/`."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in state.items() if k.startswith(p)}


def estimator_from_state(state: dict[str, np.ndarray]):
    """Rebuild any registered estimator from its flat-array state."""
    if CLASS_KEY not in state:
        raise ValueError("estimator state missing __class__ tag")
    name = str(state[CLASS_KEY][()])
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown estimator class {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return cls.from_state(state)
