"""Histogram-based CART regression tree (multi-output).

Split finding follows the classic variance-reduction criterion, evaluated on
quantile-binned features (up to 255 bins). Binning turns per-node split search
into a handful of `np.bincount` calls, which keeps a 100-tree forest on ~16k
rows in the seconds range on a single CPU core.

Trees are stored as flat arrays (struct-of-arrays), which makes them cheap to
serialize and lets `compiled.py` run the whole forest on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mlperf.state import (
    CLASS_KEY,
    class_tag,
    register_estimator,
    scalar,
)

_MAX_BINS = 255  # bin index 255 reserved for "missing"


class Binner:
    """Quantile binner mapping float features to uint8 bin codes."""

    def __init__(self, max_bins: int = _MAX_BINS):
        if not 2 <= max_bins <= _MAX_BINS:
            raise ValueError(f"max_bins must be in [2, {_MAX_BINS}]")
        self.max_bins = max_bins
        self.bin_edges_: list[np.ndarray] | None = None
        # per feature, per edge e[b]: the largest fitted value below e[b]
        self.below_edges_: list[np.ndarray] | None = None

    def fit(self, X: np.ndarray) -> "Binner":
        X = np.asarray(X, dtype=np.float64)
        edges, below = [], []
        qs = np.linspace(0, 1, self.max_bins + 1)[1:-1]
        for j in range(X.shape[1]):
            col = X[:, j]
            col = col[np.isfinite(col)]
            if col.size == 0:
                edges.append(np.array([0.0]))
                below.append(np.array([-np.inf]))
                continue
            e = np.unique(np.quantile(col, qs))
            if e.size == 0:  # constant column
                e = np.array([col[0]])
            edges.append(e)
            vals = np.unique(col)
            i = np.searchsorted(vals, e, side="left") - 1
            below.append(np.where(i >= 0, vals[np.maximum(i, 0)], -np.inf))
        self.bin_edges_ = edges
        self.below_edges_ = below
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        assert self.bin_edges_ is not None, "Binner not fitted"
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(X.shape, dtype=np.uint8)
        for j, e in enumerate(self.bin_edges_):
            code = np.searchsorted(e, X[:, j], side="right").astype(np.uint8)
            code = np.where(np.isfinite(X[:, j]), code, np.uint8(_MAX_BINS))
            out[:, j] = code
        return out

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)

    def n_bins(self, j: int) -> int:
        assert self.bin_edges_ is not None
        return len(self.bin_edges_[j]) + 1

    def threshold_value(self, j: int, bin_code: int) -> float:
        """Raw-space threshold for 'go left if x <= t'.

        A split at `bin_code` b sends codes <= b left, and `transform`
        gives x a code above b once x reaches edge e[b]: the left side is
        x < e[b]. The threshold is the midpoint of e[b] and the largest
        fitted value below it, so every fitted row takes the side in raw
        space that it took in binned training (edges interpolated by
        `np.quantile` included), with room on both sides for the fp32
        rounding of the compiled prediction path. Where the two are
        adjacent doubles and the midpoint rounds onto e[b], the threshold
        is that largest value itself.

        This is the port's one deliberate difference from the JAX
        package's copy, whose threshold is the midpoint of e[b] and
        e[b+1]: there a value in [e[b], midpoint], trained on the right,
        predicts on the left, so a feature with few distinct values (a
        layout flag, the dtype, a tile edge) routes a whole class to the
        wrong side — and a binary one sends every row left.
        """
        assert self.bin_edges_ is not None and self.below_edges_ is not None
        e = self.bin_edges_[j]
        b = min(int(bin_code), len(e) - 1)
        hi, lo = float(e[b]), float(self.below_edges_[j][b])
        if lo == -np.inf:  # nothing fitted goes left
            return float(np.nextafter(hi, -np.inf))
        t = 0.5 * (lo + hi)
        return t if lo <= t < hi else lo


@dataclasses.dataclass
class _FlatTree:
    """Struct-of-arrays tree. Internal node i tests
    `x[:, feature[i]] <= threshold[i]` (raw feature space); children are
    `left[i]` / `right[i]`. Leaves have feature == -1 and carry `value[i]`
    (n_targets,). `threshold_bin` retains the binned threshold for exactness.
    """

    feature: np.ndarray       # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray     # (n_nodes,) float64, raw-space
    threshold_bin: np.ndarray # (n_nodes,) int32, binned-space
    left: np.ndarray          # (n_nodes,) int32
    right: np.ndarray         # (n_nodes,) int32
    value: np.ndarray         # (n_nodes, n_targets) float64
    n_samples: np.ndarray     # (n_nodes,) int32
    gain: np.ndarray          # (n_nodes,) float64 (split gain, 0 for leaves)

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    def predict_binned(self, Xb: np.ndarray) -> np.ndarray:
        """Predict from uint8 binned features (vectorized level descent)."""
        n = Xb.shape[0]
        node = np.zeros(n, dtype=np.int32)
        active = self.feature[node] >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            f = self.feature[nd]
            go_left = Xb[idx, f] <= self.threshold_bin[nd]
            node[idx] = np.where(go_left, self.left[nd], self.right[nd])
            active = self.feature[node] >= 0
        return self.value[node]

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """Predict from raw float features."""
        n = X.shape[0]
        node = np.zeros(n, dtype=np.int32)
        active = self.feature[node] >= 0
        while active.any():
            idx = np.nonzero(active)[0]
            nd = node[idx]
            f = self.feature[nd]
            go_left = X[idx, f] <= self.threshold[nd]
            node[idx] = np.where(go_left, self.left[nd], self.right[nd])
            active = self.feature[node] >= 0
        return self.value[node]


def flatten_ensemble(trees: list[_FlatTree]) -> dict[str, np.ndarray]:
    """Global-id flat layout for batched descent over a whole ensemble.

    Node arrays of every tree are concatenated and children rebased to
    global node ids; leaves self-loop (left == right == own id), so the
    descent is a pure fixed-point iteration with 1-d gathers only — no
    per-tree padding, no 2-d advanced indexing.
    """
    offsets = np.cumsum([0] + [t.n_nodes for t in trees[:-1]]).astype(np.int64)
    feature = np.concatenate([t.feature for t in trees])
    threshold = np.concatenate([t.threshold for t in trees])
    left = np.concatenate([t.left + o for t, o in zip(trees, offsets)])
    right = np.concatenate([t.right + o for t, o in zip(trees, offsets)])
    node_ids = np.arange(len(feature), dtype=np.int64)
    is_leaf = feature < 0
    left = np.where(is_leaf, node_ids, left)
    right = np.where(is_leaf, node_ids, right)
    return {
        "feature": np.maximum(feature, 0).astype(np.int64),
        "threshold": threshold.astype(np.float64),
        "left": left.astype(np.int64),
        "right": right.astype(np.int64),
        "value": np.concatenate([t.value for t in trees], axis=0),
        "roots": offsets,
    }


def predict_stacked(flat: dict[str, np.ndarray], X: np.ndarray,
                    max_depth: int | None = None) -> np.ndarray:
    """Leaf values for every (tree, sample) pair at once: (T, N, K).

    One level-synchronous descent over the whole ensemble — a (T*N,)
    cursor vector advanced together — instead of a Python loop over
    trees. Reaches the identical leaves as `_FlatTree.predict_raw`.
    With `max_depth` the loop runs a fixed step count (leaves self-loop,
    so overshooting is a no-op); otherwise it iterates to convergence.
    """
    X = np.ascontiguousarray(X, dtype=np.float64)
    N, F = X.shape
    Xr = X.ravel()
    roots = flat["roots"]
    T = len(roots)
    feature, threshold = flat["feature"], flat["threshold"]
    left, right = flat["left"], flat["right"]
    node = np.repeat(roots, N)                       # (T*N,) cursor vector
    row = np.tile(np.arange(N, dtype=np.int64) * F, T)
    steps = 0
    while True:
        x = Xr[row + feature[node]]                  # per-cursor feature
        nxt = np.where(x <= threshold[node], left[node], right[node])
        steps += 1
        if max_depth is not None:
            node = nxt
            if steps >= max_depth:
                break
        else:
            if np.array_equal(nxt, node):            # all cursors on leaves
                break
            node = nxt
    return flat["value"][node].reshape(T, N, -1)     # (T, N, K)


def cast_flat_ensemble(flat: dict[str, np.ndarray], *, float64: bool
                       ) -> dict[str, np.ndarray]:
    """Precision-cast a `flatten_ensemble` layout for the compiled scorer.

    `float64=True` keeps exact thresholds/values so x64 traversal takes
    bit-identical branches vs the numpy reference. The fp32 path nudges
    each threshold up one fp32 ulp: thresholds sit exactly on training-data
    values (quantile bin edges), so values that compared `<=` in fp64 must
    still go left after fp32 rounding in the compiled path.
    """
    if float64:
        return dict(flat)
    thr32 = flat["threshold"].astype(np.float32)
    return {
        "feature": flat["feature"],
        "threshold": np.nextafter(thr32, np.float32(np.inf)),
        "left": flat["left"],
        "right": flat["right"],
        "value": flat["value"].astype(np.float32),
        "roots": flat["roots"],
    }


def concat_flat_trees(trees: list[_FlatTree]) -> dict[str, np.ndarray]:
    """Ragged ensemble -> concatenated arrays + `tree_offsets` (T+1,)."""
    offsets = np.cumsum([0] + [t.n_nodes for t in trees]).astype(np.int64)
    return {
        "feature": np.concatenate([t.feature for t in trees]),
        "threshold": np.concatenate([t.threshold for t in trees]),
        "threshold_bin": np.concatenate([t.threshold_bin for t in trees]),
        "left": np.concatenate([t.left for t in trees]),
        "right": np.concatenate([t.right for t in trees]),
        "value": np.concatenate([t.value for t in trees], axis=0),
        "n_samples": np.concatenate([t.n_samples for t in trees]),
        "gain": np.concatenate([t.gain for t in trees]),
        "tree_offsets": offsets,
    }


def split_flat_trees(state: dict[str, np.ndarray]) -> list[_FlatTree]:
    """Inverse of `concat_flat_trees`."""
    offsets = np.asarray(state["tree_offsets"], dtype=np.int64)
    trees = []
    for a, b in zip(offsets[:-1], offsets[1:]):
        trees.append(_FlatTree(
            feature=np.asarray(state["feature"][a:b], dtype=np.int32),
            threshold=np.asarray(state["threshold"][a:b], dtype=np.float64),
            threshold_bin=np.asarray(state["threshold_bin"][a:b],
                                     dtype=np.int32),
            left=np.asarray(state["left"][a:b], dtype=np.int32),
            right=np.asarray(state["right"][a:b], dtype=np.int32),
            value=np.asarray(state["value"][a:b], dtype=np.float64),
            n_samples=np.asarray(state["n_samples"][a:b], dtype=np.int32),
            gain=np.asarray(state["gain"][a:b], dtype=np.float64),
        ))
    return trees


def estimators_from_state(state: dict[str, np.ndarray]
                          ) -> list["DecisionTreeRegressor"]:
    """Rebuild predict-ready DecisionTreeRegressor wrappers from a
    concatenated-ensemble state (the shared tail of forest/GBDT
    `from_state`)."""
    max_depth = int(state["max_depth"][()])
    n_features = int(state["n_features"][()])
    n_targets = int(state["n_targets"][()])
    out = []
    for t in split_flat_trees(state):
        est = DecisionTreeRegressor(max_depth=max_depth)
        est.tree_ = t
        est.n_features_ = n_features
        est.n_targets_ = n_targets
        out.append(est)
    return out


class _TreeBuilder:
    """Depth-first histogram CART builder on pre-binned features."""

    def __init__(
        self,
        binner: Binner,
        max_depth: int,
        min_samples_split: int,
        min_samples_leaf: int,
        max_features: int | None,
        rng: np.random.Generator,
    ):
        self.binner = binner
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng

    def build(self, Xb: np.ndarray, y: np.ndarray, sample_weight: np.ndarray) -> _FlatTree:
        n, n_features = Xb.shape
        n_targets = y.shape[1]
        feature, thr, thr_bin, left, right, value, nsmp, gain = (
            [], [], [], [], [], [], [], []
        )

        def new_node() -> int:
            feature.append(-1)
            thr.append(0.0)
            thr_bin.append(0)
            left.append(-1)
            right.append(-1)
            value.append(np.zeros(n_targets))
            nsmp.append(0)
            gain.append(0.0)
            return len(feature) - 1

        root = new_node()
        # stack entries: (node_id, row_indices, depth)
        stack: list[tuple[int, np.ndarray, int]] = [(root, np.arange(n), 0)]
        while stack:
            node_id, rows, depth = stack.pop()
            w = sample_weight[rows]
            wsum = w.sum()
            ymean = (y[rows] * w[:, None]).sum(axis=0) / wsum
            value[node_id] = ymean
            nsmp[node_id] = len(rows)
            if (
                depth >= self.max_depth
                or len(rows) < self.min_samples_split
                or wsum <= 0
            ):
                continue
            best = self._best_split(Xb, y, rows, w, ymean)
            if best is None:
                continue
            f, b, g = best
            go_left = Xb[rows, f] <= b
            lrows, rrows = rows[go_left], rows[~go_left]
            if len(lrows) < self.min_samples_leaf or len(rrows) < self.min_samples_leaf:
                continue
            lid, rid = new_node(), new_node()
            feature[node_id] = f
            thr_bin[node_id] = b
            thr[node_id] = self.binner.threshold_value(f, b)
            left[node_id], right[node_id] = lid, rid
            gain[node_id] = g
            stack.append((lid, lrows, depth + 1))
            stack.append((rid, rrows, depth + 1))

        return _FlatTree(
            feature=np.array(feature, dtype=np.int32),
            threshold=np.array(thr, dtype=np.float64),
            threshold_bin=np.array(thr_bin, dtype=np.int32),
            left=np.array(left, dtype=np.int32),
            right=np.array(right, dtype=np.int32),
            value=np.array(value, dtype=np.float64).reshape(len(feature), n_targets),
            n_samples=np.array(nsmp, dtype=np.int32),
            gain=np.array(gain, dtype=np.float64),
        )

    def _best_split(self, Xb, y, rows, w, parent_mean):
        """Weighted variance-reduction split over candidate features.

        Returns (feature, bin_threshold, gain) or None. Gain is the decrease
        in total weighted SSE summed across targets.
        """
        n_features = Xb.shape[1]
        if self.max_features is not None and self.max_features < n_features:
            feats = self.rng.choice(n_features, size=self.max_features, replace=False)
        else:
            feats = np.arange(n_features)

        yr = y[rows]                      # (m, t)
        wy = yr * w[:, None]              # weighted targets
        wy2 = (yr * yr * w[:, None]).sum(axis=1)  # (m,) sum over targets of w*y^2
        wsum_tot = w.sum()
        wy_tot = wy.sum(axis=0)           # (t,)
        # parent SSE = sum w*y^2 - sum_t (sum w*y)^2 / sum w
        parent_sse = wy2.sum() - float((wy_tot**2).sum() / wsum_tot)

        best_gain = 1e-12
        best = None
        nb_all = _MAX_BINS + 1
        for f in feats:
            codes = Xb[rows, f].astype(np.int64)
            nb = self.binner.n_bins(f)
            if nb <= 1:
                continue
            cnt_w = np.bincount(codes, weights=w, minlength=nb_all)[:nb]
            if (cnt_w > 0).sum() <= 1:
                continue
            s2 = np.bincount(codes, weights=wy2, minlength=nb_all)[:nb]
            # per-target weighted sums per bin
            t = yr.shape[1]
            s1 = np.empty((nb, t))
            for k in range(t):
                s1[:, k] = np.bincount(codes, weights=wy[:, k], minlength=nb_all)[:nb]
            cw = np.cumsum(cnt_w)[:-1]
            cs1 = np.cumsum(s1, axis=0)[:-1]
            cs2 = np.cumsum(s2)[:-1]
            rw = wsum_tot - cw
            rs1 = wy_tot[None, :] - cs1
            rs2 = wy2.sum() - cs2
            valid = (cw > 0) & (rw > 0)
            if not valid.any():
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                lsse = cs2 - (cs1**2).sum(axis=1) / cw
                rsse = rs2 - (rs1**2).sum(axis=1) / rw
            child = np.where(valid, lsse + rsse, np.inf)
            b = int(np.argmin(child))
            g = parent_sse - float(child[b])
            if g > best_gain:
                best_gain = g
                best = (int(f), b, g)
        return best


@register_estimator
class DecisionTreeRegressor:
    """Multi-output CART regression tree (histogram split finding)."""

    def __init__(
        self,
        max_depth: int = 6,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        max_features: int | float | str | None = None,
        max_bins: int = _MAX_BINS,
        random_state: int | None = None,
    ):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.max_bins = max_bins
        self.random_state = random_state
        self.tree_: _FlatTree | None = None
        self.binner_: Binner | None = None
        self.n_features_: int | None = None
        self.n_targets_: int | None = None

    def _resolve_max_features(self, n_features: int) -> int | None:
        mf = self.max_features
        if mf is None:
            return None
        if mf == "sqrt":
            return max(1, int(np.sqrt(n_features)))
        if mf == "log2":
            return max(1, int(np.log2(n_features)))
        if isinstance(mf, float):
            return max(1, int(mf * n_features))
        return int(mf)

    def fit(self, X, y, sample_weight=None, *, binner: Binner | None = None,
            Xb: np.ndarray | None = None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if y.ndim == 1:
            y = y[:, None]
        self.n_features_ = X.shape[1]
        self.n_targets_ = y.shape[1]
        if sample_weight is None:
            sample_weight = np.ones(len(X))
        sample_weight = np.asarray(sample_weight, dtype=np.float64)
        if binner is None:
            binner = Binner(self.max_bins).fit(X)
            Xb = binner.transform(X)
        elif Xb is None:
            Xb = binner.transform(X)
        self.binner_ = binner
        rng = np.random.default_rng(self.random_state)
        builder = _TreeBuilder(
            binner,
            self.max_depth,
            self.min_samples_split,
            self.min_samples_leaf,
            self._resolve_max_features(X.shape[1]),
            rng,
        )
        self.tree_ = builder.build(Xb, y, sample_weight)
        return self

    def predict(self, X) -> np.ndarray:
        assert self.tree_ is not None, "not fitted"
        X = np.asarray(X, dtype=np.float64)
        out = self.tree_.predict_raw(X)
        return out[:, 0] if self.n_targets_ == 1 else out

    @property
    def feature_importances_(self) -> np.ndarray:
        """Gain-based importances, normalized to sum 1."""
        assert self.tree_ is not None and self.n_features_ is not None
        imp = np.zeros(self.n_features_)
        mask = self.tree_.feature >= 0
        np.add.at(imp, self.tree_.feature[mask], self.tree_.gain[mask])
        s = imp.sum()
        return imp / s if s > 0 else imp

    # ---- flat-array state contract (see mlperf.state) ----
    def to_state(self) -> dict[str, np.ndarray]:
        assert self.tree_ is not None, "not fitted"
        state = concat_flat_trees([self.tree_])
        state[CLASS_KEY] = class_tag(type(self))
        state["n_features"] = scalar(np.int64(self.n_features_))
        state["n_targets"] = scalar(np.int64(self.n_targets_))
        state["max_depth"] = scalar(np.int64(self.max_depth))
        return state

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray]
                   ) -> "DecisionTreeRegressor":
        obj = cls(max_depth=int(state["max_depth"][()]))
        obj.tree_ = split_flat_trees(state)[0]
        obj.n_features_ = int(state["n_features"][()])
        obj.n_targets_ = int(state["n_targets"][()])
        return obj
