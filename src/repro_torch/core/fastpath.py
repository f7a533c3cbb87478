"""Compiled fast path for the runtime decision engine.

The paper's model-selection metric is ``s = t_orig / (t_ADSALA + t_eval)``
(§IV-D): every microsecond of knob-decision latency is charged against the
speedup of every uncached BLAS call.  The reference decision path
(:meth:`~repro_torch.core.tuner.TunedSubroutine.select`) rebuilds a ``(K, F)``
feature matrix with ``np.tile``, walks the knob candidates in a Python loop
for the parallelism feature, and runs a three-stage pipeline *object* per
call.  :func:`compile_predictor` folds all of that into a
:class:`CompiledPredictor` once, at ``register()``/artifact-load time:

* the feature matrix is written straight into a preallocated per-thread
  buffer, computing ONLY the Table-III columns that survive the pipeline's
  correlation prune — pruned columns are never materialised;
* the Yeo-Johnson lambdas, standardizer mean/scale, and prune mask are fused
  into one vectorized pass over that buffer (add, power, subtract, divide —
  all in place, no pipeline-object hops or intermediate allocations);
* the parallelism ("nt") feature is vectorised: block knob spaces use the
  closed-form grid formula over precomputed ``(bm, bn)`` arrays, thread-count
  spaces are detected as dims-independent and their nt vector is computed
  once at compile time;
* **every model family lowers to a uniform branchless, table-driven
  representation** (the v2 engine):

  ========================  ==============================================
  family                    lowering
  ========================  ==============================================
  linear (LR/EN/BR)         deterministic einsum matvec
  DecisionTree/Distilled    :class:`_PredicatedTree` — slot-layout
                            fixed-depth descent, pure index arithmetic
  RF / AdaBoost / XGBoost   :class:`_StackedForest` — all trees in one
                            flat predicated table, level-synchronous
  KNN                       :class:`_ScreenedKNN` — exact lookup built
                            at compile time: BLAS-speed screen with a
                            certified margin + exact canonical rescore
                            (opt-in coreset subsample for the
                            inexact-but-faster mode)
  ========================  ==============================================

Correctness bar: for any dims, :meth:`CompiledPredictor.select` returns the
bit-identical argmin knob of the reference path — every arithmetic step
reproduces the reference's elementwise operations (same ufuncs, same
association order, float64 throughout) restricted to the surviving columns.
Tree descent and k-NN lookup are comparisons plus table gathers, so the
re-layouts cannot perturb a single bit.  ``tests/test_fastpath.py`` asserts
exact equality of the predicted-time vectors on every persisted artifact.

Two opt-in, install-analysis-backed shortcuts ride on the artifact:

* dominated-candidate prune (``prune=True``) drops candidates the tuned
  model never argmin-selects over the install-time dataset's dims
  (persisted as ``fast_live_idx``); ``prune="band"`` instead keeps every
  candidate whose predicted time ever comes within ``fast_band_pct`` % of
  the winner (a superset — robust to interpolation wobble).  Dims outside
  the dataset's bounding box fall back to full-K evaluation.
* KNN coreset (``coreset=True``) serves the k-NN lookup from a persisted
  subsample (``fast_knn_coreset``) — faster, deliberately *not* bit-exact,
  and never enabled by default.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np

from . import features as F
from .knobs import _grid_parallelism

__all__ = ["CompiledPredictor", "compile_predictor"]

#: probe dims used to detect a dims-independent parallelism measure
_PROBE_A = (64, 96, 128)
_PROBE_B = (320, 192, 256)

_LEAF = -1


# ---------------------------------------------------------------------------
# predicated single-tree descent (DecisionTree / DistilledTree)
# ---------------------------------------------------------------------------

class _PredicatedTree:
    """One regression tree in a *slot* layout: slot ``p = node*R + row`` for
    a fixed row count ``R``, with leaves as self-loops (+inf thresholds, see
    :meth:`ArrayTree.predicated_arrays`).  Descent is a fixed ``depth``
    iterations of pure index arithmetic — gather, compare, fused-multiply-
    add of the comparison bit, gather — with no per-node numpy calls, no
    leaf predication, and no early-exit checks:

        fx = Xf[featS[p]]          # feature value of this row's node
        le = fx <= thrS[p]         # the reference's go_left comparison
        p  = childS2[2*p + le]     # le=1 -> left child slot, 0 -> right

    ``childS2`` interleaves ``[right, left]`` so the indexing bit IS the
    comparison result — the same ``<=`` the reference computes, hence
    identical routing for every input including ``inf``/NaN.  Bit-exact:
    comparisons and table lookups only.

    Layouts are materialised per row count (the compiled K, the pruned
    live-K) and capped — oversized requests (large batches) fall through to
    the shared :class:`_StackedForest` path, which is equally exact.
    """

    #: largest node*rows slot table materialised (memory bound per layout)
    CAP = 1 << 18
    #: total slot budget across all cached row-count layouts (the deduped
    #: row count varies per dims, so several small layouts accumulate)
    CAP_TOTAL = 1 << 20

    def __init__(self, tree) -> None:
        self.tree = tree
        self.feat, self.thr, self.left, self.right = tree.predicated_arrays()
        self.value = tree.value
        self.depth = int(tree.depth)
        self.N = int(self.feat.size)
        self._layouts: dict[int, tuple] = {}
        self._slots_used = 0
        self._generic: _StackedForest | None = None

    def _layout(self, R: int):
        lay = self._layouts.get(R)
        if lay is None:
            rows = np.arange(R, dtype=np.int64)
            featS = (self.feat[:, None] * R + rows).ravel()
            thrS = np.repeat(self.thr, R)
            child = np.empty((self.N, R, 2), dtype=np.int64)
            child[:, :, 0] = self.right[:, None] * R + rows   # le == 0
            child[:, :, 1] = self.left[:, None] * R + rows    # le == 1
            childS2 = child.reshape(-1)
            valueS = np.repeat(self.value, R)
            lay = self._layouts[R] = (featS, thrS, childS2, valueS, rows)
            self._slots_used += self.N * R
        return lay

    def warm(self, R: int) -> None:
        """Materialise the layout for ``R`` rows at compile time."""
        if self.N * R <= self.CAP:
            self._layout(R)

    def _fallback(self) -> "_StackedForest":
        if self._generic is None:
            # built from THIS engine's (possibly threshold-folded) arrays,
            # not the original tree — both paths must agree on the feature
            # space they descend in
            shim = type("_Shim", (), {
                "predicated_arrays":
                    lambda _s: (self.feat, self.thr, self.left, self.right),
                "value": self.value, "depth": self.depth})()
            self._generic = _StackedForest([shim])
        return self._generic

    def predict(self, X: np.ndarray) -> np.ndarray:
        R = X.shape[0]
        if R not in self._layouts and (
                self.N * R > self.CAP
                or self._slots_used + self.N * R > self.CAP_TOTAL):
            return self._fallback().descend(X)[0]
        featS, thrS, childS2, valueS, _rows = self._layout(R)
        Xf = X.ravel(order="F")          # zero-copy for the F-ordered buffers
        p = np.arange(R, dtype=np.int64)            # root slots
        for _ in range(self.depth):
            fx = Xf[featS[p]]
            le = fx <= thrS[p]
            np.add(p, p, out=p)
            np.add(p, le, out=p)
            p = childS2[p]
        return valueS[p]


# ---------------------------------------------------------------------------
# stacked predicated ensembles (RF / AdaBoost / XGBoost, and the tree
# fallback for oversized batches)
# ---------------------------------------------------------------------------

class _StackedForest:
    """Every tree of an ensemble, concatenated into one flat predicated node
    table and descended level-synchronously: one short set of numpy calls
    per depth level for ALL trees x rows, instead of a per-tree Python loop
    of per-level calls.  Leaves are self-loops (+inf thresholds), so the
    descent is branchless — a fixed ``depth`` iterations with no "all rows
    done?" scans.  Bit-exact: tree inference is comparisons and table
    lookups, no floating-point reassociation, so folded ensembles predict
    the same values as the reference per-tree loop."""

    def __init__(self, trees) -> None:
        preds = [t.predicated_arrays() for t in trees]
        sizes = [p[0].size for p in preds]
        offsets = np.cumsum([0] + sizes[:-1]).astype(np.int64)
        self.roots = offsets
        self.feat = np.concatenate([p[0] for p in preds])
        self.thr = np.concatenate([p[1] for p in preds])
        left = np.concatenate([p[2] + o for p, o in zip(preds, offsets)])
        right = np.concatenate([p[3] + o for p, o in zip(preds, offsets)])
        # childS2[2*node + le]: le=1 -> left (the reference's go_left)
        child = np.empty((self.feat.size, 2), dtype=np.int64)
        child[:, 0] = right
        child[:, 1] = left
        self.child2 = child.reshape(-1)
        self.value = np.concatenate([t.value for t in trees])
        self.depth = max(int(t.depth) for t in trees)
        self.T = len(trees)
        self._per_rows: dict[int, tuple] = {}   # N -> (featN, rowsT)

    def _rows_layout(self, N: int):
        lay = self._per_rows.get(N)
        if lay is None:
            featN = self.feat * N
            rowsT = np.tile(np.arange(N, dtype=np.int64), self.T)
            lay = self._per_rows[N] = (featN, rowsT)
        return lay

    def descend(self, X: np.ndarray) -> np.ndarray:
        """(T, N) per-tree predictions for the (N, F) feature matrix."""
        N = X.shape[0]
        featN, rowsT = self._rows_layout(N)
        Xf = X.ravel(order="F")
        node = np.repeat(self.roots, N)
        for _ in range(self.depth):
            f = featN[node]
            np.add(f, rowsT, out=f)
            fx = Xf[f]
            le = fx <= self.thr[node]
            np.add(node, node, out=node)
            np.add(node, le, out=node)
            node = self.child2[node]
        return self.value[node].reshape(self.T, N)


# ---------------------------------------------------------------------------
# exact screened k-NN lookup
# ---------------------------------------------------------------------------

class _ScreenedKNN:
    """Exact k-nearest-neighbour lookup: a BLAS-speed distance *screen*
    with a certified error margin, then an exact canonical rescore of the
    few survivors.

    (KD-tree and ball-partition bounds were prototyped first and measured:
    in the 6-17D standardized Table-III feature space the balls overlap so
    heavily that 30-60% of all points survive radius/box pruning — the
    classic curse of dimensionality.  The norm-expansion screen below
    prunes to within a few points of the true k-NN union at a fraction of
    the cost, while keeping the same exactness contract.)

    At compile time the training matrix is laid out contiguously with its
    row norms.  A query batch then:

    1. screens with the norm expansion ``d2a = |p|^2 - 2 z.p`` (the
       ``|z|^2`` term is constant per query row, so it cancels out of the
       k-th-smallest comparison) — one float32 sgemm plus two cheap passes
       over ``(Q, n)`` — and keeps, per query, every point within
       ``kth + margin`` of its k-th smallest screened distance, where
       ``margin`` (relative 1e-4) generously covers the float32 precision,
       the expansion's cancellation error, and any BLAS summation-order
       wobble (all ~1e-6 relative or below: a point can only be missed if
       the screen were off by two orders of magnitude more than its
       worst-case bound);
    2. computes EXACT distances for the surviving columns with the
       reference's elementwise expression (broadcast subtract, square,
       pairwise-sum) — identical bits to the brute-force matrix;
    3. selects the k nearest by the canonical ``(distance^2, index)`` order
       and combines them with the very ufunc sequence of
       :meth:`repro_torch.core.ml.knn.KNN.predict` — bit-identical output.

    Non-finite queries (feature overflow at extreme dims) skip the screen
    and rescore against every point — still exact, just slower.

    ``coreset`` mode runs the same lookup over a persisted subsample —
    equivalent to a KNN *fit on that subsample* (deliberately inexact
    w.r.t. the full model; opt-in only).
    """

    def __init__(self, model, *, coreset_idx=None) -> None:
        X, y = model.X_, model.y_
        if coreset_idx is not None:
            sel = np.asarray(coreset_idx, dtype=np.int64)
            X, y = X[sel], y[sel]
        self.model = model
        self.k = int(model.k)
        self.weights = str(model.weights)
        self.P = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        self.y = np.asarray(y, dtype=np.float64)
        self.n = self.P.shape[0]
        # the screen runs in float32 (sgemm + cheap partition) — its only
        # job is a candidate superset, and the margin covers the precision
        # drop with ~100x headroom
        self.Pt32 = np.ascontiguousarray(self.P.T.astype(np.float32))
        self.pn32 = np.einsum("ij,ij->i", self.Pt32.T, self.Pt32.T)
        # persistent per-thread screen workspace (same pattern as the
        # CompiledPredictor feature buffers): batched select_many flushes
        # repeat the same query-row counts, so the float32 query copy and
        # the (Q, n) sgemm output are reused instead of rebuilt per call
        self._tls = threading.local()

    def _screen_buffers(self, q: int, c: int) -> tuple:
        """(Z32, d2a) preallocated for this thread at ``q`` query rows."""
        bufs = getattr(self._tls, "bufs", None)
        if bufs is None:
            bufs = self._tls.bufs = {}
        b = bufs.get(q)
        if b is None:
            b = bufs[q] = (np.empty((q, c), dtype=np.float32),
                           np.empty((q, self.n), dtype=np.float32))
        return b

    def _exact_d2(self, Z: np.ndarray, cols: np.ndarray) -> np.ndarray:
        # the reference's expression verbatim: broadcast subtract, square,
        # pairwise-sum over the contiguous feature axis -> identical bits
        return ((Z[:, None, :] - self.P[cols][None, :, :]) ** 2).sum(-1)

    #: extra screened candidates beyond k, absorbing boundary-tie clusters
    PAD = 8

    def predict(self, Z: np.ndarray) -> np.ndarray:
        n = self.n
        kk = min(self.k, n)
        # C-contiguous queries, matching the reference predict's own
        # canonicalisation: every distance reduction then associates
        # identically whether computed against the full matrix or a
        # gathered candidate subset
        Z = np.ascontiguousarray(Z)
        zn = np.einsum("ij,ij->i", Z, Z)
        Z32, d2a = self._screen_buffers(Z.shape[0], Z.shape[1])
        np.copyto(Z32, Z)                     # downcast == Z.astype(f32)
        if n <= 4 * kk or not np.isfinite(zn).all() \
                or not np.isfinite(Z32).all():
            return self._rescore(Z, np.arange(n))
        # -- screen: norm expansion at BLAS speed ------------------------
        # (|z|^2 is constant per row, so it shifts every entry AND the
        # k-th threshold equally — leave it out of the screen matrix)
        np.matmul(Z32, self.Pt32, out=d2a)
        d2a *= np.float32(-2.0)
        d2a += self.pn32
        M = min(kk + self.PAD, n)
        idx = np.argpartition(d2a, M - 1, axis=1)[:, :M]    # top-M per query
        screened = np.take_along_axis(d2a, idx, axis=1)
        kth = np.partition(screened, kk - 1, axis=1)[:, kk - 1] \
            .astype(np.float64)
        # margin scale = the true distance magnitudes at the k-th boundary
        # (kth is |z|^2-shifted, so add zn back); 1e-4 relative dwarfs the
        # float32 representation + sgemm accumulation error (~3e-6)
        margin = (zn + np.maximum(kth + zn, 0.0)) * 1e-4 + 1e-10
        thr = (kth + margin).astype(np.float32)
        counts = (d2a <= thr[:, None]).sum(axis=1)
        if int(counts.max()) <= M:
            # every possible top-k member of every query sits in its top-M
            # (if any point outside the top-M were within thr, the count
            # would exceed M) — rescore per query, no cross-query union
            o = np.sort(idx, axis=1)          # ascending original index
            d2 = ((Z[:, None, :] - self.P[o]) ** 2).sum(-1)
            nn = np.argsort(d2, axis=1, kind="stable")[:, :kk]
            ny = np.take_along_axis(self.y[o], nn, axis=1)
            nd = np.sqrt(np.take_along_axis(d2, nn, axis=1)) \
                if self.weights == "distance" else None
            return self.model._combine(ny, nd)
        # boundary-tie cluster wider than the pad: fall back to the union
        # of every query's thr-survivors (rare, still far below n)
        return self._rescore(Z, np.flatnonzero((d2a <= thr[:, None]).any(0)))

    def _rescore(self, Z: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Exact rescore + canonical selection over shared candidate
        columns (``cols`` ascend in original index, so stable-sort ties are
        already broken canonically)."""
        kk = min(self.k, self.n)
        d2 = self._exact_d2(Z, cols)
        if d2.shape[1] > 16 * kk:
            kv = np.partition(d2, kk - 1, axis=1)[:, kk - 1]
            sub = np.flatnonzero((d2 <= kv[:, None]).any(0))
            d2 = d2[:, sub]
            cols = cols[sub]
        nn = np.argsort(d2, axis=1, kind="stable")[:, :kk]
        ny = self.y[cols][nn]
        nd = np.sqrt(np.take_along_axis(d2, nn, axis=1)) \
            if self.weights == "distance" else None
        return self.model._combine(ny, nd)


# ---------------------------------------------------------------------------
# monotone-threshold folding (tree descents on RAW features)
# ---------------------------------------------------------------------------

def _invert_monotone_thresholds(tfun, thr: np.ndarray,
                                saturates: np.ndarray | None = None
                                ) -> np.ndarray:
    """Per-node raw-space thresholds: the largest finite float ``x >= 0``
    with ``tfun(x) <= thr``, found by bisection over the IEEE-754 bit
    representation (monotone for non-negative doubles), vectorised over all
    nodes at once.

    ``tfun`` must evaluate each node's per-column preprocess transform with
    the exact ufunc sequence of :meth:`CompiledPredictor._transform`; since
    the float transform is monotone non-decreasing (Yeo-Johnson with any
    lambda, then an affine map with positive scale), the comparison
    ``raw_x <= inverted_thr`` is then EXACTLY equivalent to
    ``tfun(raw_x) <= thr`` for every representable non-negative input,
    including ``+inf`` — the whole preprocess pass disappears from tree
    descents with zero effect on any decision.  Non-finite thresholds (the
    +inf leaf self-loops) pass through untouched.

    ``saturates`` marks nodes whose transform approaches a FINITE limit as
    ``x -> inf`` (Yeo-Johnson with negative lambda): when such a node's
    threshold clears the entire finite range, ``tfun(inf) <= thr`` is still
    True, so the inverted threshold must be ``+inf`` rather than the
    largest finite double (an ``x = +inf`` query would otherwise flip from
    left to right).  Non-saturating transforms diverge at infinity and need
    no special case.
    """
    n = thr.size
    lo = np.zeros(n, dtype=np.int64)                  # bits of +0.0
    hi = np.full(n, np.float64(np.finfo(np.float64).max).view(np.int64))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for _ in range(63):                           # spans all finite bits
            mid = lo + ((hi - lo + 1) >> 1)
            ok = tfun(mid.view(np.float64)) <= thr
            lo = np.where(ok, mid, lo)
            hi = np.where(ok, hi, mid - 1)
        raw = lo.view(np.float64).copy()
        if saturates is not None:
            raw[saturates & (raw == np.finfo(np.float64).max)] = np.inf
        # thresholds below the entire non-negative range: always go right
        raw[~(tfun(np.zeros(n)) <= thr)] = -np.inf
    raw[~np.isfinite(thr)] = thr[~np.isfinite(thr)]
    return raw


# ---------------------------------------------------------------------------
# model folding
# ---------------------------------------------------------------------------

def _fold_model(model, knn_coreset=None):
    """``(predict, lowering, engine)``: the model's predict lowered to the
    uniform table-driven form, a short name of the lowering used (for
    introspection and the decision bench), and the table engine behind it
    (None for plain ``model.predict``).  Combination rules replicate the
    reference predicts operation for operation, so outputs are
    bit-identical (except the opt-in KNN coreset mode, which is documented
    as inexact)."""
    single = getattr(model, "tree_", None)
    if single is not None and hasattr(single, "predicated_arrays") \
            and hasattr(single, "depth"):
        tree = _PredicatedTree(single)
        return tree.predict, "predicated-tree", tree
    if getattr(model, "NAME", None) == "KNN" and model.X_ is not None:
        mode = "screened-knn" if knn_coreset is None \
            else "screened-knn-coreset"
        knn = _ScreenedKNN(model, coreset_idx=knn_coreset)
        return knn.predict, mode, knn
    trees = getattr(model, "trees_", None)
    if not trees or not all(hasattr(t, "predicated_arrays")
                            and hasattr(t, "depth") for t in trees):
        return model.predict, "reference-predict", None
    name = getattr(model, "NAME", None)
    forest = _StackedForest(trees)
    if name == "RandomForest":
        return (lambda Z: np.mean(forest.descend(Z), axis=0),
                "stacked-forest", forest)
    if name == "XGBoost":
        base = float(model.base_)
        lr = float(model.learning_rate)

        def xgb_predict(Z):
            P = forest.descend(Z)
            out = np.full(Z.shape[0], base)
            for i in range(P.shape[0]):        # same add order as reference
                out += lr * P[i]
            return out
        return xgb_predict, "stacked-forest", forest
    if name == "AdaBoost":
        logw = np.log(1.0 / np.maximum(model.betas_, 1e-300))
        half = 0.5 * logw.sum()

        def ada_predict(Z):
            preds = np.ascontiguousarray(forest.descend(Z).T)      # (N, T)
            order = np.argsort(preds, axis=1)
            sorted_preds = np.take_along_axis(preds, order, axis=1)
            cum = np.cumsum(logw[order], axis=1)
            pick = (cum >= half).argmax(axis=1)
            return sorted_preds[np.arange(preds.shape[0]), pick]
        return ada_predict, "stacked-forest", forest
    return model.predict, "reference-predict", None


class CompiledPredictor:
    """One tuned (subroutine, pipeline, model) folded into a flat predict.

    Thread-safe: the preallocated feature/transform buffers are per-thread
    (the runtime evaluates models outside its lock), and all compiled
    parameters are read-only after construction.
    """

    def __init__(self, op: str, knob_space, pipeline, model,
                 log_target: bool, *, live_idx=None, dims_lo=None,
                 dims_hi=None, prune=False, band_idx=None,
                 knn_coreset=None, coreset: bool = False) -> None:
        self.op = op
        self.knob_space = knob_space
        self.model = model
        self.artifact_version = 0       # stamped by compile_predictor
        self.coreset = bool(coreset) and knn_coreset is not None \
            and getattr(model, "NAME", None) == "KNN"
        self._predict, self.lowering, self._engine = _fold_model(
            model, knn_coreset=knn_coreset if self.coreset else None)
        self.log_target = bool(log_target)
        self.candidates = list(knob_space.candidates)
        self.K = len(self.candidates)
        self.ndims = F.SUBROUTINE_NDIMS[op]

        # -- fused preprocess parameters (surviving columns only) ------------
        keep, lam, mean, scale = pipeline.fused_params()
        self.keep = keep
        self.C = int(keep.size)
        self.use_yj = lam is not None
        if self.use_yj:
            self._lam = lam.reshape(1, -1)
            self._lam_safe = np.where(np.abs(self._lam) > 1e-6,
                                      self._lam, 1.0)
            self._log_cols = np.flatnonzero(np.abs(lam) <= 1e-6)
        self._mean = mean.reshape(1, -1)
        self._scale = scale.reshape(1, -1)

        # -- vectorised parallelism ("nt") -----------------------------------
        self._nt_mode = "generic"
        self._nt_const = None
        if getattr(knob_space, "_parallelism_fn", None) is _grid_parallelism:
            dicts = [c.dict for c in self.candidates]
            self._bm = np.array([c["bm"] for c in dicts], dtype=np.float64)
            self._bn = np.array([c["bn"] for c in dicts], dtype=np.float64)
            # tri_packed launches the packed triangle: (cm+1)/2 live row
            # blocks per column (see knobs._grid_parallelism) — all values
            # are small exact integers in f64, so any evaluation order
            # reproduces the reference bit-for-bit
            self._packed = np.array(
                [c.get("variant") == "tri_packed" for c in dicts],
                dtype=bool)
            # folded at compile time: spaces without tri_packed candidates
            # (gemm, symm, trsm, every legacy artifact) skip the packed
            # branch entirely — a runtime .any() costs real microseconds on
            # the K~8 cold path
            self._has_packed = bool(self._packed.any())
            self._nt_mode = "grid"
        else:
            try:
                va = knob_space.parallelism_vec(_PROBE_A[: self.ndims])
                vb = knob_space.parallelism_vec(_PROBE_B[: self.ndims])
                if np.array_equal(va, vb) and all(
                        "nt" in c.dict for c in self.candidates):
                    # thread-count-style space: nt never depends on dims, so
                    # this feature column is computed once, here
                    self._nt_const = np.asarray(va, dtype=np.float64)
                    self._nt_mode = "const"
            except Exception:
                pass        # exotic space: per-call parallelism_vec fallback

        # -- optional dominated-candidate prune ------------------------------
        # prune=True: the argmin live set; prune="band": every candidate
        # whose prediction ever came within the persisted band of the winner
        self._live = None
        pick = band_idx if prune == "band" else live_idx
        if prune and pick is not None and dims_lo is not None \
                and dims_hi is not None:
            live = np.unique(np.asarray(pick, dtype=np.int64))
            if 0 < live.size < self.K \
                    and live[0] >= 0 and live[-1] < self.K:
                self._live = live
                self._dims_lo = np.asarray(dims_lo).reshape(-1)
                self._dims_hi = np.asarray(dims_hi).reshape(-1)
                if self._nt_mode == "grid":
                    self._bm_live = self._bm[live]
                    self._bn_live = self._bn[live]
                    self._packed_live = self._packed[live]
                    self._has_packed_live = bool(self._packed_live.any())
                elif self._nt_mode == "const":
                    self._nt_const_live = self._nt_const[live]

        # element-bound lowerings get the duplicate-row fold: candidates
        # whose nt coincides produce byte-identical feature rows, and every
        # lowered predict is row-pure, so each distinct row is evaluated
        # once and scattered back (bit-exact, typically a 2-3x row cut).
        # Call-overhead-bound lowerings (predicated tree descent, linear
        # matvec) are excluded — fewer rows there saves nothing and the
        # unique() would be pure overhead.
        self._dedup = self.lowering in (
            "screened-knn", "screened-knn-coreset", "stacked-forest")
        if self._dedup and self._nt_mode == "const":
            self._const_fold = np.unique(self._nt_const, return_inverse=True)
            if self._live is not None:
                self._const_fold_live = np.unique(self._nt_const_live,
                                                  return_inverse=True)

        # tree lowerings get their thresholds inverted through the (per
        # column strictly monotone) preprocess at compile time, so descents
        # compare RAW Table-III features and the whole YJ+standardize pass
        # vanishes from the decision — bit-exactly (see
        # _invert_monotone_thresholds).  Bounded by node count: the
        # bisection is a compile-time cost paid once per artifact.
        self._skip_transform = False
        eng = self._engine
        if self.lowering in ("predicated-tree", "stacked-forest") \
                and eng is not None and eng.feat.size <= (1 << 16):
            tfun, saturates = self._node_transform(eng.feat)
            eng.thr = _invert_monotone_thresholds(tfun, eng.thr, saturates)
            self._skip_transform = True

        # predicated layouts for the row counts this predictor will serve
        # are materialised NOW, not on the first decision
        warm = getattr(self._engine, "warm", None)
        if warm is not None:
            warm(self.K)
            if self._live is not None:
                warm(int(self._live.size))

        self._tls = threading.local()

    def _node_transform(self, cols: np.ndarray):
        """``(tfun, saturates)``: the vectorised per-node column transform
        (element ``i`` applies the fused YJ+standardize of kept column
        ``cols[i]`` with the exact ufunc sequence of :meth:`_transform`)
        plus the mask of nodes whose transform saturates at a finite limit
        as ``x -> inf`` (negative-lambda Yeo-Johnson)."""
        mean = self._mean.ravel()[cols]
        scale = self._scale.ravel()[cols]
        if not self.use_yj:
            return (lambda x: (x - mean) / scale), np.zeros(cols.size, bool)
        lam = self._lam.ravel()[cols]
        lam_safe = self._lam_safe.ravel()[cols]
        islog = np.isin(cols, self._log_cols)

        def tfun(x: np.ndarray) -> np.ndarray:
            t = (np.power(x + 1.0, lam) - 1.0) / lam_safe
            if islog.any():
                t = np.where(islog, np.log1p(x), t)
            return (t - mean) / scale
        return tfun, (lam < 0) & ~islog

    # -- buffers --------------------------------------------------------------
    def _buffers(self, rows: int) -> tuple:
        """(X, T, nt) preallocated for this thread at ``rows`` candidates."""
        bufs = getattr(self._tls, "bufs", None)
        if bufs is None:
            bufs = self._tls.bufs = {}
        b = bufs.get(rows)
        if b is None:
            # F-order matches the reference pipeline's layout (its prune is
            # a fancy index, which numpy returns column-major), so even the
            # models' layout-sensitive low-order float bits reproduce
            b = bufs[rows] = (np.empty((rows, self.C), order="F"),
                              np.empty((rows, self.C), order="F"),
                              np.empty(rows))
        return b

    # -- feature building -----------------------------------------------------
    def _nt_into(self, dims: tuple, out: np.ndarray, bm: np.ndarray,
                 bn: np.ndarray, packed: np.ndarray | None) -> np.ndarray:
        if self._nt_mode == "grid":
            # == float(ceil(m/bm) * ceil(n/bn)) per candidate, vectorised;
            # tri_packed rows carry the packed-triangle fraction (cm+1)/2
            # (exact small integers in f64 — bit-equal to the reference
            # regardless of evaluation order)
            np.divide(dims[0], bm, out=out)
            np.ceil(out, out=out)
            if packed is not None:        # caller passes it only when set
                out[packed] = (out[packed] + 1.0) * 0.5
            out *= np.ceil(dims[-1] / bn)
            return out
        return np.asarray(self.knob_space.parallelism_vec(dims),
                          dtype=np.float64)

    # -- the fused pass -------------------------------------------------------
    def _transform(self, X: np.ndarray, T: np.ndarray) -> np.ndarray:
        """Yeo-Johnson + standardize over the already-pruned columns, fused.

        Reproduces ``pipeline.transform`` bit-for-bit on the kept columns:
        Table-III features are non-negative, so only the reference's
        positive YJ branch — ``(power(x+1, λ) - 1)/λ`` or ``log1p(x)`` at
        λ≈0 — is ever taken.
        """
        if self.use_yj:
            np.add(X, 1.0, out=T)
            np.power(T, self._lam, out=T)
            np.subtract(T, 1.0, out=T)
            np.divide(T, self._lam_safe, out=T)
            for j in self._log_cols:
                np.log1p(X[:, j], out=T[:, j])
            Z = T
        else:
            Z = X
        np.subtract(Z, self._mean, out=Z)
        np.divide(Z, self._scale, out=Z)
        return Z

    def _times(self, dims: tuple, rows_idx: np.ndarray | None) -> np.ndarray:
        """Predicted time per candidate (all K, or the live subset)."""
        if rows_idx is None:
            rows = self.K
            bm = getattr(self, "_bm", None)
            bn = getattr(self, "_bn", None)
            packed = self._packed if getattr(self, "_has_packed", False) \
                else None
            nt_const = self._nt_const
            const_fold = getattr(self, "_const_fold", None)
        else:
            rows = int(rows_idx.size)
            bm = getattr(self, "_bm_live", None)
            bn = getattr(self, "_bn_live", None)
            packed = self._packed_live \
                if getattr(self, "_has_packed_live", False) else None
            nt_const = getattr(self, "_nt_const_live", None)
            const_fold = getattr(self, "_const_fold_live", None)
        inv = None
        if self._nt_mode == "const":
            nt = nt_const
            if const_fold is not None and const_fold[0].size < rows:
                nt, inv = const_fold
        else:
            _, _, ntb = self._buffers(rows)
            nt = self._nt_into(dims, ntb, bm, bn, packed)
            if rows_idx is not None and self._nt_mode == "generic":
                nt = nt[rows_idx]
            if self._dedup:
                # dict-based exact fold: ~4x cheaper than np.unique at
                # candidate-set sizes, and keeps first-seen order
                seen: dict = {}
                uinv = []
                for v in nt.tolist():
                    j = seen.get(v)
                    if j is None:
                        j = seen[v] = len(seen)
                    uinv.append(j)
                if len(seen) < rows:
                    nt = np.fromiter(seen, dtype=np.float64)
                    inv = np.asarray(uinv, dtype=np.int64)
        X, T, _ = self._buffers(int(nt.size))
        F.fill_features_into(self.op, dims, nt, self.keep, X)
        Z = X if self._skip_transform else self._transform(X, T)
        pred = self._predict(Z)
        if self.log_target:
            pred = np.exp(pred)      # before the scatter: fewer rows
        if inv is not None:
            pred = pred[inv.reshape(-1)]
        return pred

    # -- public API -----------------------------------------------------------
    def predict_times(self, dims: tuple) -> np.ndarray:
        """Predicted runtime for every knob candidate (= reference
        ``TunedSubroutine.predict_times``, bit-identical)."""
        return self._times(tuple(dims), None)

    def select_index(self, dims: tuple) -> int:
        dims = tuple(dims)
        live = self._live
        if live is not None and self._in_bounds(dims):
            return int(live[int(np.argmin(self._times(dims, live)))])
        return int(np.argmin(self._times(dims, None)))

    def select(self, dims: tuple):
        return self.candidates[self.select_index(dims)]

    def _in_bounds(self, dims: tuple) -> bool:
        lo, hi = self._dims_lo, self._dims_hi
        for i, d in enumerate(dims):
            if d < lo[i] or d > hi[i]:
                return False
        return True

    # -- batched API ----------------------------------------------------------
    def predict_times_batch(self, dims_list) -> np.ndarray:
        """(B, K) predicted times for B dims in ONE feature-build + predict.

        Row ``b`` is bit-identical to ``predict_times(dims_list[b])`` — all
        feature/transform arithmetic is elementwise and the models predict
        row-wise, so batching cannot change any decision.
        """
        B = len(dims_list)
        dims_arr = np.asarray(dims_list, dtype=np.float64)
        if self._nt_mode == "grid":
            cm = np.ceil(dims_arr[:, :1] / self._bm)
            if self._has_packed:
                cm = np.where(self._packed, (cm + 1.0) * 0.5, cm)
            nt = cm * np.ceil(dims_arr[:, -1:] / self._bn)
        elif self._nt_mode == "const":
            nt = np.broadcast_to(self._nt_const, (B, self.K))
        else:
            nt = np.stack([np.asarray(self.knob_space.parallelism_vec(
                tuple(int(v) for v in d)), dtype=np.float64)
                for d in dims_list])
        if self._dedup:
            # fold duplicate (item, nt) rows across the whole batch: the
            # complex key packs the pair exactly (two float64s), and rows
            # with equal dims AND nt are byte-identical, so one evaluation
            # per distinct key scatters back bit-exactly
            keys = np.empty((B, self.K), dtype=np.complex128)
            keys.real = nt
            keys.imag = np.arange(B, dtype=np.float64)[:, None]
            uk, inv = np.unique(keys.reshape(-1), return_inverse=True)
            U = uk.size
            if U < B * self.K:
                dims_u = dims_arr[uk.imag.astype(np.int64)]
                nt_u = np.ascontiguousarray(uk.real)
                X3 = np.empty((self.C, U, 1))
                Xv = X3.transpose(1, 2, 0)
                F.fill_features_batch(self.op, dims_u, nt_u.reshape(U, 1),
                                      self.keep, Xv)
                Xf = Xv.reshape(U, self.C)
                if self._skip_transform:
                    pred = self._predict(Xf)
                else:
                    T = np.empty((U, self.C), order="F")
                    pred = self._predict(self._transform(Xf, T))
                pred = pred[inv.reshape(-1)]
                t = np.exp(pred) if self.log_target else pred
                return t.reshape(B, self.K)
        # (B, K, C) view over an F-ordered (B*K, C) buffer, so the matrix
        # handed to the model has the same layout class as the single-call
        # path's F-ordered buffers (bit-stable tie-breaking either way:
        # identical feature rows within one matrix predict identical values)
        X3 = np.empty((self.C, B, self.K))
        Xv = X3.transpose(1, 2, 0)
        F.fill_features_batch(self.op, dims_arr, nt, self.keep, Xv)
        Xf = Xv.reshape(B * self.K, self.C)
        if self._skip_transform:
            pred = self._predict(Xf)
        else:
            T = np.empty((B * self.K, self.C), order="F")
            pred = self._predict(self._transform(Xf, T))
        t = np.exp(pred) if self.log_target else pred
        return t.reshape(B, self.K)

    def select_many(self, dims_list) -> list:
        """Argmin knob per dims, vectorised across the whole batch.

        Applies the same dominated-candidate restriction as :meth:`select`
        (per item, honouring the bounds fallback), so batched and
        one-at-a-time decisions agree."""
        t = self.predict_times_batch(dims_list)
        live = self._live
        out = []
        for b, dims in enumerate(dims_list):
            if live is not None and self._in_bounds(tuple(dims)):
                i = int(live[int(np.argmin(t[b, live]))])
            else:
                i = int(np.argmin(t[b]))
            out.append(self.candidates[i])
        return out


def compile_predictor(sub, *, prune=False,
                      coreset: bool = False) -> CompiledPredictor | None:
    """Fold a :class:`~repro_torch.core.tuner.TunedSubroutine`-like artifact into a
    :class:`CompiledPredictor`.

    ``prune``: ``False`` (full candidate set), ``True`` (argmin live set),
    or ``"band"`` (confidence-band live set — candidates ever within the
    persisted ``fast_band_pct`` % of the winner).  ``coreset=True`` opts a
    KNN artifact into its persisted inexact subsample.

    Returns ``None`` when the artifact lacks the required pieces (stub
    subroutines in tests, partially constructed objects) or compilation
    fails — callers fall back to the reference ``sub.select`` path, which is
    always correct, just slower.
    """
    pipeline = getattr(sub, "pipeline", None)
    model = getattr(sub, "model", None)
    space = getattr(sub, "knob_space", None)
    op = getattr(sub, "op", None)
    if pipeline is None or model is None or space is None \
            or op not in F.SUBROUTINE_NDIMS:
        return None
    try:
        cp = CompiledPredictor(
            op, space, pipeline, model,
            getattr(sub, "log_target", False),
            live_idx=getattr(sub, "fast_live_idx", None),
            dims_lo=getattr(sub, "fast_dims_lo", None),
            dims_hi=getattr(sub, "fast_dims_hi", None),
            band_idx=getattr(sub, "fast_band_idx", None),
            knn_coreset=getattr(sub, "fast_knn_coreset", None),
            prune=prune, coreset=coreset)
        # carried through so hot-swap/telemetry consumers (the online
        # retuner, the decision-cache export) can attribute a prediction to
        # the artifact generation that produced it without reaching back
        # into the source subroutine
        cp.artifact_version = int(getattr(sub, "artifact_version", 0) or 0)
        return cp
    except Exception as e:                       # noqa: BLE001
        warnings.warn(f"fast-path compile failed for {op!r} "
                      f"({type(e).__name__}: {e}); using reference path",
                      RuntimeWarning, stacklevel=2)
        return None
