"""Proxy-first φ cascades: accuracy-targeted semantic predicates.

The idea (Semantic SQL, arXiv 2404.03880; Kang's analytical-query line): a
cheap proxy scorer answers most of a boolean semantic predicate, and only
items whose proxy score falls inside an uncertainty band [lo, hi] escalate to
the expensive extractor φ.  The band is *calibrated*: from a labeled sample
(proxy score, exact-φ verdict) the :class:`CascadeCalibrator` fits the widest
pair of cuts whose expected error stays inside the user's accuracy budget, so
`WITH ACCURACY 0.95` is a statement about result quality, not a magic knob.

Routing is deliberately trivial and total::

    score < lo   -> reject   (proxy is confident the predicate is false)
    score > hi   -> accept   (proxy is confident it is true)
    otherwise    -> escalate (ask the exact φ)

Monotonicity contract (pinned by a property test): widening the band --
lowering ``lo`` and/or raising ``hi`` -- can only move items *into* the
escalation set.  An accepted item never becomes rejected (or vice versa), so
tightening the accuracy target never silently flips answers; it only buys
more exact-φ work.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CurveKey = Tuple[str, int, int]   # (sub_key, exact serial, proxy serial)


def _cosine_rows(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity (same arithmetic as the executor's
    ``_similarity``, duplicated here to keep the import graph acyclic)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    num = np.sum(x * y, axis=-1)
    den = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
    return num / np.maximum(den, 1e-9)


def curve_from_vectors(exact_vecs: np.ndarray, proxy_vecs: np.ndarray,
                       pairs: int, seed: int, sim_threshold: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled calibration pairs from parallel (exact φ, proxy φ) samples:
    seeded random (i, j) index pairs, proxy cosine as the score, exact cosine
    >= ``sim_threshold`` as the ground-truth label -- exactly the quantities
    the ``~:`` predicate compares at query time.  Deterministic in (sample,
    seed), so a cluster coordinator feeding every shard the same gathered
    sample gets bit-identical curves everywhere."""
    exact_vecs = np.asarray(exact_vecs)
    proxy_vecs = np.asarray(proxy_vecs)
    n = exact_vecs.shape[0]
    if n < 2:
        raise ValueError("need at least 2 sampled items to draw pairs")
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, n, size=pairs)
    jj = rng.integers(0, n, size=pairs)
    scores = _cosine_rows(proxy_vecs[ii], proxy_vecs[jj]).astype(np.float64)
    labels = _cosine_rows(exact_vecs[ii], exact_vecs[jj]) >= sim_threshold
    return scores, labels


def route_scores(scores: np.ndarray, lo: float, hi: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition proxy scores into (accept, reject, escalate) boolean masks.

    Total: every item lands in exactly one mask.  NaN scores (proxy failed to
    produce a number) escalate -- the exact φ is the safe fallback.
    """
    s = np.asarray(scores, np.float64)
    reject = s < lo
    accept = s > hi
    escalate = ~(reject | accept)
    return accept, reject, escalate


@dataclasses.dataclass(frozen=True)
class CascadeThresholds:
    """One fitted band plus the sample statistics behind it."""

    lo: float
    hi: float
    expected_escalation: float   # fraction of sample inside [lo, hi]
    expected_accuracy: float     # 1 - sample errors outside the band / n
    sample_n: int


class CascadeCalibrator:
    """Fits per-(sub_key, serial-pair) routing bands from labeled samples.

    A *curve* is the raw calibration material: proxy scores with exact-φ
    boolean labels, sorted by score.  Thresholds for any accuracy target are
    derived from the curve on demand and memoized, so one calibration pass
    serves every target a query might name.

    Fitting: with scores sorted ascending, a band is a pair of cut indices
    (i, j) -- reject the first ``i`` items, accept the last ``n - j``.  The
    routing errors that choice commits on the sample are the positives among
    the rejected prefix plus the negatives among the accepted suffix; the fit
    maximizes ``i + (n - j)`` (minimum escalation) subject to those errors
    staying within ``floor((1 - target) * n)``.  Cuts are only placed between
    distinct score values (midpoint thresholds), so routing by ``< lo`` /
    ``> hi`` reproduces the chosen partition exactly, ties included.
    """

    def __init__(self, min_curve_pairs: int = 16, metrics=None) -> None:
        self.min_curve_pairs = min_curve_pairs
        self._lock = threading.Lock()
        self._curves: Dict[CurveKey, Tuple[np.ndarray, np.ndarray]] = {}
        self._memo: Dict[Tuple[CurveKey, float], CascadeThresholds] = {}
        #: optional MetricsRegistry: curve installs + band fits (memoized
        #: lookups excluded, so the counter tracks real fitting work)
        self.metrics = metrics

    # -- curves --------------------------------------------------------------

    def set_curve(self, sub_key: str, exact_serial: int, proxy_serial: int,
                  scores: Sequence[float], labels: Sequence[bool]) -> None:
        s = np.asarray(scores, np.float64)
        y = np.asarray(labels, bool)
        if s.shape != y.shape or s.ndim != 1:
            raise ValueError("scores and labels must be equal-length 1-D")
        order = np.argsort(s, kind="stable")
        key = (sub_key, int(exact_serial), int(proxy_serial))
        with self._lock:
            self._curves[key] = (s[order], y[order])
            self._memo = {k: v for k, v in self._memo.items() if k[0] != key}
        if self.metrics is not None:
            self.metrics.counter("cascade_curves_installed").inc()

    def curve(self, sub_key: str, exact_serial: int, proxy_serial: int
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The raw (sorted scores, labels) pair -- cluster replication ships
        this so every shard derives bit-identical thresholds."""
        with self._lock:
            return self._curves.get((sub_key, int(exact_serial),
                                     int(proxy_serial)))

    def has_curve(self, sub_key: str, exact_serial: int,
                  proxy_serial: int) -> bool:
        with self._lock:
            return (sub_key, int(exact_serial),
                    int(proxy_serial)) in self._curves

    def drop(self, sub_key: str) -> int:
        """Forget every curve for ``sub_key`` (either tier re-registered:
        old calibrations describe a model that no longer answers)."""
        with self._lock:
            stale = [k for k in self._curves if k[0] == sub_key]
            for k in stale:
                del self._curves[k]
            self._memo = {k: v for k, v in self._memo.items()
                          if k[0][0] != sub_key}
            return len(stale)

    # -- threshold fitting ---------------------------------------------------

    def thresholds(self, sub_key: str, exact_serial: int, proxy_serial: int,
                   target: float) -> Optional[CascadeThresholds]:
        """The widest band meeting ``target`` accuracy on the curve's sample,
        or None when no usable curve exists (caller must escalate everything
        -- i.e. run the direct path)."""
        key = (sub_key, int(exact_serial), int(proxy_serial))
        target = float(target)
        with self._lock:
            memo = self._memo.get((key, target))
            if memo is not None:
                if self.metrics is not None:
                    self.metrics.counter("cascade_fit_memo_hits").inc()
                return memo
            curve = self._curves.get(key)
        if curve is None or curve[0].size < self.min_curve_pairs:
            return None
        fit = _fit_band(curve[0], curve[1], target)
        with self._lock:
            self._memo[(key, target)] = fit
        if self.metrics is not None:
            self.metrics.counter("cascade_band_fits").inc()
        return fit


def _fit_band(s: np.ndarray, y: np.ndarray, target: float
              ) -> CascadeThresholds:
    """Maximize rejected+accepted count s.t. sample errors <= (1-target)*n.

    ``s`` sorted ascending, ``y`` the exact-φ labels in the same order.
    """
    n = s.size
    budget = int(np.floor((1.0 - target) * n))
    # Hold back a two-sigma generalization margin: binomial error counts
    # fluctuate ~sqrt(budget) between sample and query distribution, and the
    # fit *selects* the cut that looks best on the sample (winner's curse),
    # so spending the whole budget lands just under target at query time.
    budget = max(0, budget - int(np.ceil(2.0 * np.sqrt(budget))))
    # legal cut positions: 0, n, and boundaries between distinct scores
    cuts: List[int] = [0]
    cuts.extend(p for p in range(1, n) if s[p] != s[p - 1])
    cuts.append(n)
    pre_pos = np.concatenate([[0], np.cumsum(y.astype(np.int64))])     # P[i]
    suf_neg = np.concatenate([np.cumsum((~y)[::-1].astype(np.int64))[::-1],
                              [0]])                                    # Sn[j]
    best_i, best_j, best_kept = 0, n, -1
    # j candidates with suf_neg ascending when scanned right-to-left; for a
    # given error allowance find the smallest legal j via binary search over
    # the (descending suf_neg[cuts]) array
    cut_arr = np.asarray(cuts, np.int64)
    suf_at_cuts = suf_neg[cut_arr]          # non-increasing in cut position
    for i in cut_arr:
        errs_i = int(pre_pos[i])
        if errs_i > budget:
            break                            # pre_pos non-decreasing: done
        allow = budget - errs_i
        # smallest cut j >= i with suf_at_cuts <= allow
        pos = np.searchsorted(-suf_at_cuts, -allow, side="left")
        while pos < cut_arr.size and cut_arr[pos] < i:
            pos += 1
        if pos >= cut_arr.size:
            continue
        j = int(cut_arr[pos])
        kept = i + (n - j)
        if kept > best_kept:
            best_i, best_j, best_kept = int(i), j, kept
    i, j = best_i, best_j
    lo = float(-np.inf) if i == 0 else float((s[i - 1] + s[i]) / 2.0)
    hi = float(np.inf) if j == n else float((s[j - 1] + s[j]) / 2.0)
    errors = int(pre_pos[i]) + int(suf_neg[j])
    return CascadeThresholds(
        lo=lo, hi=hi,
        expected_escalation=(j - i) / n,
        expected_accuracy=1.0 - errors / n,
        sample_n=n,
    )
