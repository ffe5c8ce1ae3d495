"""Host-side metrics: censored concordance index and binary AUROC (the
port's own copy of `paths_tpu.train.metrics`, numpy only).

The reference delegates to `sksurv.metrics.concordance_index_censored`
(`eval.py:3,66-77`) and `torcheval.metrics.BinaryAUROC` (`eval.py:87-117`);
neither ships native here, so both are implemented from their definitions:

* c-index (Harrell): comparable pairs are (i, j) with event_i and
  (t_j > t_i, or t_j == t_i with j censored); a pair is concordant when
  the earlier event carries the higher risk estimate; tied estimates
  count 0.5. Matches sksurv's `_estimate_concordance_index` semantics.
* AUROC: tie-averaged Mann-Whitney rank statistic, equal to the
  trapezoidal ROC integral torcheval computes.
"""
from __future__ import annotations

import numpy as np


class NoComparablePairs(ValueError):
    pass


def concordance_index_censored(event_indicator: np.ndarray,
                               event_time: np.ndarray,
                               estimate: np.ndarray):
    """Censored concordance index.

    :param event_indicator: (n,) bool — True when the event occurred
        (note: the reference passes `1 - censorship`, `eval.py:70`)
    :param event_time: (n,) observed times
    :param estimate: (n,) risk scores (higher = shorter expected survival)
    :return: (cindex, concordant, discordant, tied_risk, tied_time)
    """
    e = np.asarray(event_indicator, bool)
    t = np.asarray(event_time, np.float64)
    s = np.asarray(estimate, np.float64)
    if not (e.shape == t.shape == s.shape and e.ndim == 1):
        raise ValueError(f"want three (n,) arrays, got {e.shape}, {t.shape}, "
                         f"{s.shape}")
    n = t.size

    # pair matrices are built per row-chunk so peak memory is
    # O(chunk * n), not O(n^2) — a combined-cohort eval (n ~ 10^4+)
    # stays a few MB instead of gigabytes
    chunk = max(1, min(n, 4096 * 1024 // max(n, 1)))
    comparable = concordant = tied_risk = tied_time2 = 0
    for a in range(0, n, chunk):
        bsl = slice(a, min(a + chunk, n))
        ti, ei, si = t[bsl, None], e[bsl, None], s[bsl, None]
        comp = ei & ((t[None, :] > ti) | ((t[None, :] == ti) & ~e[None, :]))
        rows = np.arange(a, bsl.stop)
        comp[rows - a, rows] = False  # no self-pairs
        comparable += int(comp.sum())
        concordant += int((comp & (s[None, :] < si)).sum())
        tied_risk += int((comp & (s[None, :] == si)).sum())
        tied_time2 += int(((t[None, :] == ti) & ei & e[None, :]).sum())

    if comparable == 0:
        raise NoComparablePairs("Data has no comparable pairs")
    discordant = comparable - concordant - tied_risk
    tied_time = (tied_time2 - int(e.sum())) // 2  # minus diagonal, halved

    cindex = (concordant + 0.5 * tied_risk) / comparable
    return cindex, concordant, discordant, tied_risk, tied_time


def survival_risk(hazards: np.ndarray) -> np.ndarray:
    """Risk score from per-bin hazards: -sum of the survival curve
    cumprod(1 - h) over bins (reference `eval.py:59-64`). Accepts (nbins,)
    or (B, nbins); reduces the last axis."""
    h = np.asarray(hazards, np.float64)
    return -np.cumprod(1.0 - h, axis=-1).sum(axis=-1)


def class_probs(logits: np.ndarray) -> np.ndarray:
    """Stable softmax over the last axis (reference applies
    torch.softmax before per-class AUROC, `eval.py:104-117`)."""
    x = np.asarray(logits, np.float64)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Tie-averaged binary AUROC. Returns 0.0 for degenerate inputs with a
    single class (torcheval returns nan-ish values there; the reference
    only hits this when a subtype is absent from a split)."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels).astype(bool)
    npos = int(y.sum())
    nneg = y.size - npos
    if npos == 0 or nneg == 0:
        return 0.0

    # tie-averaged 1-based ranks, fully vectorized: np.unique sorts, so
    # each unique value's rank block starts at the cumulative count of
    # smaller values and averages to start + (count + 1) / 2
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    ranks = (starts + (counts + 1) / 2.0)[inv]

    auc = (ranks[y].sum() - npos * (npos + 1) / 2.0) / (npos * nneg)
    return float(auc)
