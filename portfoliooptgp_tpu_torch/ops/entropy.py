"""Ordinal-pattern entropy diagnostics, on the host.

Port of portfoliooptgp_tpu/ops/entropy.py, which is numpy and scipy and
stays so here: six one-shot measures of a short price series, printed by
`DataHandler.calculate_entropy` (order=3, classes=3, delay=1,
normalize=True), no device work.

- PE   permutation entropy (Bandt–Pompe): Shannon entropy of ordinal-pattern
       frequencies, normalized by log(order!).
- WPE  weighted PE: pattern frequencies weighted by each window's variance.
- RPE  reverse PE: squared distance to the uniform pattern distribution,
       Σp² − 1/n!, normalized by (1 − 1/n!).
- DE   dispersion entropy: windows of NCDF-mapped class symbols, Shannon
       entropy over the c^m dispersion patterns, normalized by log(c^m).
- RDE  reverse dispersion entropy: Σp² − 1/c^m over (1 − 1/c^m).
- RWDE reverse weighted dispersion entropy: RDE with variance-weighted
       pattern frequencies.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import norm


def _embed(x: np.ndarray, order: int, delay: int) -> np.ndarray:
    n = len(x) - (order - 1) * delay
    if n <= 0:
        raise ValueError("series too short for the requested order/delay")
    idx = np.arange(order) * delay + np.arange(n)[:, None]
    return x[idx]


def _pattern_ids(windows: np.ndarray) -> np.ndarray:
    """Lexicographic id of each window's ordinal (argsort) pattern."""
    order = windows.shape[1]
    ranks = np.argsort(np.argsort(windows, axis=1, kind="stable"), axis=1)
    base = order ** np.arange(order)
    return ranks @ base


def _shannon(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def PE(x, order=3, delay=1, normalize=True) -> float:
    ids = _pattern_ids(_embed(np.asarray(x, dtype=float), order, delay))
    _, counts = np.unique(ids, return_counts=True)
    h = _shannon(counts / counts.sum())
    return h / math.log2(math.factorial(order)) if normalize else h


def WPE(x, order=3, delay=1, normalize=True) -> float:
    w = _embed(np.asarray(x, dtype=float), order, delay)
    ids = _pattern_ids(w)
    weights = np.var(w, axis=1)
    tot = weights.sum()
    if tot == 0:
        return 0.0
    p = np.bincount(ids, weights=weights) / tot
    h = _shannon(p[p > 0])
    return h / math.log2(math.factorial(order)) if normalize else h


def RPE(x, order=3, delay=1, normalize=True) -> float:
    ids = _pattern_ids(_embed(np.asarray(x, dtype=float), order, delay))
    _, counts = np.unique(ids, return_counts=True)
    p = counts / counts.sum()
    n_pat = math.factorial(order)
    r = float((p**2).sum() - 1.0 / n_pat)
    return r / (1.0 - 1.0 / n_pat) if normalize else r


def _dispersion_ids(x: np.ndarray, order: int, classes: int, delay: int) -> np.ndarray:
    x = np.asarray(x, dtype=float)
    std = x.std()
    y = norm.cdf(x, loc=x.mean(), scale=std if std > 0 else 1.0)
    z = np.clip(np.round(classes * y + 0.5).astype(int), 1, classes)
    w = _embed(z, order, delay)
    base = classes ** np.arange(order)
    return (w - 1) @ base


def DE(x, order=3, classes=3, delay=1, normalize=True) -> float:
    ids = _dispersion_ids(x, order, classes, delay)
    _, counts = np.unique(ids, return_counts=True)
    h = _shannon(counts / counts.sum())
    return h / math.log2(classes**order) if normalize else h


def RDE(x, order=3, classes=3, delay=1, normalize=True) -> float:
    ids = _dispersion_ids(x, order, classes, delay)
    _, counts = np.unique(ids, return_counts=True)
    p = counts / counts.sum()
    n_pat = classes**order
    r = float((p**2).sum() - 1.0 / n_pat)
    return r / (1.0 - 1.0 / n_pat) if normalize else r


def RWDE(x, order=3, classes=3, delay=1, normalize=True) -> float:
    x = np.asarray(x, dtype=float)
    ids = _dispersion_ids(x, order, classes, delay)
    weights = np.var(_embed(x, order, delay), axis=1)
    tot = weights.sum()
    if tot == 0:
        return 0.0
    p = np.bincount(ids, weights=weights, minlength=classes**order) / tot
    n_pat = classes**order
    r = float((p**2).sum() - 1.0 / n_pat)
    return r / (1.0 - 1.0 / n_pat) if normalize else r


def all_measures(x, order=3, classes=3, delay=1, normalize=True) -> dict:
    """The six diagnostics in the order `calculate_entropy` prints them."""
    return {
        "DE": DE(x, order, classes, delay, normalize),
        "RDE": RDE(x, order, classes, delay, normalize),
        "RPE": RPE(x, order, delay, normalize),
        "PE": PE(x, order, delay, normalize),
        "WPE": WPE(x, order, delay, normalize),
        "RWDE": RWDE(x, order, classes, delay, normalize),
    }
