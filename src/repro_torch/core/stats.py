"""Statistical validation toolkit (paper Appendix B.3) — numpy only.

Bootstrap resampling, Welch's t-test, Friedman test, and Nemenyi post-hoc
analysis, with the special functions (regularized incomplete beta/gamma)
implemented from numerical recipes so no scipy dependency is needed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# special functions
# ---------------------------------------------------------------------------

def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta function."""
    MAXIT, EPS, FPMIN = 200, 3e-12, 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < EPS:
            break
    return h


def betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log(1.0 - x))
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def t_sf(t: float, df: float) -> float:
    """Survival function of Student's t (one-sided)."""
    x = df / (df + t * t)
    p = 0.5 * betainc(df / 2.0, 0.5, x)
    return p if t >= 0 else 1.0 - p


def gammainc_q(a: float, x: float) -> float:
    """Regularized upper incomplete gamma Q(a, x)."""
    if x < 0 or a <= 0:
        return 1.0
    if x == 0:
        return 1.0
    if x < a + 1.0:
        # series for P, return 1-P
        ap, s, d = a, 1.0 / a, 1.0 / a
        for _ in range(500):
            ap += 1.0
            d *= x / ap
            s += d
            if abs(d) < abs(s) * 3e-12:
                break
        p = s * math.exp(-x + a * math.log(x) - math.lgamma(a))
        return 1.0 - p
    # continued fraction for Q
    FPMIN = 1e-300
    b, c, d, h = x + 1.0 - a, 1.0 / FPMIN, 1.0 / (x + 1.0 - a), 1.0 / (x + 1.0 - a)
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < FPMIN:
            d = FPMIN
        c = b + an / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < 3e-12:
            break
    return h * math.exp(-x + a * math.log(x) - math.lgamma(a))


def norm_ppf(p: float) -> float:
    """Acklam's inverse normal CDF approximation."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def bootstrap_scores(correct: np.ndarray, n_boot: int = 100,
                     seed: int = 0) -> np.ndarray:
    """Paper B.3: accuracy distribution over bootstrap resamples."""
    rng = np.random.default_rng(seed)
    n = len(correct)
    idx = rng.integers(0, n, size=(n_boot, n))
    return correct[idx].mean(axis=1)


def welch_t_test(a: Sequence[float], b: Sequence[float]) -> Tuple[float, float]:
    """Welch's unequal-variance t-test; returns (t, two-sided p)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    na, nb = len(a), len(b)
    va, vb = a.var(ddof=1), b.var(ddof=1)
    se2 = va / na + vb / nb
    if se2 == 0:
        return 0.0, 1.0
    t = (a.mean() - b.mean()) / math.sqrt(se2)
    df = se2 ** 2 / ((va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1) + 1e-300)
    p = 2.0 * t_sf(abs(t), df)
    return float(t), float(min(1.0, p))


def friedman_test(scores: np.ndarray) -> Tuple[float, float]:
    """scores: [n_subjects, k_configs].  Returns (chi2, p)."""
    n, k = scores.shape
    ranks = scores.argsort(axis=1).argsort(axis=1) + 1.0
    # handle ties by average ranks
    for i in range(n):
        row = scores[i]
        order = np.argsort(row)
        r = np.empty(k)
        j = 0
        while j < k:
            j2 = j
            while j2 + 1 < k and row[order[j2 + 1]] == row[order[j]]:
                j2 += 1
            r[order[j:j2 + 1]] = (j + j2) / 2.0 + 1.0
            j = j2 + 1
        ranks[i] = r
    rbar = ranks.mean(axis=0)
    chi2 = 12.0 * n / (k * (k + 1)) * float(((rbar - (k + 1) / 2.0) ** 2).sum())
    p = gammainc_q((k - 1) / 2.0, chi2 / 2.0)
    return chi2, p


def nemenyi_critical_difference(k: int, n: int, alpha: float = 0.05) -> float:
    """CD = q_alpha * sqrt(k(k+1)/(12 n)).

    q_alpha (studentized range / sqrt(2), infinite df) approximated via a
    Bonferroni-style normal bound — accurate to a few percent for k<=40
    and conservative, which is the safe direction for claiming
    significance.
    """
    q = norm_ppf(1.0 - alpha / (k * (k - 1))) * math.sqrt(2.0)
    return q * math.sqrt(k * (k + 1) / (12.0 * n))


def nemenyi_significant_fraction(scores: np.ndarray, alpha: float = 0.05
                                 ) -> float:
    """Fraction of config pairs whose mean-rank gap exceeds the CD."""
    n, k = scores.shape
    ranks = np.empty_like(scores)
    for i in range(n):
        ranks[i] = scores[i].argsort().argsort() + 1.0
    rbar = ranks.mean(axis=0)
    cd = nemenyi_critical_difference(k, n, alpha)
    sig = total = 0
    for i in range(k):
        for j in range(i + 1, k):
            total += 1
            if abs(rbar[i] - rbar[j]) > cd:
                sig += 1
    return sig / max(total, 1)
