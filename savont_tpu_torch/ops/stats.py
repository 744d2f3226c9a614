"""Statistical tests for SNPmer calling (utils.rs:37-49, kmer_comp.rs:546-615)."""
from __future__ import annotations

import numpy as np
from scipy.stats import binom


def binomial_test_gt(n: int | np.ndarray, k: int | np.ndarray, p: float):
    """P(X > k) for X ~ Binomial(n, p) — reference utils.rs:37-49.

    (statrs: 1 - cdf(k) = survival function at k, strictly-greater tail).
    Vectorized over n, k.
    """
    return binom.sf(k, n, p)


from functools import lru_cache

from scipy.special import gammaln as _gammaln


@lru_cache(maxsize=1)
def _lgamma_table(n: int) -> np.ndarray:
    return _gammaln(np.arange(n + 2, dtype=np.float64))


def fisher_two_tail(a: int, b: int, c: int, d: int) -> float:
    """Two-tailed Fisher exact p-value on table [[a, b], [c, d]].

    Exact hypergeometric enumeration (sum of all tables with probability <=
    observed, relative tolerance 1+1e-7) — the same definition as scipy /
    the fishers_exact crate, vectorized over the support.
    """
    r1, r2 = a + b, c + d
    c1 = a + c
    n = r1 + r2
    lg = _lgamma_table(max(n, 16))
    lo = max(0, c1 - r2)
    hi = min(c1, r1)
    x = np.arange(lo, hi + 1)
    # log pmf of hypergeom: C(r1,x) C(r2,c1-x) / C(n,c1)
    logp = (
        lg[r1 + 1] - lg[x + 1] - lg[r1 - x + 1]
        + lg[r2 + 1] - lg[c1 - x + 1] - lg[r2 - c1 + x + 1]
        - (lg[n + 1] - lg[c1 + 1] - lg[n - c1 + 1])
    )
    p = np.exp(logp)
    p_obs = p[a - lo]
    return float(p[p <= p_obs * (1.0 + 1e-7)].sum())


def snpmer_strand_test(counts_top: np.ndarray, counts_second: np.ndarray) -> tuple[float, float]:
    """Fisher strand-balance test after max/min folding (kmer_comp.rs:571-585).

    counts_* are [count_strand0, count_strand1] for the top and second
    variants.  Table = [max(a,c), max(b,d); min(c,a), min(d,b)] where
    a,c = top's strand counts and b,d = second's strand counts.
    Returns (two_tail_pvalue, odds_ratio) with odds=0.0 when any cell is 0.
    """
    a, c = int(counts_top[0]), int(counts_top[1])
    b, d = int(counts_second[0]), int(counts_second[1])
    t00, t01 = max(a, c), max(b, d)
    t10, t11 = min(c, a), min(d, b)
    p = fisher_two_tail(t00, t01, t10, t11)
    if t00 == 0 or t01 == 0 or t10 == 0 or t11 == 0:
        odds = 0.0
    else:
        odds = (t00 * t11) / (t01 * t10)
    return p, odds
