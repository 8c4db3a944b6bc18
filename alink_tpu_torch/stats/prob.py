"""Probability distributions: PDF / CDF / quantile (IDF) and random sampling
(a copy of ``alink_tpu.stats.prob``: numpy only, no device).

Capability parity with the reference's probabilistic package (reference:
core/src/main/java/com/alibaba/alink/common/probabilistic/CDF.java, PDF.java,
IDF.java, XRandom.java).

Re-design: instead of per-scalar Java methods, every function here is a
vectorized numpy ufunc built on regularized incomplete gamma/beta functions
(power series + Lentz continued fractions, the standard numerical recipes).
These run host-side — they parameterize statistics ops (chi-square tests,
scorecards) rather than sitting on the device hot path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CDF", "PDF", "IDF", "XRandom",
           "gammaln", "gammainc_p", "gammainc_q", "betainc", "erf", "erfc"]

_LANCZOS_G = 7.0
_LANCZOS_COEF = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def gammaln(x):
    """log|Gamma(x)| for x > 0 (Lanczos approximation, ~1e-13 accuracy)."""
    x = np.asarray(x, dtype=np.float64)
    z = x - 1.0
    s = np.full_like(z, _LANCZOS_COEF[0])
    for i in range(1, len(_LANCZOS_COEF)):
        s = s + _LANCZOS_COEF[i] / (z + i)
    t = z + _LANCZOS_G + 0.5
    return 0.5 * np.log(2.0 * np.pi) + (z + 0.5) * np.log(t) - t + np.log(s)


def _gser(a, x, itmax=200, eps=3e-14):
    """Lower incomplete gamma P(a,x) by series (best for x < a+1)."""
    ap = a.copy()
    total = 1.0 / a
    delta = total.copy()
    for _ in range(itmax):
        ap = ap + 1.0
        delta = delta * x / ap
        total = total + delta
        if np.all(np.abs(delta) < np.abs(total) * eps):
            break
    return total * np.exp(-x + a * np.log(np.maximum(x, 1e-300)) - gammaln(a))


def _gcf(a, x, itmax=300, eps=3e-14):
    """Upper incomplete gamma Q(a,x) by Lentz continued fraction (x >= a+1)."""
    tiny = 1e-300
    b = x + 1.0 - a
    c = np.full_like(x, 1.0 / tiny)
    d = 1.0 / np.maximum(b, tiny)
    h = d.copy()
    for i in range(1, itmax + 1):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < eps):
            break
    return h * np.exp(-x + a * np.log(np.maximum(x, 1e-300)) - gammaln(a))


def gammainc_p(a, x):
    """Regularized lower incomplete gamma P(a, x)."""
    a = np.asarray(a, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    a, x = np.broadcast_arrays(a, x)
    a = a.astype(np.float64).copy()
    x = x.astype(np.float64).copy()
    out = np.zeros_like(x)
    pos = x > 0
    series = pos & (x < a + 1.0)
    cf = pos & ~series
    if series.any():
        out[series] = _gser(a[series], x[series])
    if cf.any():
        out[cf] = 1.0 - _gcf(a[cf], x[cf])
    return np.clip(out, 0.0, 1.0)


def gammainc_q(a, x):
    """Regularized upper incomplete gamma Q(a, x) = 1 - P(a, x)."""
    return 1.0 - gammainc_p(a, x)


def _betacf(a, b, x, itmax=300, eps=3e-14):
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = np.ones_like(x)
    d = 1.0 - qab * x / qap
    d = np.where(np.abs(d) < tiny, tiny, d)
    d = 1.0 / d
    h = d.copy()
    for m in range(1, itmax + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < eps):
            break
    return h


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    a, b, x = np.broadcast_arrays(a, b, x)
    a = a.astype(np.float64).copy()
    b = b.astype(np.float64).copy()
    x = np.clip(x.astype(np.float64), 0.0, 1.0).copy()
    ln_front = (gammaln(a + b) - gammaln(a) - gammaln(b)
                + a * np.log(np.maximum(x, 1e-300))
                + b * np.log(np.maximum(1.0 - x, 1e-300)))
    front = np.exp(ln_front)
    direct = x < (a + 1.0) / (a + b + 2.0)
    out = np.empty_like(x)
    if direct.any():
        m = direct
        out[m] = front[m] * _betacf(a[m], b[m], x[m]) / a[m]
    if (~direct).any():
        m = ~direct
        out[m] = 1.0 - front[m] * _betacf(b[m], a[m], 1.0 - x[m]) / b[m]
    out = np.where(x <= 0.0, 0.0, np.where(x >= 1.0, 1.0, out))
    return np.clip(out, 0.0, 1.0)


def erf(x):
    x = np.asarray(x, dtype=np.float64)
    return np.sign(x) * gammainc_p(0.5, x * x)


def erfc(x):
    return 1.0 - erf(x)


def _ndtri(p):
    """Inverse standard normal CDF (Acklam approximation + Newton polish)."""
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    p_low, p_high = 0.02425, 1.0 - 0.02425
    x = np.empty_like(p)
    lo = p < p_low
    hi = p > p_high
    mid = ~(lo | hi)
    with np.errstate(divide="ignore", invalid="ignore"):
        if lo.any():
            q = np.sqrt(-2.0 * np.log(p[lo]))
            x[lo] = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5])
                     / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
        if hi.any():
            q = np.sqrt(-2.0 * np.log(1.0 - p[hi]))
            x[hi] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5])
                      / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
        if mid.any():
            q = p[mid] - 0.5
            r = q * q
            x[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
                      / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0))
    # one Newton step against the exact CDF
    e = 0.5 * erfc(-x / np.sqrt(2.0)) - p
    u = e * np.sqrt(2.0 * np.pi) * np.exp(x * x / 2.0)
    x = x - u / (1.0 + x * u / 2.0)
    x = np.where(p <= 0.0, -np.inf, np.where(p >= 1.0, np.inf, x))
    return x


def _ppf_by_bisect(cdf_fn, p, lo, hi, iters=200):
    """Generic quantile via bisection on a monotone CDF."""
    p = np.asarray(p, dtype=np.float64)
    lo = np.broadcast_to(np.asarray(lo, np.float64), p.shape).copy()
    hi = np.broadcast_to(np.asarray(hi, np.float64), p.shape).copy()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf_fn(mid) < p
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
        if np.all((hi - lo) < 1e-12 * np.maximum(1.0, np.abs(hi))):
            break
    return 0.5 * (lo + hi)


class CDF:
    """Cumulative distribution functions (reference: probabilistic/CDF.java)."""

    @staticmethod
    def normal(x, mu=0.0, sigma=1.0):
        z = (np.asarray(x, np.float64) - mu) / sigma
        return 0.5 * erfc(-z / np.sqrt(2.0))

    @staticmethod
    def std_normal(x):
        return CDF.normal(x)

    @staticmethod
    def chi2(x, df):
        x = np.asarray(x, np.float64)
        return np.where(x <= 0, 0.0, gammainc_p(df / 2.0, np.maximum(x, 0) / 2.0))

    @staticmethod
    def student_t(t, df):
        t = np.asarray(t, np.float64)
        ib = betainc(df / 2.0, 0.5, df / (df + t * t))
        return np.where(t > 0, 1.0 - 0.5 * ib, 0.5 * ib)

    @staticmethod
    def f(x, df1, df2):
        x = np.asarray(x, np.float64)
        pos = np.maximum(x, 0.0)
        return np.where(
            x <= 0, 0.0, betainc(df1 / 2.0, df2 / 2.0,
                                 df1 * pos / (df1 * pos + df2)))

    @staticmethod
    def gamma(x, shape, scale=1.0):
        x = np.asarray(x, np.float64)
        return np.where(x <= 0, 0.0, gammainc_p(shape, np.maximum(x, 0) / scale))

    @staticmethod
    def beta(x, a, b):
        return betainc(a, b, x)

    @staticmethod
    def exponential(x, rate=1.0):
        x = np.asarray(x, np.float64)
        return np.where(x <= 0, 0.0, 1.0 - np.exp(-rate * np.maximum(x, 0)))

    @staticmethod
    def uniform(x, lo=0.0, hi=1.0):
        return np.clip((np.asarray(x, np.float64) - lo) / (hi - lo), 0.0, 1.0)


class PDF:
    """Probability density functions (reference: probabilistic/PDF.java)."""

    @staticmethod
    def normal(x, mu=0.0, sigma=1.0):
        z = (np.asarray(x, np.float64) - mu) / sigma
        return np.exp(-0.5 * z * z) / (sigma * np.sqrt(2.0 * np.pi))

    @staticmethod
    def chi2(x, df):
        x = np.asarray(x, np.float64)
        k2 = df / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            logp = (k2 - 1.0) * np.log(x) - x / 2.0 - k2 * np.log(2.0) - gammaln(k2)
        return np.where(x <= 0, 0.0, np.exp(logp))

    @staticmethod
    def student_t(t, df):
        t = np.asarray(t, np.float64)
        logp = (gammaln((df + 1.0) / 2.0) - gammaln(df / 2.0)
                - 0.5 * np.log(df * np.pi)
                - (df + 1.0) / 2.0 * np.log1p(t * t / df))
        return np.exp(logp)

    @staticmethod
    def gamma(x, shape, scale=1.0):
        x = np.asarray(x, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            logp = ((shape - 1.0) * np.log(x) - x / scale
                    - shape * np.log(scale) - gammaln(shape))
        return np.where(x <= 0, 0.0, np.exp(logp))

    @staticmethod
    def beta(x, a, b):
        x = np.asarray(x, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            logp = ((a - 1.0) * np.log(x) + (b - 1.0) * np.log1p(-x)
                    + gammaln(a + b) - gammaln(a) - gammaln(b))
        return np.where((x <= 0) | (x >= 1), 0.0, np.exp(logp))

    @staticmethod
    def exponential(x, rate=1.0):
        x = np.asarray(x, np.float64)
        return np.where(x < 0, 0.0, rate * np.exp(-rate * x))

    @staticmethod
    def uniform(x, lo=0.0, hi=1.0):
        x = np.asarray(x, np.float64)
        return np.where((x >= lo) & (x <= hi), 1.0 / (hi - lo), 0.0)


class IDF:
    """Quantile functions / inverse CDFs (reference: probabilistic/IDF.java)."""

    @staticmethod
    def normal(p, mu=0.0, sigma=1.0):
        return mu + sigma * _ndtri(p)

    @staticmethod
    def std_normal(p):
        return _ndtri(p)

    @staticmethod
    def chi2(p, df):
        p = np.asarray(p, np.float64)
        hi = np.maximum(4.0 * df, 100.0) * np.ones_like(p)
        return _ppf_by_bisect(lambda x: CDF.chi2(x, df), p, 0.0, hi)

    @staticmethod
    def student_t(p, df):
        p = np.asarray(p, np.float64)
        return _ppf_by_bisect(lambda x: CDF.student_t(x, df), p, -1e8, 1e8)

    @staticmethod
    def f(p, df1, df2):
        p = np.asarray(p, np.float64)
        return _ppf_by_bisect(lambda x: CDF.f(x, df1, df2), p, 0.0, 1e8)

    @staticmethod
    def exponential(p, rate=1.0):
        return -np.log1p(-np.asarray(p, np.float64)) / rate

    @staticmethod
    def uniform(p, lo=0.0, hi=1.0):
        return lo + (hi - lo) * np.asarray(p, np.float64)


class XRandom:
    """Seedable sampler over the distributions above (reference:
    probabilistic/XRandom.java). Backed by numpy Generator."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def next_double(self, size=None):
        return self._rng.random(size)

    def normal(self, mu=0.0, sigma=1.0, size=None):
        return self._rng.normal(mu, sigma, size)

    def chi2(self, df, size=None):
        return self._rng.chisquare(df, size)

    def student_t(self, df, size=None):
        return self._rng.standard_t(df, size)

    def gamma(self, shape, scale=1.0, size=None):
        return self._rng.gamma(shape, scale, size)

    def beta(self, a, b, size=None):
        return self._rng.beta(a, b, size)

    def exponential(self, rate=1.0, size=None):
        return self._rng.exponential(1.0 / rate, size)

    def uniform(self, lo=0.0, hi=1.0, size=None):
        return self._rng.uniform(lo, hi, size)
