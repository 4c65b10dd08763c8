"""
Math and configuration utilities.

Provides the same utility surface as the reference's ``gpry/tools.py``
(dimension-scaling config DSL, chi-squared credible-region geometry, Gaussian
KL divergences, bounds handling), re-implemented for this build.
Host-side (NumPy) on purpose: these run in the outer driver loop, never
inside jitted code.

Reference parity: gpry/tools.py:20-440.
"""

import inspect
import numbers

import numpy as np
from scipy.special import erfc, gammaln
from scipy.stats import chi2

# ---------------------------------------------------------------------------
# chi-squared credible-region geometry (reference: gpry/tools.py:100-126)
# ---------------------------------------------------------------------------


def nstd_of_1d_nstd(n1, d):
    """
    Radius (in units of std) of the d-dimensional Gaussian hyper-volume that
    contains the same probability mass as the 1-dimensional ``n1``-sigma
    interval.
    """
    return float(np.sqrt(chi2.isf(erfc(n1 / np.sqrt(2)), d)))


def delta_logp_of_1d_nstd(n1, d):
    """
    Drop in log-probability from the peak of a d-dimensional Gaussian to the
    level enclosing the mass of the 1-d ``n1``-sigma interval.
    """
    return 0.5 * nstd_of_1d_nstd(n1, d) ** 2


def credibility_of_nstd(n, d):
    """Probability mass of a d-dim Gaussian within radius ``n`` std's."""
    return float(chi2.cdf(n**2, d))


def volume_sphere(r, dim=3):
    """Volume of a sphere of radius ``r`` in dimension ``dim``."""
    return float(np.exp(0.5 * dim * np.log(np.pi) - gammaln(dim / 2 + 1)
                        + dim * np.log(r)))


# ---------------------------------------------------------------------------
# Gaussian KL divergence (reference: gpry/tools.py:20-98)
# ---------------------------------------------------------------------------


def kl_norm(mean_0, cov_0, mean_1, cov_1):
    """KL divergence KL(N0 || N1) between two multivariate Gaussians."""
    mean_0, mean_1 = np.atleast_1d(mean_0), np.atleast_1d(mean_1)
    cov_0, cov_1 = np.atleast_2d(cov_0), np.atleast_2d(cov_1)
    d = len(mean_0)
    cov_1_inv = np.linalg.inv(cov_1)
    diff = mean_1 - mean_0
    _, logdet_0 = np.linalg.slogdet(cov_0)
    _, logdet_1 = np.linalg.slogdet(cov_1)
    return 0.5 * (
        np.trace(cov_1_inv @ cov_0) + diff @ cov_1_inv @ diff - d
        + logdet_1 - logdet_0
    )


def kl_mc(X, logq, weights=None, logp=None):
    """
    MC estimate of KL(p||q) from samples ``X`` of p (with optional weights)
    with ``logq`` the log-density of q at X and ``logp`` that of p.
    """
    logq = np.asarray(logq)
    if logp is None:
        raise ValueError("logp values needed for the MC KL estimate.")
    logp = np.asarray(logp)
    if weights is None:
        weights = np.ones(len(logq))
    weights = np.asarray(weights, dtype=float)
    weights = weights / weights.sum()
    return float(np.sum(weights * (logp - logq)))


def is_valid_covmat(covmat):
    """True if ``covmat`` is a finite positive-definite symmetric matrix."""
    if covmat is None:
        return False
    covmat = np.atleast_2d(covmat)
    if covmat.shape[0] != covmat.shape[1]:
        return False
    if not np.allclose(covmat, covmat.T):
        return False
    if not np.all(np.isfinite(covmat)):
        return False
    try:
        np.linalg.cholesky(covmat)
        return True
    except np.linalg.LinAlgError:
        return False


def gaussian_distance(points, mean, covmat):
    """Mahalanobis distance of each point to the Gaussian (mean, covmat)."""
    points = np.atleast_2d(points)
    diff = points - np.asarray(mean)
    inv = np.linalg.inv(np.atleast_2d(covmat))
    return np.sqrt(np.einsum("ij,jk,ik->i", diff, inv, diff))


def mean_covmat_from_samples(samples, weights=None):
    """Weighted mean and covariance from MC samples."""
    samples = np.atleast_2d(samples)
    if weights is None:
        weights = np.ones(len(samples))
    weights = np.asarray(weights, dtype=float)
    w = weights / weights.sum()
    mean = w @ samples
    diff = samples - mean
    # Bessel correction for weighted samples; with degenerate weights
    # (ESS -> 1, e.g. an NS sample collapsed onto one live point at large
    # d) it vanishes and the division sprays inf/nan into every consumer
    # (observed live at d=20) — fall back to the biased estimator, which
    # is finite (~0 covariance) and correctly read as invalid/degenerate
    # by is_valid_covmat-guarded callers.
    denom = 1.0 - float(np.sum(w**2))
    if not denom > 1e-12:
        denom = 1.0
    cov = (diff * w[:, None]).T @ diff / denom
    return mean, cov


def mean_covmat_from_evals(X, y):
    """
    Mean and covariance estimated from log-density evaluations: the points
    are weighted by their (normalized) probability exp(y - max y).
    """
    X = np.atleast_2d(X)
    y = np.asarray(y, dtype=float)
    w = np.exp(y - np.max(y[np.isfinite(y)]))
    w[~np.isfinite(y)] = 0.0
    return mean_covmat_from_samples(X, w)


def remove_0_weight_samples(weights, *arrays):
    """Drop entries with zero weight from ``weights`` and companion arrays."""
    keep = np.asarray(weights) > 0
    out = [np.asarray(weights)[keep]]
    for a in arrays:
        out.append(np.asarray(a)[keep])
    return tuple(out)


# ---------------------------------------------------------------------------
# Dimension-scaling config DSL (reference: gpry/tools.py:185-234)
# ---------------------------------------------------------------------------
# Option values like "3d" (3*d), "30d1.5" (30*d**1.5) or "20s" (20 sigma-units
# converted through chi2 geometry) scale with the problem dimensionality.


def get_Xnumber(value, X_letter, X_value=None, dtype=int, varname=None):
    """
    Parse an X-number such as ``"5d"`` = 5 times ``X_value``, or ``"5d2"`` =
    5 times ``X_value**2``.  If ``X_value`` is None, returns the tuple
    ``(value, has_X, X_power)`` without applying the multiplier.
    """
    not_allowed = [" ", ".", "-", "+", "e", "E", ",", ";"]
    if X_letter in not_allowed:
        raise ValueError(f"X_letter not allowed: '{X_letter}'.")
    if value == X_letter:
        value = "1" + X_letter
    if isinstance(value, str) and X_letter in value:
        has_X = True
        num_str, pow_str = value.split(X_letter)
        num_value = float(num_str) if num_str else 1.0
        X_power = float(pow_str) if pow_str else None
    else:
        has_X = False
        num_value = value
        X_power = None
    try:
        num_value = float(num_value)
        if X_value is None:
            return dtype(num_value), has_X, X_power
        if has_X:
            mult = X_value ** X_power if X_power is not None else X_value
        else:
            mult = 1
        return dtype(num_value * mult)
    except (ValueError, TypeError) as excpt:
        pre = f"Error setting variable '{varname}': " if varname else ""
        raise ValueError(
            pre + f"Could not convert {value!r} into {dtype.__name__}."
        ) from excpt


def parse_sigma_units(value, d, varname=None):
    """
    Parse a threshold that may be given in 1-d sigma units (e.g. ``"20s"``),
    converting through the d-dimensional chi2 geometry, or as a plain number.
    """
    val, is_sigma, power = get_Xnumber(value, "s", None, dtype=float,
                                       varname=varname)
    if power is not None:
        raise ValueError("Power for sigma units not supported.")
    if is_sigma:
        return delta_logp_of_1d_nstd(val, d)
    return val


# ---------------------------------------------------------------------------
# Bounds utilities (reference: gpry/tools.py:237-360)
# ---------------------------------------------------------------------------


def check_and_return_bounds(bounds):
    """Validate bounds and return them as an (d, 2) float array."""
    bounds = np.ascontiguousarray(np.atleast_2d(bounds), dtype=float)
    if bounds.ndim != 2 or bounds.shape[1] != 2:
        raise ValueError(f"Bounds must have shape (d, 2). Got {bounds.shape}")
    if not np.all(bounds[:, 0] < bounds[:, 1]):
        raise ValueError("Lower bounds must be smaller than upper bounds. "
                         f"Got {bounds}")
    return bounds


def is_in_bounds(X, bounds, check_shape=False):
    """Boolean array: which rows of X fall inside the bounds box."""
    X = np.atleast_2d(X)
    bounds = np.asarray(bounds)
    if check_shape and X.shape[1] != bounds.shape[0]:
        raise ValueError("X and bounds dimensions do not match.")
    return np.all((X >= bounds[:, 0]) & (X <= bounds[:, 1]), axis=1)


def check_candidates(X_train, candidates, tol=1e-8):
    """
    For each candidate, whether it duplicates a training point or an earlier
    candidate (within relative tolerance ``tol``), as a boolean mask of
    "is duplicate".
    """
    candidates = np.atleast_2d(candidates)
    if candidates.size == 0:
        # empty batch (e.g. a starved acquisition): nothing to dedupe
        return np.zeros(len(candidates), dtype=bool)
    X_train = np.atleast_2d(X_train) if len(np.atleast_1d(X_train)) else None
    dup = np.zeros(len(candidates), dtype=bool)
    scale = np.maximum(np.max(np.abs(candidates), axis=0), 1.0)
    for i, c in enumerate(candidates):
        if X_train is not None and len(X_train):
            if np.any(np.all(np.abs(X_train - c) <= tol * scale, axis=1)):
                dup[i] = True
                continue
        if i > 0:
            prev = candidates[:i]
            if np.any(np.all(np.abs(prev - c) <= tol * scale, axis=1)):
                dup[i] = True
    return dup


def shrink_bounds(bounds, X, y, factor=3.0, nstd=None):
    """
    Trust-region helper: shrink ``bounds`` around the region supported by
    training points with high posterior values.  The new bounds are the
    bounding box of the selected points, inflated by ``factor`` times the
    per-dimension extent, intersected with the original bounds.
    """
    bounds = check_and_return_bounds(bounds)
    X = np.atleast_2d(X)
    y = np.asarray(y, dtype=float)
    finite = np.isfinite(y)
    if not np.any(finite):
        return bounds
    Xf, yf = X[finite], y[finite]
    if nstd is not None:
        d = bounds.shape[0]
        cut = np.max(yf) - delta_logp_of_1d_nstd(nstd, d)
        sel = yf >= cut
        if np.sum(sel) >= 2:
            Xf = Xf[sel]
    lo, hi = Xf.min(axis=0), Xf.max(axis=0)
    center, half = (lo + hi) / 2, (hi - lo) / 2
    half = np.maximum(half * factor, 1e-10)
    new = np.stack([center - half, center + half], axis=1)
    new[:, 0] = np.maximum(new[:, 0], bounds[:, 0])
    new[:, 1] = np.minimum(new[:, 1], bounds[:, 1])
    return new


def generic_params_names(n, prefix="x_"):
    """``n`` generic 1-based parameter names: x_1, x_2, ..."""
    if not (isinstance(n, numbers.Number) and n == int(n) and n > 0):
        raise TypeError(f"'n' must be a positive integer. Got {n!r}.")
    if not isinstance(prefix, str):
        raise TypeError(f"'prefix' must be a string. Got {prefix!r}.")
    return [prefix + str(i + 1) for i in range(int(n))]


def wrap_likelihood(loglike, param_names):
    """
    Adapt a user log-likelihood to a uniform array signature ``f(X_row)``.

    Accepts functions taking a single array argument or one scalar argument
    per parameter (matched by arity, like the reference's
    ``tools.wrap_likelihood``, gpry/tools.py:363-397).
    """
    try:
        sig = inspect.signature(loglike)
        n_args = len([p for p in sig.parameters.values()
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)])
    except (TypeError, ValueError):
        n_args = 1
    if n_args == len(param_names) and n_args > 1:
        return lambda x: loglike(*np.asarray(x))
    return lambda x: loglike(np.asarray(x))
