"""
The GP surrogate model.

Reference behavior: gpry/gpr.py (GaussianProcessRegressor, 1488 LoC), rebuilt
in JAX instead of subclassing scikit-learn:

* The GP state lives on device as a **pytree of fixed-shape padded arrays**
  (``SurrogateParams``) so every operation — prediction, acquisition sweeps,
  LML fits — is a single jitted computation, compiled once per buffer bucket.
* Appending data uses an **incremental block-Cholesky update**
  (ops.linalg.chol_append) instead of the reference's from-scratch
  refactorization (gpry/gpr.py:996-1020).
* Hyperparameter fitting is a **vmapped multi-start bounded L-BFGS** on the
  autodiff log-marginal-likelihood (replacing scipy L-BFGS-B restarts split
  over MPI ranks, gpry/gpr.py:883-994 + gpry/run.py:1238-1301).
* The infinities classifier (SVM), preprocessing, trust region, and upper
  clipping reproduce the reference's prediction semantics
  (gpry/gpr.py:1022-1265).

The host-facing class keeps the reference's API (``append_to_data``,
``fit_gpr_hyperparameters``, ``predict``, ``predict_std``, properties); the
pure functions (``surrogate_predict`` etc.) are the jit surface used by the
acquisition engines and samplers.
"""

import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from gpry_tpu import config
from gpry_tpu.models.classifier import SVM, SVMParams, svm_decision, \
    trivial_svm_params
from gpry_tpu.models.preprocessing import DummyPreprocessor
from gpry_tpu.ops.kernels import make_theta, theta_bounds_dynamic
from gpry_tpu.ops.lbfgs import minimize_lbfgs_bounded
from gpry_tpu.ops.linalg import chol_append, factorize, masked_lml, \
    predict_meanvar
from gpry_tpu.utils.tools import check_and_return_bounds, \
    delta_logp_of_1d_nstd, get_Xnumber, shrink_bounds

_KERNEL_ALIASES = {
    "rbf": "rbf",
    "matern": "matern32",   # reference default nu=1.5 when "Matern" is given
    "matern12": "matern12",
    "matern32": "matern32",
    "matern52": "matern52",
}
_NU_TO_FAMILY = {0.5: "matern12", 1.5: "matern32", 2.5: "matern52"}


class SurrogateParams(NamedTuple):
    """
    Complete jit-friendly snapshot of a fitted surrogate: GP factorization,
    affine pre/post-processing, classifier, clipping and trust region.
    All "raw" quantities are in user coordinates; the GP core operates in
    preprocessed coordinates.
    """
    theta: jnp.ndarray      # (1 + d,) log kernel hyperparameters
    X: jnp.ndarray          # (nmax, d) transformed training inputs (padded)
    y: jnp.ndarray          # (nmax,)  transformed targets (padded)
    n: jnp.ndarray          # () int32 number of valid rows
    noise_var: jnp.ndarray  # () transformed-space noise variance (diag)
    L: jnp.ndarray          # (nmax, nmax) padded Cholesky factor
    alpha: jnp.ndarray      # (nmax,) K^-1 y (padded zeros)
    x_loc: jnp.ndarray      # (d,) raw -> transformed: (x - x_loc) / x_scale
    x_scale: jnp.ndarray    # (d,)
    y_loc: jnp.ndarray      # () transformed -> raw: y*y_scale + y_loc
    y_scale: jnp.ndarray    # ()
    y_max: jnp.ndarray      # () max raw training target (acquisition baseline)
    clip_max: jnp.ndarray   # () raw-space upper clip (+inf = disabled)
    svm: SVMParams
    trust_lo: jnp.ndarray   # (d,) raw trust-region bounds (-inf = none)
    trust_hi: jnp.ndarray   # (d,)


# ---------------------------------------------------------------------------
# Pure prediction functions (the jit surface)
# ---------------------------------------------------------------------------


def surrogate_mean_std_smooth(family, p: SurrogateParams, Xq_raw):
    """
    Raw-space posterior mean and std WITHOUT classifier/trust/clip gates:
    the smooth, differentiable part used inside gradient-based acquisition
    optimization (gates are applied to values, not gradients, as in the
    reference's analytic-gradient path, gpry/gpr.py:1236-1265).
    """
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    mean_, var_ = predict_meanvar(
        family, p.theta, p.X, p.n, p.noise_var, p.L, p.alpha, Xq_)
    mean = mean_ * p.y_scale + p.y_loc
    std = jnp.sqrt(var_) * p.y_scale
    return mean, std


@partial(jax.jit, static_argnames=("family",))
def surrogate_predict(family, p: SurrogateParams, Xq_raw):
    """
    Gated raw-space prediction, matching ``GaussianProcessRegressor.predict``
    semantics (gpry/gpr.py:1022-1230): -inf mean / 0 std outside the trust
    region or where the classifier predicts infinite; upper-clipped mean.
    Returns (mean, std).
    """
    mean, std = surrogate_mean_std_smooth(family, p, Xq_raw)
    mean = jnp.minimum(mean, p.clip_max)
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    finite = svm_decision(p.svm, Xq_)
    in_trust = jnp.all((Xq_raw >= p.trust_lo) & (Xq_raw <= p.trust_hi),
                       axis=-1)
    ok = finite & in_trust
    minus_inf = jnp.asarray(-jnp.inf, mean.dtype)
    mean = jnp.where(ok, mean, minus_inf)
    std = jnp.where(ok, std, 0.0)
    return mean, std


@partial(jax.jit, static_argnames=("family",))
def surrogate_predict_mean(family, p: SurrogateParams, Xq_raw):
    """
    Gated mean only — the NS/MCMC log-density target.  Skips the
    triangular solve entirely (sigma is never used there).
    """
    from gpry_tpu.ops.linalg import predict_mean
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    mean = predict_mean(family, p.theta, p.X, p.n, p.alpha, Xq_) \
        * p.y_scale + p.y_loc
    mean = jnp.minimum(mean, p.clip_max)
    finite = svm_decision(p.svm, Xq_)
    in_trust = jnp.all((Xq_raw >= p.trust_lo) & (Xq_raw <= p.trust_hi),
                       axis=-1)
    return jnp.where(finite & in_trust, mean,
                     jnp.asarray(-jnp.inf, mean.dtype))


def ns_proposal_params(p: SurrogateParams, err_est=0.0):
    """
    ``(p_ns, corrected)`` for the nested-sampling loop: when
    ``config.NS_PROPOSAL_F32`` is "force", ``p`` is float64, AND the f32
    distortion estimate ``err_est`` (raw nats, from
    ``f32_sweep_error_estimate``) is below ``config.NS_PROPOSAL_F32_TOL``,
    the NS runs on a float32 snapshot —
    it only *proposes* sample locations; the caller re-scores the final
    sample with one batched float64 sweep and folds the density
    difference into the weights (importance correction, the same
    mechanism as sample reuse across GP updates).  Beyond the tolerance
    the f32 surface misplaces the proposal mass and the correction
    collapses the effective sample size, so f64 is kept.
    ``corrected=True`` signals that re-scoring is required.
    """
    if (str(config.NS_PROPOSAL_F32) != "force"
            or p.X.dtype != jnp.float64
            or float(err_est) >= config.NS_PROPOSAL_F32_TOL):
        return p, False
    return cast_surrogate(p, jnp.float32), True


def cast_surrogate(p: SurrogateParams, dtype):
    """
    Cast a surrogate snapshot to another float dtype (int fields kept).
    Used to run bulk sweeps (NS, acquisition ranking) in float32 when
    asked for; the fit/factorization stays float64.
    """
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, p)


# Restart counts are padded up to a multiple of this so the vmapped solves
# compile for a small set of widths.
LBFGS_CHUNK = 8


@partial(jax.jit, static_argnames=("family",))
def _lml_batch(family, X, y, n, noise_var, thetas):
    """Vmapped LML sweep (restart screening)."""
    return jax.vmap(
        lambda t: masked_lml(family, t, X, y, n, noise_var)
    )(thetas)


def _lml_batch_chunked(family, X, y, n, noise_var, thetas, on_chunk=None):
    """
    Memory-budgeted LML sweep: each vmapped lane materializes O(nmax^2)
    triangular-solve temps, so a dense screen (2048+ thetas) over a large
    padded buffer outgrows device memory (a [2055, 1152, 1152] screen
    wants tens of GB).  Chunks are host-driven slices of one fixed width
    (last chunk padded), so each bucket size compiles exactly one program.
    Budget: ``lml_screen_budget_bytes`` of the device holding ``X``.
    """
    nmax = int(X.shape[0])
    n_theta = int(thetas.shape[0])
    itemsize = jnp.dtype(X.dtype).itemsize
    budget = lml_screen_budget_bytes(X)
    # ~3 nmax^2 temps live per lane (K, cho factor, solve scratch)
    per_lane = 3 * nmax * nmax * itemsize
    chunk = int(budget // max(per_lane, 1))
    if chunk >= n_theta:
        return _lml_batch(family, X, y, n, noise_var, thetas)
    chunk = max(8, 1 << (max(chunk, 1).bit_length() - 1))  # pow2, >= 8
    out = []
    for i in range(0, n_theta, chunk):
        t = thetas[i:i + chunk]
        pad = chunk - t.shape[0]
        if pad:
            t = jnp.concatenate([t, jnp.broadcast_to(t[-1:],
                                                     (pad,) + t.shape[1:])])
        lml = _lml_batch(family, X, y, n, noise_var, t)
        out.append(lml[:chunk - pad] if pad else lml)
        if on_chunk is not None:
            jax.block_until_ready(out[-1])
            on_chunk()      # liveness tick for hang watchdogs
    return jnp.concatenate(out)


def lml_screen_budget_bytes(X):
    """
    Device-memory budget of one LML-screen chunk: a quarter of the memory
    JAX may use on the device holding ``X`` (``memory_stats()["bytes_limit"]``),
    or ``GPRY_TPU_LML_SCREEN_MEM_GB`` (default 4) GiB where the device
    reports no memory statistics (the CPU).
    """
    import os
    stats = next(iter(X.devices())).memory_stats()
    if stats and stats.get("bytes_limit"):
        return stats["bytes_limit"] / 4
    return float(os.environ.get("GPRY_TPU_LML_SCREEN_MEM_GB", 4)) * 2**30


# jitted multi-restart hyperparameter fit
@partial(jax.jit, static_argnames=("family", "maxiter"))
def _fit_theta_restarts(family, X, y, n, noise_var, theta0s, lo, hi,
                        maxiter=200):
    # Gradient-norm tolerance matched to the dtype: tighter tolerances are
    # unreachable in float32 and every restart would burn all `maxiter`
    # iterations chasing rounding noise.
    tol = 1e-8 if theta0s.dtype == jnp.float64 else 1e-3

    def nll(theta):
        return -masked_lml(family, theta, X, y, n, noise_var)

    solve = lambda t0: minimize_lbfgs_bounded(
        nll, t0, lo, hi, maxiter=maxiter, tol=tol, count_evals=True)
    return jax.vmap(solve)(theta0s)


class GaussianProcessRegressor:
    """
    Drop-in equivalent of the reference's GPR (gpry/gpr.py:27) with a
    JAX core.  Constructor arguments and defaults follow
    gpry/gpr.py:265-271.
    """

    # class-level fallbacks so checkpoints pickled before these attributes
    # existed resume with the documented defaults
    demand_fit_min_n = 160
    n_fits_skipped = 0
    n_fits_downgraded = 0

    def __init__(self, kernel="RBF", output_scale_prior=(1e-2, 1e3),
                 length_scale_prior=(1e-3, 1e1), noise_level=1e-2,
                 clip_factor=1.1, optimizer="lbfgs", n_restarts_optimizer=0,
                 preprocessing_X=None, preprocessing_y=None,
                 account_for_inf="SVM", inf_threshold="20s",
                 keep_min_finite=None, trust_region_factor=None,
                 trust_region_nstd=None, bounds=None, random_state=None,
                 demand_fit_min_n=160, verbose=1):
        if bounds is None:
            raise ValueError("'bounds' are required (auto-built kernels and "
                             "the infinities threshold depend on them).")
        self.bounds = check_and_return_bounds(bounds)
        self.verbose = verbose
        if np.iterable(noise_level):
            raise ValueError(
                "Pass a scalar default noise_level at init; per-point "
                "noise goes through append_to_data(noise_level=...).")
        self.noise_level_default = float(noise_level)
        # raw noise std per appended point (in y_train_all order)
        self.noise_level_all = np.empty((0,))
        self._has_custom_noise = False
        if clip_factor is not None and clip_factor < 1:
            raise ValueError("'clip_factor' must be >= 1, or None.")
        self.clip_factor = clip_factor
        self.optimizer = optimizer
        self.n_restarts_optimizer = n_restarts_optimizer
        self.preprocessing_X = preprocessing_X or DummyPreprocessor
        self.preprocessing_y = preprocessing_y or DummyPreprocessor
        self.inf_value = np.inf
        self.minus_inf_value = -np.inf
        self.trust_region_factor = trust_region_factor
        self.trust_region_nstd = trust_region_nstd
        self.trust_bounds = None
        self._rng = np.random.default_rng(random_state)
        self.n_eval = 0
        self.n_eval_loglike = 0
        # Demand-driven fit frequency: once n >= demand_fit_min_n, the
        # incumbent theta is priced as one extra row of the batched LML
        # screen every fit.  If no screened candidate beats it, the LML's
        # global basin has not moved and the O(maxiter * lanes * n^3)
        # L-BFGS polish ladder is demand-managed: a "simple" fit skips the
        # polish entirely (factorize-only iteration), and a scheduled FULL
        # fit downgrades from the LBFGS_CHUNK-lane ladder to a 2-lane
        # within-basin repolish (incumbent + best screened candidate) —
        # the drift polish the full-fit schedule exists for, at a fraction
        # of its cost.  A basin jump found by the screen always runs the
        # full ladder.  The reference handles the same large-n cost by
        # scheduling full fits sparsely (gpry/run.py:536-537) with no
        # basin-jump safety net.  None disables both reductions.
        self.demand_fit_min_n = demand_fit_min_n
        self.n_fits_skipped = 0
        self.n_fits_downgraded = 0

        # --- infinities classifier -------------------------------------------
        self.inf_threshold = inf_threshold
        self.keep_min_finite = (keep_min_finite if keep_min_finite is not None
                                else max(2, self.d))
        if isinstance(account_for_inf, str) and \
                account_for_inf.lower() == "svm":
            self.infinities_classifier = SVM(random_state=random_state)
        elif account_for_inf is False or account_for_inf is None:
            self.infinities_classifier = None
        else:
            self.infinities_classifier = account_for_inf
        if self.infinities_classifier is not None:
            if self.inf_threshold is None:
                raise ValueError("Specify 'inf_threshold' when using an "
                                 "infinities classifier.")
            value, is_sigma, power = get_Xnumber(
                self.inf_threshold, "s", None, dtype=float,
                varname="inf_threshold")
            if power is not None:
                raise ValueError("Power for sigma units not supported.")
            self._diff_threshold = (
                delta_logp_of_1d_nstd(value, self.d) if is_sigma else value)
        else:
            self._diff_threshold = np.inf

        # --- kernel -----------------------------------------------------------
        self.output_scale_prior = tuple(output_scale_prior)
        self.length_scale_prior = tuple(length_scale_prior)
        if isinstance(kernel, str):
            kernel = {kernel: {}}
        if not isinstance(kernel, dict) or len(kernel) != 1:
            raise ValueError("'kernel' must be a name or single-key dict.")
        kname = list(kernel)[0]
        kargs = kernel[kname] or {}
        fam = _KERNEL_ALIASES.get(kname.lower())
        self._theta_bounds_spec = None
        _fast_keys = {"nu", "length_scale"}
        if fam is not None and isinstance(kargs, dict) and \
                not (set(kargs) - _fast_keys):
            # Fast path: the reference's auto-built C() * RBF|Matern with
            # ARD length scales (gpry/gpr.py:328-363).
            kargs = dict(kargs)
            if "nu" in kargs:
                try:
                    fam = _NU_TO_FAMILY[float(kargs.pop("nu"))]
                except KeyError as excpt:
                    raise ValueError(
                        "Matern nu must be one of 0.5, 1.5, 2.5.") from excpt
            self.family = fam
            # Initial hyperparameters at the geometric mean of the priors
            # (reference: gpry/gpr.py:352-363), in preprocessed coordinates.
            out0 = float(np.sqrt(
                output_scale_prior[0] * output_scale_prior[1]))
            ls0 = kargs.pop("length_scale", None)
            if ls0 is None:
                ls0 = [float(np.sqrt(
                    length_scale_prior[0] * length_scale_prior[1]))] * self.d
            elif np.isscalar(ls0):
                ls0 = [float(ls0)] * self.d
            self._theta = np.asarray(make_theta(out0, ls0))
        else:
            # Extended kernel library: any sklearn-style kernel expression
            # (RationalQuadratic, ExpSineSquared, DotProduct, WhiteKernel,
            # ConstantKernel + Sum/Product/Exponentiation — reference
            # gpry/kernels.py:435-702) compiled to a hashable spec tree.
            from gpry_tpu.ops.kernels import build_kernel_spec
            spec, theta0, bounds = build_kernel_spec(kernel, self.d)
            self.family = spec
            self._theta = np.asarray(theta0)
            self._theta_bounds_spec = np.asarray(bounds)
        self.bounds_ = self.preprocessing_X.transform_bounds(self.bounds) \
            if hasattr(self.preprocessing_X, "transform_bounds") \
            else self.bounds

        # --- training data ---------------------------------------------------
        self.X_train_all = np.empty((0, self.d))
        self.y_train_all = np.empty((0,))
        self.X_train = np.empty((0, self.d))
        self.y_train = np.empty((0,))
        self.n_last_appended = 0
        self.n_last_appended_finite = 0
        self._fitted = False
        self.log_marginal_likelihood_value_ = None

        # --- device state ------------------------------------------------------
        self._dtype = config.FIT_DTYPE
        self._nmax = 0
        self._dX = None      # (nmax, d) transformed
        self._dy = None      # (nmax,)
        self._dL = None
        self._dalpha = None
        self._noise_var_ = None  # transformed-space noise variance

    # ------------------------------------------------------------------ props

    @property
    def d(self):
        return self.bounds.shape[0]

    @property
    def n(self):
        return len(self.y_train)

    @property
    def n_finite(self):
        return self.n

    @property
    def n_total(self):
        return len(self.y_train_all)

    @property
    def y_max(self):
        if len(self.y_train) == 0:
            return self.minus_inf_value
        return np.max(self.y_train)

    @property
    def fitted(self):
        return self._fitted

    @property
    def noise_level(self):
        """Raw-space noise std: scalar default, or the per-point array when
        custom per-append noise was given (reference: gpry/gpr.py:625-680)."""
        if self._has_custom_noise:
            return self.noise_level_all
        return self.noise_level_default

    @property
    def X_train_infinite(self):
        if self.infinities_classifier is None:
            return np.empty((0, self.d))
        finite = self._is_finite_all()
        return self.X_train_all[~finite]

    @property
    def y_train_infinite(self):
        if self.infinities_classifier is None:
            return np.empty((0,))
        finite = self._is_finite_all()
        return self.y_train_all[~finite]

    @property
    def last_appended(self):
        n = self.n_last_appended
        return (np.copy(self.X_train_all[len(self.X_train_all) - n:]),
                np.copy(self.y_train_all[len(self.y_train_all) - n:]))

    @property
    def last_appended_finite(self):
        n = self.n_last_appended_finite
        return (np.copy(self.X_train[len(self.X_train) - n:]),
                np.copy(self.y_train[len(self.y_train) - n:]))

    @property
    def abs_finite_threshold(self):
        if self.infinities_classifier is None:
            return -np.inf
        return self.y_max - self._diff_threshold_keep_n()

    @property
    def kernel_theta(self):
        """Current log-hyperparameters [log outputscale^2, log ls_1...d]."""
        return np.asarray(self._theta)

    @property
    def scales(self):
        """(output_scale, length_scales) in raw coordinates.
        Only defined for the auto-built C()*RBF/Matern kernels."""
        if isinstance(self.family, tuple):
            raise ValueError(
                "'scales' is only defined for the auto-built C()*RBF/Matern"
                " kernels; inspect 'kernel_theta' for extended kernels.")
        out = float(np.exp(0.5 * self._theta[0]))
        ls = np.exp(self._theta[1:])
        return (self.preprocessing_y.inverse_transform_scale(out),
                tuple(np.atleast_1d(
                    self.preprocessing_X.inverse_transform_scale(ls))))

    @property
    def theta_bounds(self):
        """Log-space hyperparameter optimization bounds."""
        if self._theta_bounds_spec is not None:
            return np.asarray(self._theta_bounds_spec)
        widths = None
        if hasattr(self.preprocessing_X, "transform_bounds"):
            b = self.preprocessing_X.transform_bounds(self.bounds)
            widths = b[:, 1] - b[:, 0]
        return theta_bounds_dynamic(
            self._theta, self.d, prior_widths=widths, dynamic=False,
            output_scale_prior=self.output_scale_prior,
            length_scale_prior=self.length_scale_prior)

    # ------------------------------------------------------------- thresholds

    def _diff_threshold_keep_n(self):
        """
        Threshold enlarged so that at least ``keep_min_finite`` points stay
        finite (reference: gpry/gpr.py:1475-1488).
        """
        y = self.y_train_all
        n = self.keep_min_finite
        if n is None or n <= 1 or len(y) == 0 or \
                not np.any(np.isfinite(y)):
            return self._diff_threshold
        y_sorted = np.sort(y)
        diff_nth = y_sorted[-1] - y_sorted[-min(n, len(y_sorted))]
        # When fewer than n points are finite, diff_nth is +inf and so is
        # the returned threshold: every finite point is kept — exactly the
        # reference's behavior (no isfinite guard there either).  A finite
        # fallback here would silently shrink the training set below
        # keep_min_finite whenever -inf values are present.
        return max(self._diff_threshold, diff_nth + 1e-6)

    def _is_finite_all(self, diff_threshold=None):
        if self.infinities_classifier is None:
            return np.isfinite(self.y_train_all)
        if diff_threshold is None:
            diff_threshold = self._diff_threshold_keep_n()
        return SVM._is_finite_raw(self.y_train_all, diff_threshold)

    def is_finite(self, y):
        """Threshold check in raw-y space."""
        if self.infinities_classifier is None:
            return np.isfinite(np.asarray(y))
        return SVM._is_finite_raw(
            np.asarray(y), self._diff_threshold_keep_n(),
            max_y=self.y_max if len(self.y_train) else None)

    def predict_is_finite(self, X, validate=True):
        """Classifier prediction at X: True where the surrogate treats the
        point as finite (reference: gpry/gpr.py:526)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if self.infinities_classifier is None or \
                self.infinities_classifier.n == 0:
            return np.ones(len(X), dtype=bool)
        X_ = np.atleast_2d(self.preprocessing_X.transform(X))
        return np.asarray(self.infinities_classifier.predict(
            X_, validate=validate), dtype=bool)

    @property
    def training_set_as_df(self):
        """Training set as a pandas DataFrame (reference: gpry/gpr.py:490)."""
        import pandas as pd
        data = {f"x_{i + 1}": self.X_train_all[:, i]
                for i in range(self.d)}
        data["y"] = self.y_train_all
        data["is_finite"] = self._is_finite_all()
        return pd.DataFrame(data)

    def set_random_state(self, random_state):
        """Reset the RNG (reference: gpry/gpr.py:542)."""
        self._rng = random_state if isinstance(
            random_state, np.random.Generator) \
            else np.random.default_rng(random_state)

    @staticmethod
    def compute_threshold_given_sigma(n_sigma, n_dimensions):
        """Delta-logp depth of the n_sigma contour at dimension d
        (reference: gpry/gpr.py:1468)."""
        return delta_logp_of_1d_nstd(n_sigma, n_dimensions)

    def remove_from_data(self, position, fit=True):
        """
        Remove training points by index (into the full appended set) and
        refresh the model (reference: gpry/gpr.py:819).  ``fit``: True for
        a hyperparameter refit, False for refactorization only.
        """
        position = np.atleast_1d(np.asarray(position, dtype=int))
        n_all = len(self.y_train_all)
        if np.any((position < 0) | (position >= n_all)):
            raise ValueError(f"Invalid positions {position} for a training "
                             f"set of size {n_all}.")
        keep = np.ones(n_all, dtype=bool)
        keep[position] = False
        self.X_train_all = self.X_train_all[keep]
        self.y_train_all = self.y_train_all[keep]
        self.noise_level_all = self.noise_level_all[keep]
        self.n_last_appended = 0
        self.n_last_appended_finite = 0
        # re-derive the finite training set and device state
        return self.append_to_data(None, None,
                                   fit_gpr=bool(fit))

    # ------------------------------------------------------------ data append

    def append_to_data(self, X, y, noise_level=None, fit_gpr=True,
                       fit_classifier=True):
        """
        Append new points and update the model (reference semantics:
        gpry/gpr.py:577-770).  ``fit_gpr`` may be True, False, "simple", or a
        dict of ``fit_gpr_hyperparameters`` kwargs.
        """
        fit_gpr_kwargs = None
        if fit_gpr is True:
            fit_classifier = True
            fit_gpr_kwargs = {}
        elif str(fit_gpr) == "simple":
            fit_classifier = True
            fit_gpr_kwargs = {"simple": True}
            fit_gpr = True
        elif isinstance(fit_gpr, dict):
            fit_classifier = True
            fit_gpr_kwargs = dict(fit_gpr)
            fit_gpr = True
        elif fit_gpr is not False:
            raise ValueError(f"Invalid fit_gpr={fit_gpr!r}")
        fit_preprocessors = bool(fit_classifier)
        force_fit_gpr = False
        force_refresh = False
        if X is None and y is None:
            # empty append: refresh the model for the current data (used
            # by remove_from_data and forced refits)
            X = np.empty((0, self.d))
            y = np.empty((0,))
            force_fit_gpr = fit_gpr
            force_refresh = True
        elif X is None or y is None:
            raise ValueError("Pass both X and y, or neither.")
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.atleast_1d(np.asarray(y, dtype=float))
        if len(X) != len(y):
            raise ValueError(
                f"X and y must have the same length; got {len(X)} vs "
                f"{len(y)}.")
        if X.shape[1] != self.d:
            raise ValueError(
                f"X has {X.shape[1]} columns but the model is "
                f"{self.d}-dimensional.")

        # per-point noise bookkeeping (reference: gpry/gpr.py:625-684)
        if noise_level is None:
            noise_new = np.full(len(y), self.noise_level_default)
        elif np.iterable(noise_level):
            noise_new = np.asarray(noise_level, dtype=float)
            if len(noise_new) != len(y):
                raise ValueError(
                    f"noise_level has {len(noise_new)} entries but y has "
                    f"{len(y)}.")
            self._has_custom_noise = True
        else:
            noise_new = np.full(len(y), float(noise_level))
            self._has_custom_noise = True

        old_finite_mask = self._is_finite_all() \
            if len(self.y_train_all) else np.empty(0, dtype=bool)
        self.n_last_appended = len(y)
        self.X_train_all = np.append(self.X_train_all, X, axis=0)
        self.y_train_all = np.append(self.y_train_all, y)
        self.noise_level_all = np.append(self.noise_level_all, noise_new)

        # 1. Thresholding (with keep-min-finite adjustment).
        diff_threshold = self._diff_threshold_keep_n()
        is_finite_all = self._is_finite_all(diff_threshold)
        X_finite = np.copy(self.X_train_all[is_finite_all])
        y_finite = np.copy(self.y_train_all[is_finite_all])

        # 2. Preprocessors (fit on finite points only; nothing to fit if no
        #    finite point has been seen yet).
        if fit_preprocessors and len(y_finite):
            self.preprocessing_X.fit(X_finite, y_finite)
            self.preprocessing_y.fit(X_finite, y_finite)
            self.bounds_ = self.preprocessing_X.transform_bounds(self.bounds)

        # 3. Classifier, in the preprocessed space (raw space while the
        #    y-preprocessor has no finite data to be fit on).
        if self.infinities_classifier is not None and fit_classifier:
            y_fitted = getattr(self.preprocessing_y, "fitted", True)
            X_all_ = self.preprocessing_X.transform(self.X_train_all)
            y_all_ = self.preprocessing_y.transform(self.y_train_all) \
                if y_fitted else self.y_train_all
            thr_ = self.preprocessing_y.transform_scale(diff_threshold) \
                if y_fitted else diff_threshold
            self.infinities_classifier.fit(X_all_, y_all_, thr_)

        self.n_last_appended_finite = int(
            np.sum(is_finite_all[len(is_finite_all) - self.n_last_appended:]))
        if not self.n_last_appended_finite and not force_fit_gpr \
                and not force_refresh:
            return self

        # 4. GP training set = finite subset.
        appended_only = (
            len(old_finite_mask) == 0
            or (np.array_equal(is_finite_all[:len(old_finite_mask)],
                               old_finite_mask))
        )
        self.X_train = X_finite
        self.y_train = y_finite

        if fit_gpr:
            self.fit_gpr_hyperparameters(**fit_gpr_kwargs)
        elif (not force_refresh and appended_only and not fit_preprocessors
              and self._dL is not None
              and len(y_finite) <= self._nmax and self._fitted
              and noise_level is None):
            # Fast path (Kriging-believer lies): incremental Cholesky
            # append.  Default noise only: custom per-append noise needs the
            # refreshed padded noise vector of a full refactorization.
            new_X = X_finite[len(y_finite) - self.n_last_appended_finite:]
            new_y = y_finite[len(y_finite) - self.n_last_appended_finite:]
            self._device_append(new_X, new_y)
        else:
            self._update_model()
        self.update_trust_region()
        return self

    # ------------------------------------------------------- device state mgmt

    def _transformed_training(self):
        X_ = np.atleast_2d(self.preprocessing_X.transform(self.X_train))
        y_ = np.asarray(self.preprocessing_y.transform(self.y_train))
        return X_, y_

    def _transformed_noise_var(self, nmax=None):
        """
        Diagonal noise variance in transformed-y units: a scalar, or — when
        per-point noise was given — an (nmax,) padded vector over the finite
        training rows (padding carries the default value).
        """
        if not self._has_custom_noise:
            nl_ = self.preprocessing_y.transform_scale(
                self.noise_level_default)
            return float(nl_) ** 2
        if nmax is None:
            nmax = self._nmax
        finite = self._is_finite_all()
        nl_fin = self.preprocessing_y.transform_scale(
            self.noise_level_all[finite])
        default_ = float(self.preprocessing_y.transform_scale(
            self.noise_level_default)) ** 2
        out = np.full(nmax, default_)
        out[:len(nl_fin)] = np.square(nl_fin)
        return out

    def _update_model(self):
        """Full padded refactorization for the current training set."""
        n = self.n
        if n == 0:
            return self
        X_, y_ = self._transformed_training()
        nmax = config.bucket_size(n)
        self._nmax = nmax
        dt = self._dtype
        Xp = np.zeros((nmax, self.d))
        Xp[:n] = X_
        yp = np.zeros(nmax)
        yp[:n] = y_
        self._dX = jnp.asarray(Xp, dt)
        self._dy = jnp.asarray(yp, dt)
        self._noise_var_ = self._transformed_noise_var(nmax)
        self._dL, self._dalpha = factorize(
            self.family, jnp.asarray(self._theta, dt), self._dX, self._dy,
            n, self._noise_var_)
        if bool(jnp.any(jnp.isnan(self._dL))):
            raise np.linalg.LinAlgError(
                "The kernel matrix is not positive definite. Try increasing "
                "'noise_level'.")
        return self

    def _device_append(self, new_X_raw, new_y_raw):
        """Incremental block-Cholesky append of already-finite new points."""
        k = len(new_y_raw)
        if k == 0:
            return
        n_old = self.n - k
        if self.n > self._nmax:
            self._update_model()
            return
        X_ = np.atleast_2d(self.preprocessing_X.transform(new_X_raw))
        y_ = np.asarray(self.preprocessing_y.transform(new_y_raw))
        dt = self._dtype
        (self._dX, self._dy, _, self._dL, self._dalpha) = chol_append(
            self.family, jnp.asarray(self._theta, dt), self._dX, self._dy,
            n_old, self._noise_var_, self._dL,
            jnp.asarray(X_, dt), jnp.asarray(y_, dt))
        if bool(jnp.any(jnp.isnan(self._dL[n_old + k - 1]))):
            # Numerically unsafe append: fall back to full refactorization.
            self._update_model()

    # ------------------------------------------------------- hyperparameter fit

    def _liveness(self):
        """Invoke the optional liveness callback (set by the Runner when a
        checkpoint exists): hang watchdogs distinguish a multi-minute fit
        ladder from a hung process by these ticks."""
        cb = getattr(self, "liveness_callback", None)
        if cb is not None:
            try:
                cb()
            except Exception:
                pass

    def fit_gpr_hyperparameters(self, simple=False, start_from_current=True,
                                n_restarts=None, hyperparameter_bounds=None,
                                maxiter=120):
        """
        Multi-restart LML maximization (reference: gpry/gpr.py:883-994).
        All restarts run as one vmapped device computation.
        """
        if simple:
            start_from_current = True
            # Warm start + ONE extra lane seeded by the batched LML
            # screen below.  A pure warm-start continuation (the
            # reference's simple fit, n_restarts=1) cannot jump basins
            # between the scheduled full fits: measured at d=12, the
            # LML's global basin moves to the polynomial regime
            # (length-scales at the bound, huge amplitude) around
            # n~100 while the warm-started theta tracks the stale
            # short-lengthscale basin until the next full fit, costing
            # 4-12 extra acquisition batches (312 vs 162 evals on one
            # seed).  The screen is one batched device sweep — cheap
            # here, prohibitive for the reference's sequential scipy
            # restarts, which is why it must schedule full fits sparsely.
            n_restarts = 2
        if not self._fitted:
            start_from_current = False
        if n_restarts is None:
            n_restarts = self.n_restarts_optimizer
        if self.optimizer is None or n_restarts <= 0:
            warnings.warn("Hyperparameters not (re)fit: no optimizer or "
                          "zero restarts requested.")
            self._update_model()
            self.log_marginal_likelihood_value_ = \
                self.log_marginal_likelihood()
            return self
        if self.n == 0:
            raise ValueError("No training data to fit.")
        bounds = np.asarray(hyperparameter_bounds if hyperparameter_bounds
                            is not None else self.theta_bounds)
        lo, hi = bounds[:, 0], bounds[:, 1]
        # The search is screen-then-polish: ONE batched LML sweep over a
        # dense candidate set picks the L-BFGS seeds, and only one chunk of
        # LBFGS_CHUNK lanes is polished.  The screen locates deeper basins
        # than blind random restarts (the reference splits 10+2d blind restarts over MPI
        # ranks, gpry/run.py:1253-1293; measured here: screen-2048+polish-8
        # beats screen-256+coarse-32+polish-8 on both wall time and the
        # exact LML found).  ``n_restarts`` keeps its API meaning as search
        # effort: the screen grows with it.
        n_polish = int(min(LBFGS_CHUNK, max(n_restarts, 1)))
        theta0s = np.empty((n_polish, len(self._theta)))
        i0 = 0
        if start_from_current:
            theta0s[0] = np.clip(self._theta, lo, hi)
            i0 = 1
        if n_polish > i0:
            theta0s[i0:] = self._rng.uniform(
                lo, hi, size=(n_polish - i0, len(lo)))
        # Refresh padded buffers for the current training set (cheap; no
        # factorization needed before the fit).
        n = self.n
        X_, y_ = self._transformed_training()
        nmax = config.bucket_size(n)
        self._nmax = nmax
        dt = self._dtype
        Xp = np.zeros((nmax, self.d))
        Xp[:n] = X_
        yp = np.zeros(nmax)
        yp[:n] = y_
        self._dX = jnp.asarray(Xp, dt)
        self._dy = jnp.asarray(yp, dt)
        self._noise_var_ = self._transformed_noise_var(nmax)
        if self._dL is not None and self._dL.shape[0] != nmax:
            # bucket crossed: the old factorization no longer matches the
            # padded buffers.  Drop it NOW so an exception escaping the
            # search below (e.g. all-restarts-non-finite LinAlgError)
            # leaves a coherent "unfitted" state — predict() then falls
            # back to the prior instead of feeding shape-mismatched
            # (X, L) pairs into triangular solves.
            self._dL = self._dalpha = None

        on_cpu = all(dev.platform == "cpu" for dev in self._dX.devices())
        # Demand-driven fit frequency at large n: price the incumbent theta
        # in the same batched sweep; if no screened candidate beats it, the
        # LML's global basin has not moved and the O(maxiter * lanes * n^3)
        # polish ladder is skipped (factorize-only iteration).  Scheduled
        # full fits still repolish within-basin drift.  Below the n gate
        # the code path (and the _rng stream) is unchanged.
        demand_price = (start_from_current and self._fitted
                        and self.demand_fit_min_n is not None
                        and n >= self.demand_fit_min_n)
        demand_skip = simple and demand_price
        if n_polish > i0 + 1 or (simple and n_polish > i0):
            # batched f64 sweeps are cheap on CPU too, but scale the screen
            # down there (the grid/benchmarks run the loop on CPU hosts)
            n_screen = max(8 * n_restarts, 256 if on_cpu else 2048)
            cand = self._rng.uniform(lo, hi, size=(n_screen, len(lo)))
            cand = np.vstack([theta0s[i0:], cand])
            if demand_price:
                # incumbent priced as the LAST row of the same sweep
                cand = np.vstack([cand, theta0s[:1]])
            lml_c = np.asarray(_lml_batch_chunked(
                self.family, self._dX, self._dy, n, self._noise_var_,
                jnp.asarray(cand, dt), on_chunk=self._liveness))
            lml_c = np.where(np.isfinite(lml_c), lml_c, -np.inf)
            self.n_eval_loglike += len(cand)
            if demand_price:
                lml_cur = float(lml_c[-1])
                lml_c, cand = lml_c[:-1], cand[:-1]
                basin_unmoved = (np.isfinite(lml_cur)
                                 and float(np.max(lml_c)) <= lml_cur)
                if basin_unmoved and not demand_skip and n_polish > 2:
                    # Scheduled full fit with an unmoved LML basin:
                    # downgrade the LBFGS_CHUNK-lane ladder to a 2-lane
                    # within-basin repolish (incumbent + best screened
                    # candidate).  The drift polish the schedule exists
                    # for survives; the O(lanes) basin search it no longer
                    # needs does not.
                    theta0s = theta0s[:2]
                    n_polish = 2
                    self.n_fits_downgraded += 1
                if demand_skip and basin_unmoved:
                    L_, alpha_ = factorize(
                        self.family, jnp.asarray(theta0s[0], dt), self._dX,
                        self._dy, n, self._noise_var_)
                    if not bool(jnp.any(jnp.isnan(L_))):
                        self._theta = np.asarray(theta0s[0])
                        self._dL, self._dalpha = L_, alpha_
                        self.log_marginal_likelihood_value_ = lml_cur
                        self.n_fits_skipped += 1
                        self._fitted = True
                        return self
                    # non-PD at the incumbent: fall through to the polish
            order = np.argsort(lml_c)[::-1]
            theta0s[i0:] = cand[order[:n_polish - i0]]
        n_restarts = n_polish

        self._liveness()     # the polish can take minutes at large n
        # Restarts are DP-sharded over the device mesh when one is available
        # (the analogue of the reference's MPI restart split,
        # gpry/run.py:1253-1293); a single device runs the same math
        # unsharded.
        from gpry_tpu.parallel.mesh import fit_theta_restarts_maybe_sharded
        thetas, nlls, fit_nevs = fit_theta_restarts_maybe_sharded(
            self.family, self._dX, self._dy, n, self._noise_var_,
            jnp.asarray(theta0s, dt), jnp.asarray(lo, dt),
            jnp.asarray(hi, dt), maxiter=maxiter)
        nlls = np.asarray(nlls)
        # exact per-lane objective-eval counts from the solver
        self.n_eval_loglike += int(np.sum(np.asarray(fit_nevs)))
        # NaN-safe argmin: individual restarts may fail (non-PD at their
        # theta); only all-failed is an error.
        nlls_safe = np.where(np.isfinite(nlls), nlls, np.inf)
        best = int(np.argmin(nlls_safe))
        if not np.isfinite(nlls[best]):
            raise np.linalg.LinAlgError(
                "All hyperparameter fits failed (non-finite LML). "
                f"n={n}, noise_var={np.mean(self._noise_var_):.3g}, "
                f"y_ range=({float(np.min(np.asarray(self._dy)[:n])):.3g}, "
                f"{float(np.max(np.asarray(self._dy)[:n])):.3g}), "
                f"theta0s range=({theta0s.min():.3g}, {theta0s.max():.3g}), "
                f"lo={lo.round(2)}, hi={hi.round(2)}, "
                f"X_ finite={bool(np.all(np.isfinite(np.asarray(self._dX))))}"
                f", nlls[:4]={nlls[:4]}")
        # Winner selection by one batched exact LML over the search
        # endpoints (+ the incumbent theta), so that a refit seeded at the
        # incumbent never lands on a *worse* theta.
        cand = np.asarray(thetas, dtype=float)
        if self._fitted:
            cand = np.vstack([cand, np.asarray(self._theta, dtype=float)])
        lml_exact = np.asarray(_lml_batch_chunked(
            self.family, self._dX, self._dy, n, self._noise_var_,
            jnp.asarray(cand, dt)))
        self.n_eval_loglike += len(cand)
        if np.any(np.isfinite(lml_exact)):
            best_e = int(np.argmax(np.where(np.isfinite(lml_exact),
                                            lml_exact, -np.inf)))
            self._theta = cand[best_e]
            self.log_marginal_likelihood_value_ = float(lml_exact[best_e])
        else:
            # every endpoint non-PD on re-evaluation: fall back to the
            # search-objective ranking (the factorization below will
            # surface a LinAlgError if even the winner is unusable)
            self._theta = np.asarray(thetas[best])
            self.log_marginal_likelihood_value_ = -float(nlls[best])
        self._dL, self._dalpha = factorize(
            self.family, jnp.asarray(self._theta, dt), self._dX, self._dy,
            n, self._noise_var_)
        self._fitted = True
        return self

    def log_marginal_likelihood(self, theta=None):
        """LML at ``theta`` (default: current)."""
        if self.n == 0:
            return -np.inf
        theta = self._theta if theta is None else np.asarray(theta)
        if self._dX is None:
            self._update_model()
        self.n_eval_loglike += 1
        return float(masked_lml(
            self.family, jnp.asarray(theta, self._dtype), self._dX, self._dy,
            self.n, self._noise_var_))

    # ------------------------------------------------------------- trust region

    def update_trust_region(self):
        """Reference: gpry/gpr.py:554 + gpry/tools.py:308."""
        if self.trust_region_factor is None:
            self.trust_bounds = None
            return
        self.trust_bounds = shrink_bounds(
            self.bounds, self.X_train, self.y_train,
            factor=self.trust_region_factor, nstd=self.trust_region_nstd)

    # ---------------------------------------------------------------- predict

    def f32_sweep_error_estimate(self):
        """
        Estimated raw-nats error of float32 sweep predictions:
        ``eps32 * k_max * sum|alpha| * y_scale`` — the cancellation bound
        of the predictive-mean dot ``k(x)^T alpha`` (alpha entries are
        large and cancel on ill-conditioned kernels).  Validated against
        measured f32-vs-f64 errors (est 0.37 vs median 0.27 on the d=8
        bench case; est 3.2 vs median 3.6 on a wide-bounds 2-d Gaussian).
        """
        if self._dalpha is None or not self._fitted:
            return 0.0
        from gpry_tpu.models.preprocessing import affine_params_y
        if getattr(self.preprocessing_y, "fitted", False):
            _, y_scale = affine_params_y(self.preprocessing_y)
        else:
            y_scale = 1.0
        eps32 = float(jnp.finfo(jnp.float32).eps)
        k_max = float(np.exp(self._theta[0]))
        return eps32 * k_max * float(np.sum(np.abs(
            np.asarray(self._dalpha)))) * float(y_scale)

    def sweep_dtype(self):
        """
        Dtype for bulk prediction sweeps (NS, acquisition ranking,
        conditioning), per ``config.SWEEP_DTYPE``: float32 only when
        asked for explicitly, the fit dtype otherwise ("auto", "float64",
        "fit") — float32 sweeps on ill-conditioned kernels carry whole-nat
        errors that break acquisition and convergence (fast-but-wrong).
        """
        if str(config.SWEEP_DTYPE) in ("float32", "f32"):
            return jnp.float32
        return self._dtype

    def sweep_params(self) -> "SurrogateParams":
        """Surrogate snapshot in the sweep dtype (see ``sweep_dtype``).

        The cast pytree is memoized per factorization: repeated sweeps in
        the same iteration reuse ONE set of device buffers (stable
        ``p.L`` identity also keeps the TP path's K^-1 cache warm,
        parallel/mesh.py:_kinv_for) instead of re-casting per call."""
        p = self.surrogate_params()
        dt = self.sweep_dtype()
        if dt == p.X.dtype:
            return p
        # classifier refits can happen WITHOUT a refactorization (an
        # all-infinite append early-returns before touching _dL), so the
        # SVM's fit stamp must be part of the key or sweeps keep gating
        # on a stale classifier
        svm_stamp = getattr(self.infinities_classifier, "fit_stamp", -1) \
            if self.infinities_classifier is not None else -1
        cached = getattr(self, "_sweep_cast_cache", None)
        if cached is not None:
            (L0, a0, X0, dt0, s0), pc0 = cached
            if (L0 is self._dL and a0 is self._dalpha
                    and X0 is self._dX and dt0 == str(dt)
                    and s0 == svm_stamp):
                return pc0
        pc = cast_surrogate(p, dt)
        self._sweep_cast_cache = ((self._dL, self._dalpha, self._dX,
                                   str(dt), svm_stamp), pc)
        return pc

    def surrogate_params(self, nsv_max=None) -> SurrogateParams:
        """Snapshot the full prediction state as a jit-friendly pytree."""
        dt = self._dtype
        d = self.d
        # Probe the fitted preprocessors for their affine parameters instead
        # of trusting specific attribute names — raises (rather than silently
        # predicting in the wrong space) for non-affine/non-diagonal ones.
        from gpry_tpu.models.preprocessing import (affine_params_X,
                                                   affine_params_y)
        if getattr(self.preprocessing_X, "fitted", True):
            x_loc, x_scale = affine_params_X(self.preprocessing_X, d)
        else:
            x_loc, x_scale = np.zeros(d), np.ones(d)
        if getattr(self.preprocessing_y, "fitted", False):
            y_loc, y_scale = affine_params_y(self.preprocessing_y)
        else:
            y_loc, y_scale = 0.0, 1.0
        if self.clip_factor is not None and self.n > 0:
            cf = self.clip_factor
            clip_max = cf * np.max(self.y_train) \
                - (cf - 1) * np.min(self.y_train)
        else:
            clip_max = np.inf
        if self.infinities_classifier is not None and \
                self.infinities_classifier.n > 0:
            svm_params = self.infinities_classifier.device_params(
                nsv_max=nsv_max, dtype=dt)
        else:
            svm_params = trivial_svm_params(d, dtype=dt)
        if self.trust_bounds is not None:
            trust_lo = np.asarray(self.trust_bounds[:, 0], dtype=float)
            trust_hi = np.asarray(self.trust_bounds[:, 1], dtype=float)
        else:
            trust_lo = np.full(d, -np.inf)
            trust_hi = np.full(d, np.inf)
        return SurrogateParams(
            theta=jnp.asarray(self._theta, dt),
            X=self._dX, y=self._dy, n=jnp.asarray(self.n, jnp.int32),
            noise_var=jnp.asarray(self._noise_var_, dt),
            L=self._dL, alpha=self._dalpha,
            x_loc=jnp.asarray(x_loc, dt), x_scale=jnp.asarray(x_scale, dt),
            y_loc=jnp.asarray(y_loc, dt), y_scale=jnp.asarray(y_scale, dt),
            y_max=jnp.asarray(self.y_max, dt),
            clip_max=jnp.asarray(clip_max, dt),
            svm=svm_params,
            trust_lo=jnp.asarray(trust_lo, dt),
            trust_hi=jnp.asarray(trust_hi, dt),
        )

    def predict(self, X, return_std=False, return_cov=False,
                return_mean_grad=False, return_std_grad=False,
                validate=True, ignore_trust_region=False):
        """
        Host-facing prediction with reference semantics
        (gpry/gpr.py:1022-1265).  Returns numpy arrays.
        ``return_cov`` returns the full posterior covariance (raw-y units)
        as the second output; it is exclusive with return_std, as in
        sklearn.
        """
        if return_cov and (return_std or return_mean_grad
                           or return_std_grad):
            raise ValueError(
                "return_cov is exclusive with return_std and gradients.")
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if validate:
            # host-surface input validation (the reference inherits
            # sklearn's validate_data, gpry/gpr.py:1095-1100); pass
            # validate=False on hot paths with pre-checked arrays
            if X.ndim != 2 or X.shape[1] != self.d:
                raise ValueError(
                    f"X must be (n, {self.d}); got shape {X.shape}.")
            if not np.isfinite(X).all():
                raise ValueError("X contains NaN or inf.")
        self.n_eval += len(X)
        if self._dL is None or self.n == 0:
            # Not fit: prior mean zero / prior std (reference:
            # gpry/gpr.py:1111-1133).
            out = [np.zeros(len(X))]
            if return_std:
                if isinstance(self.family, tuple):
                    from gpry_tpu.ops.kernels import spec_diag
                    prior_std = np.sqrt(np.asarray(spec_diag(
                        self.family, jnp.asarray(self._theta, self._dtype),
                        jnp.asarray(X, self._dtype))))
                    out.append(prior_std)
                else:
                    out.append(np.full(len(X),
                                       float(np.exp(0.5 * self._theta[0]))))
            if return_mean_grad:
                out.append(np.zeros_like(X))
            if return_std_grad:
                out.append(np.zeros_like(X))
            return tuple(out) if len(out) > 1 else out[0]
        p = self.surrogate_params()
        if ignore_trust_region:
            p = p._replace(trust_lo=jnp.full(self.d, -jnp.inf,
                                             self._dtype),
                           trust_hi=jnp.full(self.d, jnp.inf, self._dtype))
        Xd = jnp.asarray(X, self._dtype)
        if return_cov:
            from gpry_tpu.ops.linalg import predict_meancov
            mean, std = surrogate_predict(self.family, p, Xd)
            Xq_ = (Xd - p.x_loc) / p.x_scale
            _, cov_ = predict_meancov(
                self.family, p.theta, p.X, p.n, p.noise_var, p.L,
                p.alpha, Xq_)
            cov = np.asarray(cov_) * float(p.y_scale) ** 2
            return np.asarray(mean), cov
        # Mesh-aware dispatch: large batches DP-shard over the rows; small
        # batches with a large training buffer TP-shard over the training
        # axis; otherwise plain single-device (parallel/mesh.py).
        from gpry_tpu.parallel.mesh import predict_maybe_sharded
        mean, std = predict_maybe_sharded(self.family, p, Xd)
        out = [np.asarray(mean)]
        if return_std:
            out.append(np.asarray(std))
        if return_mean_grad or return_std_grad:
            grad_fn = jax.jacfwd(
                lambda x: jnp.stack(surrogate_mean_std_smooth(
                    self.family, p, x[None])).ravel())
            grads = jax.vmap(grad_fn)(Xd)    # (nq, 2, d)
            if return_mean_grad:
                out.append(np.asarray(grads[:, 0, :]))
            if return_std_grad:
                out.append(np.asarray(grads[:, 1, :]))
        return tuple(out) if len(out) > 1 else out[0]

    def predict_std(self, X, validate=True):
        """Std only (reference: gpry/gpr.py:1275)."""
        return self.predict(X, return_std=True, validate=validate)[1]

    def __deepcopy__(self, memo):
        import copy
        cls = self.__class__
        new = cls.__new__(cls)
        for k, v in self.__dict__.items():
            if k == "_sweep_cast_cache":
                continue  # per-factorization memo; rebuilt on demand
            if isinstance(v, jax.Array):
                new.__dict__[k] = v  # immutable: share
            else:
                new.__dict__[k] = copy.deepcopy(v, memo)
        return new
