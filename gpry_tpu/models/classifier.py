"""
Infinities classifier ("SVM").

Reproduces the semantics of the reference's SVM wrapper (gpry/svm.py:20-347):
an RBF-kernel support-vector classifier that separates "finite" from
"-inf-like" regions of the target, where "finite" is defined by a threshold
``y >= max(y) - diff_threshold`` (plus actual finiteness).  It gates both the
GP training set and all predictions.

Host/device split: the *fit* (a tiny QP over <= a few thousand points, once
per iteration) runs on the host through the native C++ SMO trainer
(``gpry_tpu.native``; scikit-learn/libsvm on request); the *decision
function* — evaluated
millions of times inside jitted acquisition/NS sweeps — is exported as
fixed-shape padded arrays (support vectors, dual coefficients, intercept,
gamma) and evaluated on device, see ``svm_decision``.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from gpry_tpu import config

# Decision modes for the padded device-side classifier.
MODE_ALL_FINITE = 0    # no SVC fit needed: everything classified finite
MODE_FITTED = 1        # use the decision function
MODE_NONE_FINITE = 2   # only -inf points seen: everything infinite


class SVMParams(NamedTuple):
    """Padded, jit-friendly snapshot of a fitted classifier."""
    mode: jnp.ndarray        # () int32, one of the MODE_* constants
    sv: jnp.ndarray          # (nsv_max, d) support vectors (padded zeros)
    dual: jnp.ndarray        # (nsv_max,) signed dual coefs (padded zeros)
    intercept: jnp.ndarray   # () float
    gamma: jnp.ndarray       # () float


def svm_decision(params: SVMParams, X):
    """
    Device-side decision: True where finite is predicted.
    ``X`` (nq, d) must be in the same (preprocessed) space the SVM was fit in.
    Padded dual coefficients are zero, so padding contributes nothing.
    """
    diff = X[:, None, :] - params.sv[None, :, :]
    sq = jnp.sum(diff * diff, axis=-1)
    dec = jnp.exp(-params.gamma * sq) @ params.dual + params.intercept
    finite = dec > 0
    finite = jnp.where(params.mode == MODE_ALL_FINITE, True, finite)
    finite = jnp.where(params.mode == MODE_NONE_FINITE, False, finite)
    return finite


def trivial_svm_params(d, nsv_max=8, dtype=None):
    """Everything-finite placeholder (classifier disabled or untrained)."""
    dtype = dtype or config.FIT_DTYPE
    return SVMParams(
        mode=jnp.asarray(MODE_ALL_FINITE, jnp.int32),
        sv=jnp.zeros((nsv_max, d), dtype),
        dual=jnp.zeros((nsv_max,), dtype),
        intercept=jnp.asarray(0.0, dtype),
        gamma=jnp.asarray(1.0, dtype),
    )


class SVM:
    """
    API-compatible stand-in for the reference's ``gpry.svm.SVM``.

    Parameters mirror sklearn's SVC where meaningful; the reference's default
    ``C=1e7`` (near-hard-margin) is kept (gpry/svm.py:159).
    """

    def __init__(self, C=1e7, kernel="rbf", gamma="scale", tol=1e-3,
                 random_state=None, backend="native"):
        if kernel != "rbf":
            raise ValueError("Only the RBF kernel is supported.")
        self.C = C
        self.gamma = gamma
        self.tol = tol
        self.random_state = random_state
        self.backend = backend  # "native" (C++ SMO) or "sklearn"
        self.X_train = None
        self.y_train = None
        self.y_finite = None
        self.at_least_one_finite = False
        self.all_finite = False
        self.diff_threshold = None
        self._max_y = None
        # fitted decision function: f(x) = sum dual_i K(x, sv_i) + b
        self._sv = None
        self._dual = None
        self._intercept = None
        self._gamma_val = None
        # monotonic fit stamp: cache keys (gp.sweep_params) must invalidate
        # on a classifier refit even when the GP factorization is unchanged
        # (e.g. an all-infinite append early-returns before refactorizing)
        self.fit_stamp = 0

    # -- threshold logic (reference: gpry/svm.py:273-306) --------------------

    @staticmethod
    def _is_finite_raw(y, diff_threshold, max_y=None):
        y = np.asarray(y, dtype=float)
        if max_y is None:
            max_y = np.max(y)
        return np.greater_equal(y, max_y - diff_threshold) & np.isfinite(y)

    def is_finite(self, y):
        if self.y_train is None:
            raise ValueError("The SVM has not been trained yet!")
        return self._is_finite_raw(y, self.diff_threshold, self._max_y)

    @property
    def abs_threshold(self):
        return self._max_y - self.diff_threshold

    @property
    def d(self):
        if self.X_train is None:
            raise ValueError("No data added yet.")
        return self.X_train.shape[1]

    @property
    def n(self):
        return 0 if self.y_train is None else len(self.y_train)

    # -- fit / predict --------------------------------------------------------

    def fit(self, X, y, diff_threshold):
        """
        Fit on (preprocessed) X, y with the given threshold.  Returns the
        boolean finite classification of the training points.
        """
        self.fit_stamp = getattr(self, "fit_stamp", 0) + 1
        self.X_train = np.ascontiguousarray(X, dtype=float)
        self.y_train = np.asarray(y, dtype=float).copy()
        if not np.any(np.isfinite(self.y_train)):
            self.at_least_one_finite = False
            self.y_finite = np.full(len(self.y_train), False)
            return self.y_finite
        self.at_least_one_finite = True
        self.diff_threshold = diff_threshold
        self._max_y = np.max(self.y_train)
        self.y_finite = self._is_finite_raw(
            self.y_train, self.diff_threshold, self._max_y)
        if np.all(self.y_finite):
            self.all_finite = True
            self._sv = None
            return self.y_finite
        self.all_finite = False
        gamma = None if self.gamma == "scale" else float(self.gamma)
        if self.backend == "native":
            # raises NativeBuildError when the C++ trainer cannot be built
            from gpry_tpu.native import train_rbf_svc
            (self._sv, self._dual, self._intercept,
             self._gamma_val) = train_rbf_svc(
                self.X_train, self.y_finite, C=self.C, gamma=gamma,
                tol=self.tol)
            return self.y_finite
        if self.backend != "sklearn":
            raise ValueError(f"Unknown SVM backend {self.backend!r}.")
        from sklearn.svm import SVC
        svc = SVC(C=self.C, kernel="rbf", gamma=self.gamma, tol=self.tol)
        svc.fit(self.X_train, self.y_finite)
        self._sv = svc.support_vectors_
        self._dual = svc.dual_coef_[0]
        self._intercept = float(svc.intercept_[0])
        self._gamma_val = float(svc._gamma)
        return self.y_finite

    def decision_function(self, X):
        """f(x) = sum_i dual_i K_rbf(x, sv_i) + b (positive = finite)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        sq = ((X[:, None, :] - self._sv[None, :, :]) ** 2).sum(-1)
        return np.exp(-self._gamma_val * sq) @ self._dual + self._intercept

    def predict(self, X, validate=True):
        """Boolean "finite predicted" array, in preprocessed coordinates."""
        if self.y_train is None:
            raise ValueError("The SVM has not been trained yet.")
        X = np.atleast_2d(X) if validate else X
        if self.all_finite:
            return np.full(len(X), True)
        if not self.at_least_one_finite:
            return np.full(len(X), False)
        return self.decision_function(X) > 0

    # -- device export ---------------------------------------------------------

    def device_params(self, nsv_max=None, dtype=None) -> SVMParams:
        """
        Padded pytree of the decision function for jitted device sweeps.
        ``nsv_max`` buckets the support-vector buffer (recompile per bucket).
        """
        dtype = dtype or config.FIT_DTYPE
        if self.y_train is None or self.all_finite or self._sv is None:
            if not self.at_least_one_finite and self.y_train is not None:
                d = self.X_train.shape[1]
                p = trivial_svm_params(d, nsv_max or 8, dtype)
                return p._replace(mode=jnp.asarray(MODE_NONE_FINITE,
                                                   jnp.int32))
            d = self.X_train.shape[1] if self.X_train is not None else 1
            return trivial_svm_params(d, nsv_max or 8, dtype)
        sv = self._sv
        dual = self._dual
        nsv, d = sv.shape
        if nsv_max is None:
            nsv_max = config.bucket_size(nsv)
        pad = nsv_max - nsv
        if pad < 0:
            raise ValueError(f"nsv_max={nsv_max} < n_support={nsv}")
        return SVMParams(
            mode=jnp.asarray(MODE_FITTED, jnp.int32),
            sv=jnp.asarray(np.pad(sv, ((0, pad), (0, 0))), dtype),
            dual=jnp.asarray(np.pad(dual, (0, pad)), dtype),
            intercept=jnp.asarray(self._intercept, dtype),
            gamma=jnp.asarray(self._gamma_val, dtype),
        )
