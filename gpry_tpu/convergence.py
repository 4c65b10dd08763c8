"""
Convergence criteria for the active-learning loop.

Reference surface: gpry/convergence.py (879 LoC).  Each criterion carries a
policy — "n"(ecessary), "s"(ufficient), "ns", or "m"(onitor only) — and the
Runner combines them as: converged iff all necessary criteria hold AND (any
sufficient holds OR none is declared) (gpry/run.py:1309-1333).

Differences from the reference driven by the device design:

* ``GaussianKL``'s fallback mean/cov estimation runs the on-device ensemble
  MCMC (mc.mcmc) instead of per-MPI-rank Cobaya chains — the surrogate is
  cheap on device, so the reference's sample-reuse/reweighting machinery
  (gpry/convergence.py:369-427) is unnecessary.
* No ``DummyMPIConvergeCriterion``: single-controller JAX has no non-root
  ranks.  ``is_converged_MPIwrapped`` is kept as an alias for API parity.
"""

import numpy as np

from gpry_tpu.utils.tools import (check_and_return_bounds,
                                  credibility_of_nstd, kl_norm,
                                  mean_covmat_from_evals, nstd_of_1d_nstd)

_VALID_POLICIES = ("n", "s", "ns", "m")


class ConvergenceCheckError(Exception):
    """A criterion could not be evaluated this iteration (non-fatal;
    treated as 'not converged', reference: gpry/convergence.py:30)."""


def builtin_names():
    return [cls.__name__ for cls in ConvergenceCriterion.__subclasses__()]


def construct_criterion(spec, prior_bounds, params=None):
    """Build a criterion from an instance / name / {name: params} spec."""
    import sys
    module = sys.modules[__name__]
    if isinstance(spec, ConvergenceCriterion):
        return spec
    if isinstance(spec, str):
        spec = {spec: {}}
    if isinstance(spec, dict) and len(spec) == 1:
        name = list(spec)[0]
        cls = getattr(module, name, None)
        if cls is None or not (isinstance(cls, type) and
                               issubclass(cls, ConvergenceCriterion)):
            raise ValueError(f"Unknown convergence criterion '{name}'.")
        return cls(prior_bounds, dict(spec[name] or {}, **(params or {})))
    raise ValueError(f"Cannot build convergence criterion from {spec!r}.")


class ConvergenceCriterion:
    """Base class (reference: gpry/convergence.py:51-203)."""

    _default_policy = "s"

    def __init__(self, prior_bounds, params=None):
        params = params or {}
        self.prior_bounds = check_and_return_bounds(prior_bounds)
        self.values = []
        self.n_posterior_evals = []
        self.n_accepted_evals = []
        self._set_convergence_policy(params)
        # seeded by the Runner (re-linked on resume): the fallback MCMC
        # mean/cov estimate must ride the run's RNG stream or identically
        # seeded runs diverge at the first convergence check
        self.rng = None

    def _set_convergence_policy(self, params):
        policy = (params or {}).get("policy", self._default_policy)
        if policy not in _VALID_POLICIES:
            raise ValueError(
                f"Invalid policy '{policy}'; must be one of "
                f"{_VALID_POLICIES}.")
        self.policy = policy

    @property
    def d(self):
        return self.prior_bounds.shape[0]

    @property
    def is_necessary(self):
        return "n" in self.policy

    @property
    def is_sufficient(self):
        return "s" in self.policy

    @property
    def is_monitor(self):
        return self.policy == "m"

    @property
    def last_value(self):
        return self.values[-1] if self.values else np.nan

    @property
    def limit(self):
        """Threshold for the criterion value."""
        raise NotImplementedError

    def criterion_value(self, gp, gp_2=None, **kwargs):
        raise NotImplementedError

    def is_converged(self, gp, gp_2=None, new_X=None, new_y=None,
                     pred_y=None, acquisition=None):
        raise NotImplementedError

    # API parity alias (single-controller: no MPI wrapping needed).
    def is_converged_MPIwrapped(self, *args, **kwargs):
        return self.is_converged(*args, **kwargs)

    def _record(self, gp, value):
        self.values.append(value)
        self.n_posterior_evals.append(gp.n_total)
        self.n_accepted_evals.append(gp.n)


class DontConverge(ConvergenceCriterion):
    """Never converge: run until budget exhaustion
    (reference: gpry/convergence.py:226)."""

    _default_policy = "n"

    @property
    def limit(self):
        return np.nan

    def criterion_value(self, gp, gp_2=None, **kwargs):
        self._record(gp, np.nan)
        return np.nan

    def is_converged(self, gp, gp_2=None, **kwargs):
        self.criterion_value(gp)
        return False


class CorrectCounter(ConvergenceCriterion):
    """
    Converged when the GP predicted MORE THAN ``n_correct`` consecutive
    truth evaluations within tolerance (strictly ``n_pred > n_correct``,
    the reference's own comparison, gpry/convergence.py:843)
    ``|y_pred - y| < reltol * |y - y_max| + abstol``
    (reference: gpry/convergence.py:755-879).  ``reltol``/``abstol`` accept
    the sigma-scaling suffixes "l"/"s"/"r".
    """

    _default_policy = "s"

    def __init__(self, prior_bounds, params=None):
        params = params or {}
        super().__init__(prior_bounds, params)
        d = self.d
        self.ncorrect = params.get("n_correct", max(4, int(np.ceil(0.5 * d))))
        self.reltol = self._parse_tol(params.get("reltol", 0.01))
        self.abstol = self._parse_tol(params.get("abstol", "0.01s"))
        self.verbose = params.get("verbose", 0)
        self.thres = []
        self.n_pred = 0

    def _parse_tol(self, tol):
        if not isinstance(tol, str):
            return float(tol)
        suffix = tol[-1]
        scale = {
            "l": nstd_of_1d_nstd(1, self.d),
            "s": nstd_of_1d_nstd(1, self.d) ** 2,
            "r": np.sqrt(nstd_of_1d_nstd(1, self.d)),
        }.get(suffix)
        if scale is None:
            raise ValueError(
                f"Tolerance must be a number or a string ending in "
                f"'l'/'s'/'r'. Got {tol!r}.")
        return float(tol[:-1]) * scale

    @property
    def limit(self):
        return self.thres[-1] if self.thres else np.nan

    def criterion_value(self, gp, gp_2=None, new_X=None, new_y=None,
                        pred_y=None):
        new_y = np.atleast_1d(new_y) if new_y is not None else np.array([])
        pred_y = np.atleast_1d(pred_y) if pred_y is not None \
            else np.array([])
        if len(new_y) != len(pred_y):
            raise ConvergenceCheckError(
                "new_y and pred_y must have equal length.")
        max_val, max_diff, max_thres = 0.0, 0.0, 0.0
        for yn, yl in zip(new_y, pred_y):
            if yn == -np.inf:
                continue
            diff = abs(yl - yn)
            thres = abs(yn - gp.y_max) * self.reltol + self.abstol
            if thres > 0 and diff / thres > max_val:
                max_val, max_diff, max_thres = diff / thres, diff, thres
            if diff < thres:
                self.n_pred += 1
            else:
                self.n_pred = 0
        n_new = len(new_y)
        self.values.append(max_diff if n_new else
                           (self.values[-1] if self.values else np.nan))
        self.thres.append(max_thres if n_new else
                          (self.thres[-1] if self.thres else np.nan))
        self.n_posterior_evals.append(gp.n_total)
        self.n_accepted_evals.append(gp.n)
        return max_val if n_new else self.last_value

    def is_converged(self, gp, gp_2=None, new_X=None, new_y=None,
                     pred_y=None, acquisition=None):
        self.criterion_value(gp, new_X=new_X, new_y=new_y, pred_y=pred_y)
        return self.n_pred > self.ncorrect

    def score_offbatch(self, gp, new_y=None, pred_y=None):
        """Score non-acquisition truth evals (convergence-audit and
        calibration spend) as streak evidence, under the SAME tolerance
        rule as acquisition evals — without recording a per-check
        criterion value (the values series is keyed to convergence
        checks).  An audited point the surrogate predicted right is
        evidence exactly like an acquired one; a miss resets the streak
        just as honestly.  Closes the flat_base_spike starvation: runs
        that spend most of their budget on audit/exploration evals can
        still earn the declaration from the evals they DID spend."""
        new_y = np.atleast_1d(new_y) if new_y is not None else np.array([])
        pred_y = np.atleast_1d(pred_y) if pred_y is not None \
            else np.array([])
        for yn, yl in zip(new_y, pred_y):
            if yn == -np.inf or not np.isfinite(yl):
                continue
            thres = abs(yn - gp.y_max) * self.reltol + self.abstol
            if abs(yl - yn) < thres:
                self.n_pred += 1
            else:
                self.n_pred = 0


class GaussianKL(ConvergenceCriterion):
    """
    KL divergence between Gaussian approximations of consecutive surrogate
    posteriors below ``limit`` (2e-2) for ``limit_times`` (max(2, d))
    consecutive
    checks (reference: gpry/convergence.py:258-540).

    Mean/cov come from the acquisition engine's last MC sample (NORA), or
    are estimated by the on-device ensemble MCMC.
    """

    _default_policy = "s"

    def __init__(self, prior_bounds, params=None):
        params = params or {}
        super().__init__(prior_bounds, params)
        self.limit_value = float(params.get("limit", 2e-2))
        # Default max(2, d), not the reference's bare d: its own code
        # comments that the count "needs to at least encompass 2 full MC
        # samples" (reference: gpry/convergence.py:302, a standing TODO
        # there).  At d=1 the reference default lets a SINGLE stable-KL
        # check declare convergence mid-climb (observed on the 1-D
        # flat-base spike fixture: converged at 11 evals with the spike
        # top still unlearned).  An explicit user value is honored as-is.
        self.limit_times = int(params.get("limit_times", max(2, self.d)))
        self.n_steps = int(params.get(
            "n_draws_per_dimsquared", 10) * self.d ** 2)
        # reject mean/cov from unconverged fallback MCMC (split-R-hat gate;
        # the reference relies on Cobaya's R-1 for the same purpose)
        self.rhat_limit = float(params.get("rhat_limit", 0.2))
        self.mean, self.cov = None, None
        self._n_good = 0

    @property
    def limit(self):
        return self.limit_value

    def _get_new_mean_and_cov(self, gp, acquisition=None):
        if acquisition is not None and \
                getattr(acquisition, "mean", None) is not None and \
                getattr(acquisition, "cov", None) is not None:
            return np.asarray(acquisition.mean), np.asarray(acquisition.cov)
        # On-device MCMC over the surrogate.
        from gpry_tpu.mc.samples import mc_sample_from_gp
        try:
            s = mc_sample_from_gp(
                gp, bounds=self.prior_bounds, sampler="mcmc",
                rng=getattr(self, "rng", None),
                options={"n_steps": max(500, self.n_steps)})
        except Exception as excpt:
            raise ConvergenceCheckError(
                f"MC estimation of mean/cov failed: {excpt}") from excpt
        X = s["X"]
        if len(X) < 2 * self.d:
            raise ConvergenceCheckError("Too few MC samples for mean/cov.")
        rhat = s.get("rhat")
        if rhat is not None and not (rhat - 1.0 < self.rhat_limit):
            raise ConvergenceCheckError(
                f"Fallback MCMC unconverged (split-R-hat = {rhat:.3f} > "
                f"{1 + self.rhat_limit:.2f}); mean/cov unreliable.")
        return X.mean(axis=0), np.cov(X.T, ddof=1).reshape(self.d, self.d)

    def criterion_value(self, gp, gp_2=None, acquisition=None, **kwargs):
        mean_new, cov_new = self._get_new_mean_and_cov(
            gp, acquisition=acquisition)
        if self.mean is None:
            self.mean, self.cov = mean_new, cov_new
            self._record(gp, np.nan)
            raise ConvergenceCheckError(
                "First iteration: no previous mean/cov to compare with.")
        try:
            kl = max(kl_norm(mean_new, cov_new, self.mean, self.cov), 0.0)
        except np.linalg.LinAlgError as excpt:
            self._record(gp, np.nan)
            raise ConvergenceCheckError(
                f"Singular covariance in KL: {excpt}") from excpt
        self.mean, self.cov = mean_new, cov_new
        self._record(gp, kl)
        return kl

    def is_converged(self, gp, gp_2=None, new_X=None, new_y=None,
                     pred_y=None, acquisition=None):
        try:
            kl = self.criterion_value(gp, acquisition=acquisition)
        except ConvergenceCheckError:
            self._n_good = 0
            raise
        if np.isfinite(kl) and kl < self.limit_value:
            self._n_good += 1
        else:
            self._n_good = 0
        return self._n_good >= self.limit_times


class GaussianKLTrain(GaussianKL):
    """
    GaussianKL variant comparing the surrogate's Gaussian approximation with
    one estimated from the training set (reference: gpry/convergence.py:543).
    """

    def criterion_value(self, gp, gp_2=None, acquisition=None, **kwargs):
        mean_new, cov_new = self._get_new_mean_and_cov(
            gp, acquisition=acquisition)
        try:
            mean_train, cov_train = mean_covmat_from_evals(
                gp.X_train, gp.y_train)
            kl = max(kl_norm(mean_train, cov_train, mean_new, cov_new), 0.0)
        except Exception as excpt:
            self._record(gp, np.nan)
            raise ConvergenceCheckError(
                f"Training mean/cov failed: {excpt}") from excpt
        self.mean, self.cov = mean_new, cov_new
        self._record(gp, kl)
        return kl


class TrainAlignment(GaussianKL):
    """
    Credibility (under the surrogate's Gaussian approximation) of the
    training-set mean: must be < limit (0.5) — a sanity check against
    sampling a plateau/overshoot instead of the mode mapped by training
    (reference: gpry/convergence.py:640-752).
    """

    _default_policy = "n"

    def __init__(self, prior_bounds, params=None):
        params = dict(params or {})
        params.setdefault("limit", 0.5)
        params.setdefault("limit_times", 1)
        self.frac_training = params.get("frac_training", 1)
        super().__init__(prior_bounds, params)
        self.limit_times = int(params["limit_times"])
        self.limit_value = float(params["limit"])

    def criterion_value(self, gp, gp_2=None, acquisition=None, **kwargs):
        mean_new, cov_new = self._get_new_mean_and_cov(
            gp, acquisition=acquisition)
        try:
            nfrac = max(1, int(gp.n * self.frac_training))
            mean_train = mean_covmat_from_evals(
                gp.X_train[-nfrac:], gp.y_train[-nfrac:])[0]
            diff = mean_new - mean_train
            chi2 = float(diff @ np.linalg.inv(cov_new) @ diff)
            if not np.isfinite(chi2) or chi2 < -1e-6:
                # a degenerate/indefinite sample covariance (e.g. from a
                # collapsed reweighted sample) makes the quadratic form
                # meaningless: fail the CHECK, don't propagate NaN
                raise ValueError(
                    f"indefinite sample covariance (chi2={chi2})")
            eps = max(credibility_of_nstd(np.sqrt(max(chi2, 0.0)),
                                          self.d), 1e-3)
        except Exception as excpt:
            self._record(gp, np.nan)
            raise ConvergenceCheckError(
                f"Train-alignment computation failed: {excpt}") from excpt
        self.mean, self.cov = mean_new, cov_new
        self._record(gp, eps)
        return eps

    def is_converged(self, gp, gp_2=None, new_X=None, new_y=None,
                     pred_y=None, acquisition=None):
        eps = self.criterion_value(gp, acquisition=acquisition)
        return bool(np.isfinite(eps) and eps < self.limit_value)
