"""
NORA: Nested sampling Optimization of the Ranked Acquisition.

Reference behavior: gpry/gp_acquisition.py:525-1191 (the engine of
arXiv:2305.19267): instead of gradient-ascending the acquisition, run a
nested sampler over the *surrogate* posterior, evaluate the acquisition on
the (dead + live) NS sample, and pick a Kriging-believer batch with a
ranked pool.  The NS sample doubles as the surrogate MC sample used for the
GaussianKL convergence criterion and mean/cov estimates.

Device mapping (vs the reference's PolyChord-over-MPI):

* The NS run is the on-device vectorized sampler (mc.nested) — the same
  fallback chain (polychord -> ultranest, gpry/gp_acquisition.py:650-682)
  is kept behind ``sampler=`` for hosts with those packages, with
  ``"device"`` the default.
* The acquisition sweep over thousands of NS points is ONE batched jitted
  call (the reference strided-splits it over MPI ranks,
  gpry/gp_acquisition.py:1110-1125).
* Sample reuse between NS runs (every ``mc_every`` iterations) reweights
  the stored sample under the updated GP with one batched predict
  (gpry/gp_acquisition.py:875-919).
* NS effort follows the reference schedule: ``nlive = min(3 n_train,
  nlive_max)`` (bucketed to limit recompiles), ``num_repeats = 5d``,
  ``precision_criterion = 0.01`` (gpry/gp_acquisition.py:684-699).
"""

import numpy as np

import jax
import jax.numpy as jnp

from gpry_tpu.acquisition.base import GenericGPAcquisition
from gpry_tpu.acquisition.ranked_pool import RankedPool
from gpry_tpu.mc.nested import run_nested_device
from gpry_tpu.models.gp import surrogate_predict
from gpry_tpu.utils.tools import (check_and_return_bounds,
                                  mean_covmat_from_samples)


class NORA(GenericGPAcquisition):
    """
    Reference-compatible constructor (gpry/gp_acquisition.py:584-634):
    defaults ``mc_every="1d"``, ``nlive_per_training=3``,
    ``nlive_max="25d"``, ``num_repeats="5d"``,
    ``precision_criterion_target=0.01``.
    """

    def __init__(self, bounds, acq_func="LogExp", mc_every="1d",
                 nlive_per_training=3, nlive_max="25d", num_repeats="5d",
                 precision_criterion_target=0.01, nprior_per_nlive=10,
                 min_ess_reuse="2d", sampler="device", preprocessing_X=None,
                 zeta_scaling=0.85, verbose=1, rng=None):
        super().__init__(bounds, acq_func=acq_func,
                         preprocessing_X=preprocessing_X,
                         zeta_scaling=zeta_scaling, verbose=verbose)
        self.mc_every = self._parse_dim_spec(mc_every, "mc_every")
        # Reweighting-collapse guard (beyond the reference, which reuses
        # blindly, gpry/gp_acquisition.py:875-919): if the effective sample
        # size of the REWEIGHTED sample drops below this, the surrogate has
        # moved too far since the last NS run — its moments and ranking are
        # garbage (observed at d=16: ESS 3 of 5412 after 9 reuses) — so
        # force a fresh NS run.  NS is cheap on-device, so the guard costs
        # little and is inert at low d where reuse stays healthy.
        self.min_ess_reuse = self._parse_dim_spec(min_ess_reuse,
                                                  "min_ess_reuse")
        self.nlive_per_training = int(nlive_per_training)
        self.nlive_max = self._parse_dim_spec(nlive_max, "nlive_max")
        self.num_repeats = self._parse_dim_spec(num_repeats, "num_repeats")
        self.precision_criterion_target = float(precision_criterion_target)
        self.nprior_per_nlive = int(nprior_per_nlive)
        self.sampler = sampler
        self.rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)
        self._iter_since_mc = None  # None -> force MC at first call
        self.last_MC_X = None
        self.last_MC_logp = None
        self.last_MC_logw = None
        self.last_MC_sigma = None
        self._proposed = np.empty((0, self.d))
        self.mean = None
        self.cov = None
        self.last_logZ = None

    def force_resample(self):
        """Discard the cached NS sample: the next acquisition call runs a
        fresh nested-sampling sweep instead of reweighting the last one.
        Public hook for benchmarks/drivers that need per-iteration NS cost
        (the reuse heuristic would otherwise amortize it away)."""
        self._iter_since_mc = None

    # -- NS effort schedule (reference: gpry/gp_acquisition.py:684-699) ------

    def _nlive(self, gpr):
        nlive = min(self.nlive_per_training * max(gpr.n, 1), self.nlive_max)
        # bucket to limit jit recompiles: quarters of nlive_max
        quarter = max(1, self.nlive_max // 4)
        return int(min(self.nlive_max,
                       max(quarter, int(np.ceil(nlive / quarter)) * quarter)))

    # ------------------------------------------------------------- NS running

    def _surrogate_sweep_params(self, gpr):
        # sweep dtype policy: models/gp.py:sweep_dtype
        return gpr.sweep_params()

    def _run_ns(self, gpr):
        from gpry_tpu.mc.samples import surrogate_logp_fn
        if self.sampler not in (None, "device"):
            # Host engine (polychord/ultranest/nessai) with the reference's
            # fallback chain (gpry/gp_acquisition.py:650-682), extended by
            # the always-available on-device sampler.
            from gpry_tpu.mc.interfaces import (InterfaceDevice,
                                                init_nested_sampler)
            iface = init_nested_sampler(self.sampler, verbose=self.verbose)
            if not isinstance(iface, InterfaceDevice):
                return self._run_ns_host(gpr, iface)
        p = self._surrogate_sweep_params(gpr)
        # NS proposal loop in f32 only when asked for — the final sample is
        # then re-scored in the sweep dtype below (models/gp.py:
        # ns_proposal_params)
        from gpry_tpu.models.gp import ns_proposal_params
        p_ns, corrected = ns_proposal_params(
            p, gpr.f32_sweep_error_estimate())
        ndt = p_ns.X.dtype
        lo = jnp.asarray(self.bounds[:, 0], ndt)
        hi = jnp.asarray(self.bounds[:, 1], ndt)
        nlive = self._nlive(gpr)
        max_dead = int(nlive * max(8, 2 * self.d))
        key = jax.random.PRNGKey(int(self.rng.integers(2**31)))
        # DP-shard the per-step chain batch over the available mesh (the
        # analogue of PolyChord's MPI-parallel live-point evolution)
        from gpry_tpu.parallel.mesh import available_mesh
        mesh = available_mesh(p_ns.X)
        res = run_nested_device(
            surrogate_logp_fn(gpr.family), p_ns, key, lo, hi, nlive=nlive,
            num_repeats=int(self.num_repeats),
            precision_criterion=self.precision_criterion_target,
            max_dead=max_dead, mesh=mesh,
            n_prior=int(self.nprior_per_nlive) * nlive)
        gpr.n_eval += int(res.n_calls)
        logw = np.asarray(res.logw, dtype=float)
        keep = np.isfinite(logw) & np.isfinite(np.asarray(res.logl))
        X = np.asarray(res.X, dtype=float)[keep]
        logp = np.asarray(res.logl, dtype=float)[keep]
        logw = logw[keep]
        # sweep-dtype mean + std over the sample (one batched,
        # mesh-sharded call; the reference strided-splits this over MPI
        # ranks, gpry/gp_acquisition.py:1110-1125)
        from gpry_tpu.parallel.mesh import predict_maybe_sharded
        mu, sd = predict_maybe_sharded(gpr.family, p,
                                       jnp.asarray(X, p.X.dtype))
        logZ = float(res.logZ)
        if corrected:
            # importance-correct the f32-proposed sample to the exact
            # density: w *= exp(logp_exact - logp_f32), and shift the
            # evidence by the same total-mass ratio so both NS paths
            # (here and mc/samples.py) report consistent logZ
            mu = np.asarray(mu, dtype=float)
            from scipy.special import logsumexp
            logw_old = logw
            with np.errstate(invalid="ignore"):
                logw = logw + (mu - logp)
            logw = np.where(np.isfinite(logw), logw, -np.inf)
            logp = mu
            if np.any(np.isfinite(logw)) and np.any(np.isfinite(logw_old)):
                logZ += float(logsumexp(logw) - logsumexp(logw_old))
        self.last_MC_X = X
        self.last_MC_logp = logp
        self.last_MC_logw = logw
        self.last_MC_sigma = np.asarray(sd)
        self.last_logZ = logZ
        self.log(f"[NORA] NS run: {len(X)} samples, nlive={nlive}, "
                 f"logZ={self.last_logZ:.3f}, calls={int(res.n_calls)}",
                 level=3)

    def _run_ns_host(self, gpr, iface):
        """NS via a host engine adapter; the surrogate likelihood it calls
        is one batched jitted device predict per request."""
        from gpry_tpu.models.gp import surrogate_predict_mean
        p = self._surrogate_sweep_params(gpr)
        dt = p.X.dtype

        def logp_host(X):
            X = np.atleast_2d(np.asarray(X, dtype=float))
            return np.asarray(surrogate_predict_mean(
                gpr.family, p, jnp.asarray(X, dt)), dtype=float)

        nlive = self._nlive(gpr)
        iface.set_prior(self.bounds)
        iface.set_precision(
            nlive=nlive, num_repeats=int(self.num_repeats),
            precision_criterion=self.precision_criterion_target,
            nprior=int(self.nprior_per_nlive) * nlive,
            seed=int(self.rng.integers(2**31)))
        res = iface.run(logp_host)
        X = np.asarray(res["X"], dtype=float)
        logp = np.asarray(res["logpost"], dtype=float)
        w = np.asarray(res["weights"], dtype=float)
        keep = np.isfinite(logp) & (w > 0)
        X, logp, w = X[keep], logp[keep], w[keep]
        gpr.n_eval += int(res.get("n_calls", len(X)))
        from gpry_tpu.parallel.mesh import predict_maybe_sharded
        _, sd = predict_maybe_sharded(gpr.family, p, jnp.asarray(X, dt))
        self.last_MC_X = X
        self.last_MC_logp = logp
        self.last_MC_logw = np.log(w / np.max(w))
        self.last_MC_sigma = np.asarray(sd)
        self.last_logZ = float(res.get("logZ", np.nan))
        self.log(f"[NORA] host NS run ({type(iface).__name__}): {len(X)} "
                 f"samples, nlive={nlive}, logZ={self.last_logZ:.3f}",
                 level=3)

    def _reweight_last(self, gpr):
        """Reuse the stored NS sample under the updated GP
        (reference: gpry/gp_acquisition.py:875-919)."""
        p = gpr.surrogate_params()
        dt = p.X.dtype
        from gpry_tpu.parallel.mesh import predict_maybe_sharded
        mu, sd = predict_maybe_sharded(gpr.family, p,
                                       jnp.asarray(self.last_MC_X, dt))
        mu = np.asarray(mu)
        with np.errstate(invalid="ignore"):
            logw = self.last_MC_logw + (mu - self.last_MC_logp)
        # points newly gated to -inf under the updated GP produce
        # -inf - -inf = nan: they carry no posterior mass now
        self.last_MC_logw = np.where(np.isfinite(logw), logw, -np.inf)
        self.last_MC_logp = mu
        self.last_MC_sigma = np.asarray(sd)
        gpr.n_eval += len(mu)

    def _reweight_ess(self):
        """Kish effective sample size of the current (reweighted) sample."""
        logw = self.last_MC_logw
        if logw is None or not np.any(np.isfinite(logw)):
            return 0.0
        w = np.exp(logw - np.max(logw[np.isfinite(logw)]))
        w = np.where(np.isfinite(w), w, 0.0)
        s = w.sum()
        if s <= 0:
            return 0.0
        return float(s * s / np.sum(w * w))

    # ----------------------------------------------------------------- multi_add

    def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                  force_resample=False):
        """
        Propose ``n_points`` Kriging-believer points from the ranked NS
        sample (reference: gpry/gp_acquisition.py:971-1108).
        ``force_resample`` forces a fresh NS run even mid ``mc_every``
        cadence (the Runner sets it after a starved acquisition,
        gpry/gp_acquisition.py:1023).
        """
        if rng is not None and isinstance(rng, np.random.Generator):
            self.rng = rng
        if force_resample:
            self._iter_since_mc = None
        if bounds is not None:
            b = check_and_return_bounds(bounds)
            bounds_changed = not np.allclose(b, self.bounds)
            if bounds_changed:
                self.bounds = b
                self._iter_since_mc = None  # force resample
        # 1. fresh NS sample or reweighted reuse
        if (self._iter_since_mc is None
                or self._iter_since_mc >= self.mc_every
                or self.last_MC_X is None or len(self.last_MC_X) == 0):
            self._run_ns(gpr)
            self._iter_since_mc = 0
            self._proposed = np.empty((0, self.d))
        else:
            self._reweight_last(gpr)
            ess = self._reweight_ess()
            if ess < self.min_ess_reuse:
                self.log(f"[NORA] reweighted ESS {ess:.1f} < "
                         f"{self.min_ess_reuse}: forcing a fresh NS run.",
                         level=3)
                self._run_ns(gpr)
                self._iter_since_mc = 0
                self._proposed = np.empty((0, self.d))
        self._iter_since_mc += 1

        # Degenerate NS outcome: every sample gated to -inf (e.g. the SVM
        # or trust region classifies essentially everywhere dead early
        # on).  Return an EMPTY proposal instead of crashing on zero-size
        # reductions — the Runner's starvation path then retries with
        # force_resample and gives up gracefully after its budget.
        if (self.last_MC_X is None or len(self.last_MC_X) == 0
                or not np.any(np.isfinite(self.last_MC_logw))):
            self.log("[NORA] NS produced no finite-weight samples; "
                     "returning an empty proposal.", level=2)
            self.mean, self.cov = None, None
            return (np.empty((0, self.d)), np.empty(0), np.empty(0))

        X = self.last_MC_X
        y = self.last_MC_logp
        sd = self.last_MC_sigma

        # mean/cov of the surrogate posterior from the weighted sample
        w = np.exp(self.last_MC_logw - np.max(self.last_MC_logw))
        try:
            self.mean, self.cov = mean_covmat_from_samples(X, w)
        except Exception:
            self.mean, self.cov = None, None

        # 2. drop already-proposed points (gpry/gp_acquisition.py:1037-1047)
        if len(self._proposed):
            fresh = ~np.any(
                np.all(np.isclose(X[:, None, :], self._proposed[None],
                                  atol=1e-12), axis=-1), axis=-1)
            X, y, sd = X[fresh], y[fresh], sd[fresh]

        # 3. acquisition over the sample (one batched evaluation).
        # noise_std = the acquisition function's own convention — mean
        # noise std by default, or an explicit LogExp(sigma_n=...) override
        # (reference: gpry/acquisition_functions.py:973-983).
        noise_std = self.acq_func._noise_std(gpr)
        from gpry_tpu.acquisition.functions import acq_values_jit
        acq_fn = lambda yy, ss: np.asarray(acq_values_jit(
            self.acq_func, jnp.asarray(yy), jnp.asarray(ss), gpr.y_max,
            noise_std))
        # Bucket the sweep length to multiples of 256: the NS sample length
        # varies run to run, and every distinct shape costs fresh per-op
        # compiles.  -inf mean padding is acquisition-neutral (values()
        # maps it to -inf).
        npts = len(y)
        pad = (-npts) % 256
        if pad:
            acq = acq_fn(np.concatenate([y, np.full(pad, -np.inf)]),
                         np.concatenate([sd, np.ones(pad)]))[:npts]
        else:
            acq = acq_fn(y, sd)

        # 4. ranked-pool Kriging-believer selection
        pool = RankedPool(n_points, gpr, acq_fn, verbose=self.verbose,
                          acqf=self.acq_func)
        pool.add(X, y=y, sigma=sd, acq=acq, method="bulk")
        X_out, y_lies, acq_out = pool.get()
        self._proposed = np.vstack([self._proposed, X_out]) \
            if len(self._proposed) else np.copy(X_out)
        return X_out, y_lies, acq_out

    # -------------------------------------------------------------- accessors

    def last_MC_sample(self):
        """(X, logp, weights) of the last surrogate NS sample
        (reference: gpry/gp_acquisition.py:921-954)."""
        if self.last_MC_X is None:
            raise ValueError("No NS sample available yet.")
        if len(self.last_MC_X) == 0 or \
                not np.any(np.isfinite(self.last_MC_logw)):
            raise ValueError("The last NS sample is empty (all samples "
                             "gated to -inf).")
        w = np.exp(self.last_MC_logw - np.max(self.last_MC_logw))
        return self.last_MC_X, self.last_MC_logp, w

    def last_MC_sample_getdist(self, params=None):
        from gpry_tpu.mc.samples import samples_dict_to_getdist
        X, logp, w = self.last_MC_sample()
        return samples_dict_to_getdist(
            {"X": X, "logpost": logp, "weights": w}, params=params)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["rng"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.rng is None:
            self.rng = np.random.default_rng()
        # checkpoints written before the reweighting-collapse guard
        if "min_ess_reuse" not in state:
            self.min_ess_reuse = self._parse_dim_spec("2d", "min_ess_reuse")
