"""
The Runner: the user-facing active-learning driver.

Reference surface: gpry/run.py (1935 LoC).  Same API and loop structure —
initial truth sampling, then acquire / evaluate / fit / check-convergence
until converged or budget exhausted, then a final MC run on the surrogate —
with an accelerator-first division of labor: the host runs only this outer loop,
truth evaluation and I/O; every numeric phase (acquisition optimization,
GP fits, convergence MC) is a batched jitted device computation.

Defaults follow gpry/run.py:531-537: n_initial=3d, max_initial=30d^1.5,
max_total=70d^1.5, n_points_per_acq=d, fit_full_every=2*sqrt(d) (full
multi-restart fit), fit_simple_every=1.
"""

import os
import time

import numpy as np

from gpry_tpu import io as gio
from gpry_tpu.acquisition.base import GenericGPAcquisition
from gpry_tpu.acquisition.batch_optimizer import BatchOptimizer
from gpry_tpu.acquisition.nora import NORA
from gpry_tpu.convergence import (ConvergenceCheckError,
                                  ConvergenceCriterion, CorrectCounter,
                                  DontConverge, GaussianKL, TrainAlignment,
                                  construct_criterion)
from gpry_tpu.models.gp import GaussianProcessRegressor
from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y
from gpry_tpu.parallel import TruthExecutor, get_random_generator
from gpry_tpu.progress import Progress, Timer, TimerCounter
from gpry_tpu.acquisition import proposal as proposal_module
from gpry_tpu.truth import get_truth
from gpry_tpu.utils.tools import (check_candidates, credibility_of_nstd,
                                  gaussian_distance, get_Xnumber, kl_norm,
                                  mean_covmat_from_samples)

_VERBOSITY_ERROR, _VERBOSITY_WARN, _VERBOSITY_INFO = 1, 2, 3
_VERBOSITY_DEBUG = 4


class Runner:
    """
    Drives the full GP-surrogate characterization of a log-posterior
    (reference: gpry/run.py:36-197 for the argument documentation).
    """

    def __init__(self, loglike=None, bounds=None, ref_bounds=None,
                 params=None, gpr="RBF", gp_acquisition="LogExp",
                 initial_proposer="reference", convergence_criterion=None,
                 callback=None, callback_is_MPI_aware=False, options=None,
                 checkpoint=None, load_checkpoint=None, seed=None, mc=None,
                 plots=False, verbose=3, truth_executor="serial"):
        self.verbose = verbose
        self.rng = get_random_generator(seed)
        self.callback = callback
        self.callback_is_MPI_aware = callback_is_MPI_aware
        self.checkpoint = checkpoint
        self.plots = plots
        self._mc_options = self._construct_mc_options(mc)
        self.last_mc_result = None
        self._mc_at_n_total = -1
        self.fiducial_point = None
        self.fiducial_MC = None
        self.has_converged = False
        self.current_iteration = 0
        self.mean, self.cov = None, None
        # starved-acquisition exploration fallback state (see
        # _starved_exploration_batch); persisted in the checkpoint's
        # _runtime dict so a resumed run continues the same Sobol net.
        self._n_explored = 0
        self._explore_net_i = 0
        self._explore_seed = None
        # True once exploration ever fired while the surrogate was FLAT:
        # such a run was blind at some point, so convergence is not
        # accepted until the whole Sobol net is spent (the net's
        # resolution is the insurance against a structure the blind
        # phase may have only grazed, e.g. a spike's tail).
        self._flat_explored = False
        # mode-aware convergence state (see _convergence_audit and the
        # mode-signature veto in _run_main_loop): truth evals spent on
        # audits, and the acquisition sample's mode signature at the
        # previous / current convergence check
        self._n_audited = 0
        self._mode_sig_hist = []
        self._mode_sig_now = None
        self._last_modes = None
        # box-normalized coordinates of audit picks: regions audited once
        # (and found empty) are masked for the rest of the run
        self._X_audit_hist = []
        self._audit_calib = (0.0, 0.0)  # (amp, y_floor) from last screen
        # dirty-screen vetoes since the last actual finding: the veto may
        # fire once to force one more acquisition+audit cycle, but a
        # screen that stays dirty WITHOUT ever yielding a finding is
        # evidence of false positives (huge-amplitude GPs on heavy-tailed
        # targets can never "rule out" the far field at kappa sigma), not
        # of missed mass
        self._audit_dirty_vetoes = 0
        # consecutive mode-signature vetoes since the last stable
        # signature or real finding: the veto is capped (max_mode_vetoes)
        # so a borderline cluster oscillating across detect_modes'
        # min_weight threshold cannot veto convergence forever and
        # silently convert a convergent run into budget exhaustion
        self._mode_veto_streak = 0

        # -- checkpoint resume -------------------------------------------------
        resuming = False
        if checkpoint is not None:
            if load_checkpoint not in ("resume", "overwrite"):
                raise ValueError(
                    "When a checkpoint path is given, load_checkpoint must "
                    "be 'resume' or 'overwrite'.")
            if load_checkpoint == "resume":
                found = gio.check_checkpoint(checkpoint)
                resuming = bool(np.all(found))
                if np.any(found) and not resuming:
                    raise RuntimeError(
                        f"Incomplete checkpoint at {checkpoint}: found "
                        f"{found}. Delete it or use 'overwrite'.")
            else:
                # overwrite: remove stale files now — saves skip tru.pkl
                # when present, so a leftover truth from a previous run
                # would otherwise survive and poison a later resume.
                # Main process only: under mpirun every rank constructs a
                # Runner, and a slow rank reaching this line after rank 0
                # has already saved iteration checkpoints would delete
                # live state out from under the driving loop.
                from gpry_tpu import mpi
                if mpi.is_main_process:
                    gio.clear_checkpoint(checkpoint)

        if resuming:
            self.log("Resuming from checkpoint...", _VERBOSITY_INFO)
            (self.truth, self.gpr, self.acquisition,
             self.convergence_criterion, self.options,
             self.progress) = gio.read_checkpoint(checkpoint)
            if loglike is not None and not callable(
                    getattr(self.truth, "_loglike_orig", None)):
                self.truth = get_truth(loglike, bounds=bounds,
                                       params=params, ref_bounds=ref_bounds)
            # Restore loop runtime state so a resumed run is equivalent to
            # an uninterrupted one: the iteration counter (drives the
            # fit_full_every cadence) and the RNG stream.
            runtime = self.options.pop("_runtime", None) \
                if isinstance(self.options, dict) else None
            if runtime:
                self.current_iteration = int(
                    runtime.get("current_iteration", 0))
                self.has_converged = bool(
                    runtime.get("has_converged", False))
                rng_state = runtime.get("rng_state")
                if rng_state is not None and seed is None:
                    self.rng.bit_generator.state = rng_state
                self._n_explored = int(runtime.get("n_explored", 0))
                # pre-split checkpoints stored one counter doing both jobs
                self._explore_net_i = int(
                    runtime.get("explore_net_i", self._n_explored))
                self._explore_seed = runtime.get("explore_seed")
                self._flat_explored = bool(
                    runtime.get("flat_explored", False))
                self._n_audited = int(runtime.get("n_audited", 0))
                self._audit_dirty_vetoes = int(
                    runtime.get("audit_dirty_vetoes", 0))
                self._mode_veto_streak = int(
                    runtime.get("mode_veto_streak", 0))
                self._mode_sig_hist = [
                    (s[0], tuple(s[1]))
                    for s in runtime.get("mode_sig_hist", [])]
                self._X_audit_hist = [
                    np.asarray(x) for x in
                    runtime.get("audit_hist", [])]
            self._load_options(self.options)
            # Re-link the single RNG stream into components that drop
            # theirs on pickling.
            if hasattr(self.acquisition, "rng"):
                self.acquisition.rng = self.rng
            if hasattr(self.gpr, "_rng"):
                self.gpr._rng = self.rng
        else:
            if loglike is None:
                raise ValueError("'loglike' is required unless resuming.")
            self.truth = get_truth(loglike, bounds=bounds, params=params,
                                   labels=None, ref_bounds=ref_bounds)
            self.options = self._construct_options(options)
            self._load_options(self.options)
            self.gpr = self._construct_gpr(gpr)
            self.acquisition = self._construct_gp_acquisition(gp_acquisition)
            self.convergence_criterion = \
                self._construct_convergence_criterion(convergence_criterion)
            self.progress = Progress()
        # The proposer is rebuilt in both paths (it holds a live reference
        # to the truth, which checkpoints only as a re-init dict).
        self.initial_proposer = self._construct_initial_proposer(
            initial_proposer)
        # One RNG stream for everything, both fresh and resumed: the
        # criteria's fallback-MCMC mean/cov estimates must ride the run's
        # seeded stream (a pickled Generator in con.pkl would be a COPY,
        # diverging from the Runner's on resume).
        for _cc in self.convergence_criterion:
            _cc.rng = self.rng
        # string mode, or a spec dict: {"mode": "processes",
        # "max_workers": 8} / {"processes": {"max_workers": 8}}
        if isinstance(truth_executor, dict):
            spec = dict(truth_executor)
            if "mode" in spec:
                mode = spec.pop("mode")
            else:
                (mode, kwargs), = spec.items()
                spec = dict(kwargs or {})
            self.executor = TruthExecutor(self.truth, mode=mode, **spec)
        else:
            self.executor = TruthExecutor(self.truth, mode=truth_executor)
        self._resumed = resuming
        # hang-watchdog liveness ticks from inside long fits (see
        # _touch_liveness); set on both the fresh and the resumed GPR.
        # A partial over the path (not a bound method) keeps the GPR
        # checkpoint-picklable without dragging the Runner along.
        from functools import partial
        self.gpr.liveness_callback = partial(_touch_liveness_file,
                                             self.checkpoint)

    # -------------------------------------------------------------- logging

    def log(self, msg, level=_VERBOSITY_INFO):
        if self.verbose >= level:
            print(msg)

    def banner(self, msg):
        self.log("+" + "=" * 70 + "\n| " + msg + "\n+" + "=" * 70)

    # ------------------------------------------------------------ properties

    @property
    def d(self):
        return self.truth.d

    @property
    def model(self):
        """Cobaya Model, if the truth wraps one (API parity)."""
        return getattr(self.truth, "model", None)

    @property
    def prior_bounds(self):
        """Prior bounds of the truth (reference: gpry/run.py:600)."""
        return self.truth.prior_bounds

    @property
    def n_total_left(self):
        return self.max_total - self.gpr.n_total

    @property
    def n_finite_left(self):
        return self.max_finite - self.gpr.n

    @property
    def params(self):
        return self.truth.params

    @property
    def labels(self):
        return self.truth.labels

    # ---------------------------------------- evaluation conveniences
    # (reference: gpry/run.py:615-668)

    def logp(self, X):
        """Surrogate log-posterior at X."""
        return self.gpr.predict(np.atleast_2d(np.asarray(X, dtype=float)))

    def logL(self, X):
        """Surrogate log-likelihood at X (log-posterior minus flat
        log-prior)."""
        return self.logp(X) + self.truth.log_prior_volume

    def logp_truth(self, X):
        """True log-posterior at X (counts as truth evaluations)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        return np.array([self.truth.logp(x) for x in X])

    def logL_truth(self, X):
        """True log-likelihood at X."""
        return self.logp_truth(X) + self.truth.log_prior_volume

    def logprior(self, X):
        """Log-prior density at X."""
        return self.truth.logprior(X)

    def logpost_eval_and_report(self, X, level=_VERBOSITY_DEBUG):
        """Evaluate and return the true log-posterior at X, logging it
        (reference: gpry/run.py:654-662)."""
        self.log(f"Evaluating true posterior at\n{X}", level=level)
        logp = self.logp_truth(X)
        self.log(f"--> log(p) = {logp}", level=level)
        return logp

    # ------------------------------------------------------------ construction

    def _construct_options(self, options):
        """Defaults from gpry/run.py:521-537."""
        options = dict(options or {})
        d = self.d
        getn = lambda key, default: get_Xnumber(
            options.get(key, default), "d", d, dtype=int, varname=key)
        out = {
            "n_initial": getn("n_initial", "3d"),
            "max_initial": getn("max_initial", "30d1.5"),
            "n_points_per_acq": getn("n_points_per_acq", "d"),
            "fit_full_every": get_Xnumber(
                options.get("fit_full_every", 2 * np.sqrt(d)), "d", d,
                dtype=lambda x: int(np.ceil(x)), varname="fit_full_every"),
            "fit_simple_every": getn("fit_simple_every", 1),
            "n_resamples_before_giveup":
                int(options.get("n_resamples_before_giveup", 2)),
            # Last-resort space-filling exploration budget after starved
            # acquisitions (0 disables = the reference's give-up
            # semantics, gpry/run.py:885-911).
            "max_starved_explore": getn("max_starved_explore", "32d"),
            # Mode-aware convergence (beyond the reference, whose
            # CorrectCounter is blind to undiscovered modes): a declared
            # convergence is audited with a screening of the surrogate's
            # ungated belief over the prior box, spending up to n_audit
            # truth evals per declaration (max_audit total) on points
            # where the surrogate cannot RULE OUT top-band posterior
            # mass; finding real mass there vetoes the declaration.
            "audit": bool(options.get("audit", True)),
            "n_audit": getn("n_audit", "1d"),
            "audit_rounds": int(options.get("audit_rounds", 3)),
            "max_audit": getn("max_audit", "8d"),
            "audit_kappa": float(options.get("audit_kappa", 3.5)),
            "audit_band_nstd": float(options.get("audit_band_nstd", 4.0)),
            "mode_weight_tol": float(options.get("mode_weight_tol", 0.10)),
            "mode_stable_checks": int(options.get("mode_stable_checks", 3)),
            # cap on CONSECUTIVE signature vetoes (see the veto in
            # _run_main_loop): bounded like max_audit, so an oscillating
            # borderline cluster cannot veto forever
            "max_mode_vetoes": int(options.get("max_mode_vetoes", 6)),
            # amplitude-underfit veto: minimum fitted output scale as a
            # fraction of the finite training-y span (see
            # _surrogate_is_amp_underfit); measured separation on the
            # spike fixture: underfit seeds 0.004-0.005, healthy 0.33
            "amp_underfit_frac": float(
                options.get("amp_underfit_frac", 0.05)),
        }
        if "max_total" in options:
            out["max_total"] = getn("max_total", None)
        else:
            # default: 70 d^1.5, or max_initial if that is larger
            # (reference: gpry/run.py:533 docstring)
            out["max_total"] = max(getn("max_total", "70d1.5"),
                                   out["max_initial"])
        out["max_finite"] = getn("max_finite", out["max_total"])
        return out

    def _load_options(self, options):
        self.n_initial = options["n_initial"]
        self.max_initial = options["max_initial"]
        self.max_total = options["max_total"]
        self.max_finite = options["max_finite"]
        self.n_points_per_acq = options["n_points_per_acq"]
        self.fit_full_every = options["fit_full_every"]
        self.fit_simple_every = options["fit_simple_every"]
        self.n_resamples_before_giveup = \
            options["n_resamples_before_giveup"]
        # backfill for checkpoints written before the exploration
        # fallback existed: use the live default ("32d"), not 0, so a
        # resumed pre-feature run still gets the starvation/veto guards
        if "max_starved_explore" in options:
            self.max_starved_explore = options["max_starved_explore"]
        else:
            self.max_starved_explore = get_Xnumber(
                "32d", "d", self.d, dtype=int,
                varname="max_starved_explore")
        # backfill for pre-audit checkpoints: live defaults
        getn = lambda key, default: get_Xnumber(
            options.get(key, default), "d", self.d, dtype=int, varname=key)
        self.audit = bool(options.get("audit", True))
        self.n_audit = getn("n_audit", "1d")
        self.audit_rounds = int(options.get("audit_rounds", 3))
        self.max_audit = getn("max_audit", "8d")
        self.audit_kappa = float(options.get("audit_kappa", 3.5))
        self.audit_band_nstd = float(options.get("audit_band_nstd", 4.0))
        self.mode_weight_tol = float(options.get("mode_weight_tol", 0.10))
        self.mode_stable_checks = int(options.get("mode_stable_checks", 3))
        self.max_mode_vetoes = int(options.get("max_mode_vetoes", 6))
        self.amp_underfit_frac = float(
            options.get("amp_underfit_frac", 0.05))
        if self.n_initial <= 0:
            raise ValueError("n_initial must be > 0.")
        if self.max_initial < self.n_initial:
            raise ValueError("max_initial must be >= n_initial.")

    def _construct_gpr(self, gpr):
        """Reference defaults: gpry/run.py:306-355 (n_restarts=10+2d)."""
        if isinstance(gpr, GaussianProcessRegressor):
            return gpr
        bounds = self.truth.prior_bounds
        if isinstance(gpr, str):
            gpr = {"kernel": gpr}
        if not isinstance(gpr, dict):
            raise ValueError(f"Cannot construct GPR from {gpr!r}.")
        kwargs = dict(gpr)
        kwargs.setdefault("kernel", "RBF")
        kwargs.setdefault("n_restarts_optimizer", 10 + 2 * self.d)
        kwargs.setdefault("preprocessing_X", Normalize_bounds(bounds))
        kwargs.setdefault("preprocessing_y", Normalize_y())
        kwargs.setdefault("bounds", bounds)
        kwargs.setdefault("random_state", self.rng)
        kwargs.setdefault("verbose", self.verbose)
        self._gpr_fit_restarts = kwargs["n_restarts_optimizer"]
        return GaussianProcessRegressor(**kwargs)

    def _construct_gp_acquisition(self, spec):
        """Reference: gpry/run.py:357-404 (zeta_scaling=0.85 default)."""
        if isinstance(spec, GenericGPAcquisition):
            return spec
        bounds = self.truth.prior_bounds
        if isinstance(spec, str):
            # Acquisition-function name -> BatchOptimizer with it, or an
            # engine name.
            if spec.lower() in ("batchoptimizer", "nora"):
                spec = {spec: {}}
            else:
                spec = {"BatchOptimizer": {"acq_func": spec}}
        if not isinstance(spec, dict) or len(spec) != 1:
            raise ValueError(f"Cannot construct acquisition from {spec!r}.")
        name = list(spec)[0]
        kwargs = dict(spec[name] or {})
        kwargs.setdefault("zeta_scaling", 0.85)
        kwargs.setdefault("verbose", self.verbose)
        cls = {"batchoptimizer": BatchOptimizer, "nora": NORA}.get(
            name.lower())
        if cls is None:
            raise ValueError(f"Unknown acquisition engine '{name}'.")
        if cls is NORA:
            kwargs.setdefault("rng", self.rng)
        return cls(bounds, **kwargs)

    def _construct_initial_proposer(self, spec):
        """Reference: gpry/run.py:406-444."""
        bounds = self.truth.prior_bounds
        if isinstance(spec, proposal_module.Proposer):
            return spec
        if isinstance(spec, str):
            spec = {spec: {}}
        if not isinstance(spec, dict) or len(spec) != 1:
            raise ValueError(f"Cannot construct proposer from {spec!r}.")
        name = list(spec)[0].lower()
        kwargs = dict(spec[list(spec)[0]] or {})
        if name == "reference":
            return proposal_module.ReferenceProposer(
                bounds, truth=self.truth, **kwargs)
        if name == "prior":
            return proposal_module.PriorProposer(
                bounds, truth=self.truth, **kwargs)
        if name == "uniform":
            return proposal_module.UniformProposer(bounds, **kwargs)
        if name == "meancov":
            return proposal_module.MeanCovProposer(bounds, **kwargs)
        raise ValueError(f"Unknown initial proposer '{name}'.")

    def _construct_convergence_criterion(self, spec):
        """
        Defaults (reference: gpry/run.py:446-457): CorrectCounter for
        BatchOptimizer; CorrectCounter + GaussianKL + TrainAlignment for
        NORA.
        """
        bounds = self.truth.prior_bounds
        if spec is False:
            return [DontConverge(bounds, {})]
        if spec is None:
            criteria = [CorrectCounter(bounds, {"policy": "s"})]
            if isinstance(self.acquisition, NORA):
                criteria += [
                    GaussianKL(bounds, {"policy": "s"}),
                    TrainAlignment(bounds, {"policy": "n"}),
                ]
            return criteria
        if isinstance(spec, ConvergenceCriterion):
            return [spec]
        if isinstance(spec, (list, tuple)):
            return [construct_criterion(s, bounds) for s in spec]
        return [construct_criterion(spec, bounds)]

    def _construct_mc_options(self, mc):
        """Reference: gpry/run.py:506-519."""
        if mc is None:
            return {"sampler": "nested", "options": {}}
        if isinstance(mc, str):
            return {"sampler": mc, "options": {}}
        if isinstance(mc, dict):
            if len(mc) == 1 and list(mc)[0] not in ("sampler", "options"):
                name = list(mc)[0]
                return {"sampler": name, "options": dict(mc[name] or {})}
            return {"sampler": mc.get("sampler", "nested"),
                    "options": dict(mc.get("options") or {})}
        raise ValueError(f"Cannot parse mc spec {mc!r}.")

    # ---------------------------------------------------------------- the loop

    def run(self):
        """
        The active-learning loop (reference: gpry/run.py:776-1061).

        Under a real multi-rank MPI launch this build is
        single-controller: rank 0 runs the loop (all device parallelism is
        batched/mesh-sharded, parallel/mesh.py), the other ranks block at a
        barrier and then re-sync from the checkpoint — instead of N ranks
        silently duplicating the whole loop and racing on the checkpoint
        files.
        """
        # Opt-in device profiling (SURVEY 5.1): GPRY_TPU_PROFILE=<dir>
        # wraps the whole loop in a jax.profiler trace viewable in
        # TensorBoard/Perfetto.
        profile_dir = os.environ.get("GPRY_TPU_PROFILE")
        if profile_dir:
            import jax
            jax.profiler.start_trace(profile_dir)
            self.log(f"[PROFILE] tracing to {profile_dir}", _VERBOSITY_INFO)
        try:
            return self._run_mpi_guarded()
        finally:
            if profile_dir:
                import jax
                jax.profiler.stop_trace()

    def _run_mpi_guarded(self):
        from gpry_tpu import mpi
        if mpi.multiple_processes and not mpi.is_main_process:
            if self.executor.mode == "mpi":
                # DCN truth-evaluation worker: evaluate this rank's slice
                # of every batch rank 0 broadcasts, until the loop ends
                # (reference: gpry/run.py:1200-1236)
                self.log(f"Multi-rank MPI launch: rank {mpi.RANK} serving "
                         "truth evaluations (single-controller loop on "
                         "rank 0).", _VERBOSITY_WARN)
                self.executor.serve()
            else:
                self.log("Multi-rank MPI launch: rank 0 runs the loop; "
                         f"rank {mpi.RANK} waits (single-controller "
                         "design).", _VERBOSITY_WARN)
            mpi.sync_processes()
            if self.checkpoint is not None and \
                    bool(np.all(gio.check_checkpoint(self.checkpoint))):
                (self.truth, self.gpr, self.acquisition,
                 self.convergence_criterion, self.options,
                 self.progress) = gio.read_checkpoint(self.checkpoint)
                runtime = self.options.pop("_runtime", None)
                if runtime:
                    # mirror rank 0's final loop state so user code can
                    # read has_converged etc. on any rank
                    self.current_iteration = int(
                        runtime.get("current_iteration", 0))
                    self.has_converged = bool(
                        runtime.get("has_converged", False))
            return self
        try:
            self._run_main_loop()
        except Exception as excpt:
            # On a RETRYABLE accelerator failure, leave worker ranks
            # serving: run_resilient will rebuild a Runner on this rank
            # and its next truth broadcast must find them still in
            # serve() (stopping them here would deadlock the retry's
            # first collective).  Workers are released by the eventual
            # clean finish, or torn down with the job if rank 0 gives up.
            if mpi.multiple_processes \
                    and not is_retryable_device_error(excpt):
                self.executor.stop_workers()
                mpi.sync_processes()
            raise
        else:
            if mpi.multiple_processes:
                self.executor.stop_workers()
                mpi.sync_processes()
        return self

    def _run_main_loop(self):
        if not self._resumed and self.gpr.n_total == 0:
            self.do_initial_training()
            self._save_checkpoint()
        self.resamples = 0
        if self._resumed and self.has_converged:
            # Resumed a run that had already converged (e.g. the process
            # crashed during/after the final MC): re-run the missing MC +
            # diagnosis FIRST.  A passing diagnosis skips the loop; a veto
            # re-enters the acquisition loop below exactly as in an
            # uninterrupted run (same veto, same continuation).
            self.log("Resumed an already-converged run; re-running the "
                     "final MC and diagnosis.", _VERBOSITY_INFO)
            self.update_mean_cov()
            self.generate_mc_sample()
            if not self.diagnose_last_mc_sample():
                self.log("Diagnosis failed on resume: convergence vetoed.",
                         _VERBOSITY_WARN)
                self.has_converged = False
            self._save_checkpoint()
        else:
            self.has_converged = False
        while (self.n_total_left > 0 and self.n_finite_left > 0
               and not self.has_converged):
            self.current_iteration += 1
            it = self.current_iteration
            self.progress.add_iteration()
            self.progress.add_current_n_truth(self.gpr.n_total, self.gpr.n)
            self.banner(f"Iteration {it} "
                        f"(n_total={self.gpr.n_total}, n_finite={self.gpr.n})")
            self._touch_liveness()

            # [ACQUISITION]
            n_points = min(self.n_points_per_acq, self.n_total_left)
            with TimerCounter(self.gpr) as timer_acq:
                new_X, y_pred, acq_vals = self.acquisition.multi_add(
                    self.gpr, n_points=n_points, bounds=self.gpr.trust_bounds,
                    rng=self.rng, force_resample=self.resamples > 0)
                dup = check_candidates(self.gpr.X_train, new_X)
                new_X, y_pred = new_X[~dup], np.asarray(y_pred)[~dup]
            self.progress.add_acquisition(timer_acq)
            self._touch_liveness()
            self.log(f"[ACQUISITION] {len(new_X)} points proposed "
                     f"({timer_acq.time:.3g}s)", _VERBOSITY_INFO)
            # Starvation retry (reference: gpry/run.py:885-911): if fewer
            # than half the requested points came back, skip evaluating the
            # sub-minimal batch and force the acquisition to re-sample (NORA
            # runs a fresh NS) on the next pass, up to
            # n_resamples_before_giveup times.  Once retries are exhausted,
            # fall back to a bounded space-filling exploration batch
            # (_starved_exploration_batch) before giving up outright.
            explored_batch = False
            if len(new_X) < max(1, n_points // 2):
                self.resamples += 1
                if self.resamples > self.n_resamples_before_giveup:
                    if self._surrogate_is_flat():
                        self._flat_explored = True
                    # explore in initial-training-sized batches: the
                    # points are uninformed anyway, and batching amortizes
                    # the per-iteration NS + refit cost
                    new_X = self._starved_exploration_batch(
                        max(n_points, self.n_initial))
                    if new_X is None or len(new_X) == 0:
                        if not self.max_starved_explore:
                            why = ("exploration disabled "
                                   "(max_starved_explore=0)")
                        elif self._n_explored >= self.max_starved_explore \
                                or not self.n_total_left:
                            why = (f"exploration budget spent "
                                   f"({self._n_explored}"
                                   f"/{self.max_starved_explore})")
                        else:
                            why = ("the exploration net found no new "
                                   "points (saturated bounds)")
                        self.log("Acquisition returning no values after "
                                 f"{self.n_resamples_before_giveup} re-tries "
                                 f"and {why}. Giving up.",
                                 _VERBOSITY_ERROR)
                        break
                    explored_batch = True
                    self.log("[EXPLORATION] acquisition starved "
                             f"{self.resamples - 1}x; falling back to a "
                             f"Sobol exploration batch of {len(new_X)} "
                             f"({self._n_explored}/"
                             f"{self.max_starved_explore} budget spent)",
                             _VERBOSITY_WARN)
                else:
                    self.log("Acquisition returned less than half of the "
                             "requested points. Re-sampling (try "
                             f"{self.resamples}/"
                             f"{self.n_resamples_before_giveup})",
                             _VERBOSITY_WARN)
                    continue
            else:
                self.resamples = 0

            # [EVALUATION]
            with Timer() as timer_truth:
                new_y = self.executor.logp_batch(new_X)
            self.progress.add_truth(timer_truth, n_evals=len(new_X))
            self.log(f"[EVALUATION] truth at {len(new_X)} points "
                     f"({timer_truth.time:.3g}s)", _VERBOSITY_INFO)

            # [FIT]
            with TimerCounter(self.gpr) as timer_fit:
                self._fit_gpr(new_X, new_y)
            self.progress.add_fit(timer_fit)
            self._touch_liveness()
            self.log(f"[FIT] GPR updated, n={self.gpr.n} "
                     f"({timer_fit.time:.3g}s)", _VERBOSITY_INFO)

            # callback
            if self.callback is not None:
                self.callback(self)

            # [CONVERGENCE]
            if explored_batch:
                # Exploration points carry no acquisition information: a
                # flat surrogate trivially "predicts" them right, so
                # feeding them to CorrectCounter would let a run converge
                # on a surrogate the acquisition never probed.  Convergence
                # must be earned by acquisition-driven iterations.
                self.progress.add_convergence(Timer(), np.nan)
                self.log("[CONVERGENCE] skipped on an exploration batch "
                         "(no acquisition information).", _VERBOSITY_INFO)
            else:
                with TimerCounter(self.gpr) as timer_conv:
                    self.has_converged, conv_value = \
                        self._check_convergence(new_X, new_y, y_pred)
                self.progress.add_convergence(timer_conv, conv_value)
                self.log(f"[CONVERGENCE] value={conv_value:.3g} "
                         f"converged={self.has_converged} "
                         f"({timer_conv.time:.3g}s)", _VERBOSITY_INFO)
                # track the acquisition sample's mode signature (host-side
                # clustering of ~1k resampled points; None for engines
                # without an MC sample, e.g. BatchOptimizer)
                self._mode_sig_now = self._acquisition_mode_signature()

            self.update_mean_cov()

            # Flat-surrogate convergence veto: a surrogate with (almost) no
            # dynamic range trivially "predicts" every acquired point right
            # (the spike fixture: every point sees only the broad base), so
            # CorrectCounter can declare convergence on a posterior the run
            # never actually learned.  Before accepting it, spend the Sobol
            # exploration budget hunting for missed structure; a genuinely
            # flat likelihood just spends the (bounded) budget and then
            # converges to the uniform posterior it deserves.
            #
            # The budget is spent to EXHAUSTION even after structure is
            # found: handing the hunt off to the convergence audit early
            # was tried (round 5) and reverted — on flat_base_spike seed
            # 100 the audit's kappa-sigma screen cannot resolve a
            # 1%-of-the-box spike the Sobol net had only scented (shoulder
            # hit, top unmapped), and the run declared at 40 evals with
            # momKL 2.5.  The net IS the detector here; its budget is the
            # price of safety on structureless-until-found targets.
            if self.has_converged and (self._surrogate_is_flat()
                                       or self._flat_explored):
                if self._surrogate_is_flat():
                    self._flat_explored = True
                exp_X = self._starved_exploration_batch(
                    max(n_points, self.n_initial))
                if exp_X is not None and len(exp_X):
                    self.has_converged = False
                    why = ("on a FLAT surrogate (training span < "
                           f"{self.flat_span} log units)"
                           if self._surrogate_is_flat() else
                           "after a blind (flat-surrogate) exploration "
                           "phase with Sobol budget left")
                    self.log(f"[EXPLORATION] convergence declared {why}: "
                             f"vetoed; exploring {len(exp_X)} Sobol points "
                             f"({self._n_explored}/"
                             f"{self.max_starved_explore} budget spent)",
                             _VERBOSITY_WARN)
                    with Timer() as timer_truth:
                        exp_y = self.executor.logp_batch(exp_X)
                    self.progress.add_truth(timer_truth, n_evals=len(exp_X),
                                            accumulate=True)
                    with TimerCounter(self.gpr) as timer_fit:
                        self._fit_gpr(exp_X, exp_y)
                    self.progress.add_fit(timer_fit, accumulate=True)
                    self._touch_liveness()

            # Amplitude-underfit veto (beyond the reference): a GP whose
            # fitted output scale is a tiny fraction of its own training-y
            # span is GLOBALLY overconfident -- its posterior sd is near
            # zero everywhere, so both CorrectCounter and the kappa-sigma
            # convergence audit are structurally blind (the audit can
            # "rule out" the whole box at kappa sigma with sd ~ 0.2 on
            # data spanning 20 log units; observed on the spike fixture at
            # n=19: output scale 0.096 vs span 21.5).  Veto and spend the
            # Sobol exploration budget; once data forces a sane amplitude
            # the veto goes quiet (healthy fits sit at ratio ~ 0.3).
            if self.has_converged and self._surrogate_is_amp_underfit():
                exp_X = self._starved_exploration_batch(
                    max(n_points, self.n_initial))
                self.has_converged = False
                amp = self._fitted_amp_span_ratio()
                if exp_X is not None and len(exp_X):
                    self.log("[EXPLORATION] convergence vetoed: fitted "
                             f"output scale is {amp:.3g} of the training-y "
                             f"span (< amp_underfit_frac="
                             f"{self.amp_underfit_frac}) -- the surrogate "
                             "is globally overconfident; exploring "
                             f"{len(exp_X)} Sobol points "
                             f"({self._n_explored}/"
                             f"{self.max_starved_explore} budget spent)",
                             _VERBOSITY_WARN)
                    with Timer() as timer_truth:
                        exp_y = self.executor.logp_batch(exp_X)
                    self.progress.add_truth(timer_truth, n_evals=len(exp_X),
                                            accumulate=True)
                    with TimerCounter(self.gpr) as timer_fit:
                        self._fit_gpr(exp_X, exp_y)
                    self.progress.add_fit(timer_fit, accumulate=True)
                    self._touch_liveness()
                else:
                    # No exploration budget left but the surrogate still
                    # cannot represent its own data's dynamic range:
                    # refuse the declaration (honest non-convergence,
                    # bounded by max_total) rather than report a
                    # converged=true row from a blind GP.
                    self.log("[EXPLORATION] convergence vetoed: fitted "
                             f"output scale is {amp:.3g} of the training-y "
                             "span and the exploration budget is spent; "
                             "refusing to declare from a globally "
                             "overconfident surrogate.", _VERBOSITY_WARN)

            # Mode-signature stability veto (beyond the reference): on a
            # MULTIMODAL surrogate, convergence requires the mode count
            # and weights of the acquisition's MC sample to agree across
            # the last ``mode_stable_checks`` convergence checks — a
            # signature still in flux means mode weights (and possibly
            # the mode census) are not settled (observed round 3:
            # Himmelblau "converging" at momKL 130-822 with two of four
            # modes missing; a single-pair check still accepted at momKL
            # 0.4-0.8 two batches after a new mode was found, before its
            # weight equilibrated).  Costs no truth evals.
            if not explored_batch and self._mode_sig_now is not None:
                self._mode_sig_hist.append(self._mode_sig_now)
                del self._mode_sig_hist[:-max(self.mode_stable_checks, 1)]
            if self.has_converged and self._mode_sig_now is not None \
                    and self._mode_sig_now[0] >= 2:
                from gpry_tpu.utils.modes import modes_match
                hist = self._mode_sig_hist[-self.mode_stable_checks:]
                stable = len(hist) >= self.mode_stable_checks and all(
                    modes_match(a, b, self.mode_weight_tol)
                    for a, b in zip(hist, hist[1:]))
                if stable:
                    self._mode_veto_streak = 0
                elif self._mode_veto_streak >= self.max_mode_vetoes:
                    # Bounded veto (like max_audit): a borderline cluster
                    # oscillating across detect_modes' min_weight threshold
                    # flips the census between checks and would otherwise
                    # veto forever, converting a convergent run into
                    # silent budget exhaustion.
                    self.log("[MODES] signature still unstable after "
                             f"{self._mode_veto_streak} consecutive "
                             "vetoes (max_mode_vetoes cap): accepting "
                             "the declaration.", _VERBOSITY_WARN)
                else:
                    self._mode_veto_streak += 1
                    self.has_converged = False
                    self.log("[MODES] convergence vetoed: multimodal "
                             f"signature {self._mode_sig_now} not stable "
                             f"over the last {self.mode_stable_checks} "
                             f"checks (history: {hist[:-1]}; veto "
                             f"{self._mode_veto_streak}/"
                             f"{self.max_mode_vetoes}).",
                             _VERBOSITY_WARN)

            # Convergence audit (beyond the reference): before accepting,
            # screen the surrogate's UNGATED belief over the prior box for
            # points where top-band posterior mass cannot be ruled out at
            # kappa sigma, and spend a few truth evals on the most
            # suspicious ones.  Real mass found there (an undiscovered
            # mode, a spike) vetoes the declaration and feeds the GP.
            if self.has_converged and self.audit:
                if not self._convergence_audit():
                    self.has_converged = False

            # [MC+DIAGNOSIS] on declared convergence
            if self.has_converged:
                # persist the converged state BEFORE the (long) MC step,
                # so a crash-resume skips
                # straight to re-running the MC instead of re-acquiring
                self._save_checkpoint()
                self.log("[MC+DIAGNOSIS] convergence declared; running MC "
                         "and diagnosis...", _VERBOSITY_INFO)
                self.generate_mc_sample()
                if not self.diagnose_last_mc_sample():
                    self.log("Diagnosis failed: convergence vetoed.",
                             _VERBOSITY_WARN)
                    self.has_converged = False

            self.progress.mpi_sync()
            self._save_checkpoint()
            if self.plots:
                try:
                    self.plot_progress()
                except Exception as excpt:  # plots must never kill the run
                    self.log(f"Progress plotting failed: {excpt}",
                             _VERBOSITY_WARN)

        if not self.has_converged:
            self.log("Budget exhausted (or stopped) without convergence; "
                     "running final MC anyway.", _VERBOSITY_WARN)
            # an MC from an earlier (vetoed) convergence is stale if the
            # surrogate has grown since: re-sample the CURRENT surrogate
            if (self.last_mc_result is None
                    or self._mc_at_n_total != self.gpr.n_total):
                try:
                    self.generate_mc_sample()
                    self.diagnose_last_mc_sample()
                except Exception as excpt:
                    self.log(f"Final MC failed: {excpt}", _VERBOSITY_ERROR)
        return self

    #: training-value span (in log-posterior units) below which the
    #: surrogate counts as "flat" for the exploration-before-convergence
    #: veto: any real posterior structure inside the prior box spans many
    #: e-folds, while a structureless base varies by noise only.
    flat_span = 1.0

    def _surrogate_is_flat(self):
        """True when the finite training values span less than
        ``flat_span`` log units — the surrogate carries (almost) no
        information about where the posterior mass is."""
        y = self.gpr.y_train
        return len(y) > 0 and \
            float(np.max(y) - np.min(y)) < self.flat_span

    def _feed_offbatch_convergence(self, new_y, pred_y):
        """Feed audit/calibration truth evals to criteria that keep a
        correctness streak (CorrectCounter family): points the surrogate
        predicted right count toward the declaration, misses reset it —
        the same terms acquisition evals get (VERDICT r4 item 8: the
        flat_base_spike budget is mostly audit/exploration spend, and
        discarding its evidence starved the stopping rule)."""
        for cc in self.convergence_criterion:
            fn = getattr(cc, "score_offbatch", None)
            if fn is None:
                continue
            try:
                fn(self.gpr, new_y=new_y, pred_y=pred_y)
            except Exception as excpt:
                self.log(f"off-batch convergence scoring failed: {excpt}",
                         _VERBOSITY_WARN)

    def _fitted_amp_span_ratio(self):
        """Fitted GP output scale (raw y units) over the span of the
        finite training values; ``nan`` when undefined (extended kernels
        without a plain amplitude, or degenerate spans)."""
        y = self.gpr.y_train
        if len(y) < 2:
            return np.nan
        span = float(np.max(y) - np.min(y))
        if not np.isfinite(span) or span <= 0:
            return np.nan
        try:
            amp = float(self.gpr.scales[0])
        except (ValueError, AttributeError):
            return np.nan
        return amp / span

    def _surrogate_is_amp_underfit(self):
        """True when the fitted output scale is below
        ``amp_underfit_frac`` of the finite training-y span: the GP's
        prior sd (its *maximum* posterior sd anywhere) cannot account for
        the variation in its own data, so every uncertainty-based guard
        (CorrectCounter tolerance, audit kappa-sigma screen) is blind.
        Scale-free, so inert on genuinely flat posteriors (a good fit to
        small-span data keeps the ratio O(1))."""
        ratio = self._fitted_amp_span_ratio()
        return np.isfinite(ratio) and ratio < self.amp_underfit_frac

    def _starved_exploration_batch(self, n_points):
        """Last-resort space-filling exploration after exhausted
        starvation retries.

        When the acquisition engine keeps returning (near-)empty proposals
        even after forced NS resamples -- typically because the surrogate
        is flat and the acquisition has no gradient anywhere (e.g. a
        narrow spike on a broad base, where every initial point sees only
        the base: tests/model_generator.py:spike) -- the reference gives
        up outright (gpry/run.py:885-911).  Instead, spend up to
        ``max_starved_explore`` truth evaluations on a scrambled-Sobol
        sweep of the prior bounds: exploration with zero information is a
        search problem, and a low-discrepancy net finds localized
        structure far faster than iid draws.  The sequence index and seed
        persist across batches and checkpoint/resume, so successive
        batches keep refining one space-filling net.  Returns ``None``
        when disabled (``max_starved_explore=0``) or exhausted.
        """
        n_budget = min(self.max_starved_explore - self._n_explored,
                       self.n_total_left)
        if n_budget <= 0:
            return None
        n = int(min(max(n_points, 1), n_budget))
        from scipy.stats import qmc
        if self._explore_seed is None:
            self._explore_seed = int(self.rng.integers(2 ** 31 - 1))
        eng = qmc.Sobol(self.d, scramble=True, seed=self._explore_seed)
        if self._explore_net_i:
            eng.fast_forward(self._explore_net_i)
        import warnings
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        # Budget (_n_explored, counts points actually returned for truth
        # evaluation) is separate from the net position (_explore_net_i):
        # points skipped as duplicates of existing training points advance
        # the net but cost nothing.  Redraw until the batch is full so an
        # (extremely rare) all-duplicate draw cannot masquerade as an
        # exhausted budget; bounded rounds guard a saturated net.
        out = []
        got = 0
        for _ in range(8):
            if got >= n:
                break
            with warnings.catch_warnings():
                # non-power-of-two draws are fine: the net keeps extending
                warnings.simplefilter("ignore", UserWarning)
                u = eng.random(n - got)
            self._explore_net_i += len(u)
            X = lo + u * (hi - lo)
            seen = self.gpr.X_train_all
            if out:
                seen = np.concatenate([seen] + out, axis=0)
            X = X[~check_candidates(seen, X)]
            if len(X):
                out.append(X)
                got += len(X)
        if not out:
            return np.empty((0, self.d))
        self._n_explored += got
        return np.concatenate(out, axis=0)

    def _acquisition_mode_signature(self):
        """Mode signature of the acquisition engine's current MC sample
        (None when the engine has no sample, e.g. BatchOptimizer)."""
        if not hasattr(self.acquisition, "last_MC_sample"):
            self._last_modes = None
            return None
        try:
            X, _, w = self.acquisition.last_MC_sample()
        except (ValueError, AttributeError):
            self._last_modes = None
            return None
        from gpry_tpu.utils.modes import detect_modes, mode_signature
        try:
            self._last_modes = detect_modes(X, w, rng=self.rng)
            return mode_signature(self._last_modes)
        except Exception as excpt:
            self.log(f"[MODES] mode detection failed: {excpt}",
                     _VERBOSITY_DEBUG)
            self._last_modes = None
            return None

    def _audit_screen(self, thres):
        """One audit screening pass: ungated surrogate belief over a fresh
        scrambled-Sobol net on the prior box.  Returns ``(Xs, mu, z)``
        where ``z = (thres - mu_eff)/sd`` is the in-band z-score (small
        z = plausibly-missed mass).

        ``mu_eff`` is the GP mean with its far-field reversion target
        replaced: a y-normalized GP reverts to the TRAINING-SET AVERAGE
        log-posterior far from all data — an absurd belief ("far from
        everything I know, the posterior is as good as my typical sample")
        that puts the entire far field a fraction of a sigma below the
        top band and floods the screen with false alarms, starving the
        genuinely suspicious partially-informed regions (measured on
        Himmelblau: empty corners screen at z~0.14 vs missed modes at
        z~0.7).  For auditing we revert to the WORST finite value seen
        instead, weighted by the GP's own uninformedness (sd/amp)^2 —
        the exact variance complement of the posterior-mean reversion
        weight k'K^-1k/amp^2."""
        from scipy.stats import qmc
        import warnings
        n_screen = 4096
        eng = qmc.Sobol(self.d, scramble=True,
                        seed=int(self.rng.integers(2 ** 31 - 1)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            u = eng.random(n_screen)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        Xs = lo + u * (hi - lo)
        import jax.numpy as jnp
        from gpry_tpu.models.gp import surrogate_mean_std_smooth
        p = self.gpr.sweep_params()
        mu, sd = surrogate_mean_std_smooth(
            self.gpr.family, p, jnp.asarray(Xs, p.X.dtype))
        mu, sd = np.asarray(mu, float), np.asarray(sd, float)
        amp = np.nanmax(sd[np.isfinite(sd)], initial=0.0)
        y_all = np.asarray(self.gpr.y_train, float)
        finite = np.isfinite(y_all)
        y_floor = float(np.min(y_all[finite])) if np.any(finite) \
            else self.gpr.y_max
        self._audit_calib = (amp, y_floor)
        mu_eff, z = self._audit_zscore(mu, sd, thres)
        return Xs, mu_eff, z

    def _audit_zscore(self, mu, sd, thres):
        """Floor-corrected audit belief (see _audit_screen): returns
        ``(mu_eff, z)`` given the calibration set by the last screen."""
        amp, y_floor = self._audit_calib
        if amp > 0:
            w_floor = np.clip((sd / amp) ** 2, 0.0, 1.0)
            # Reversion target: the worst finite value seen — but capped
            # a full band BELOW the suspicion threshold when the training
            # set has never bracketed the band (y_floor >= thres).  An
            # uninformed region must stay AUDITABLE: reverting it to an
            # in-band value would classify the entire unexplored far
            # field as "known mass" and wave the declaration through
            # (observed on the Spike fixture at n=20: worst seen -12 vs
            # band edge -13.9, first screen trivially clean, tails never
            # confirmed).
            band = self.gpr.y_max - thres
            target = min(y_floor, thres - band)
            mu_eff = (1.0 - w_floor) * mu + w_floor * target
        else:
            mu_eff = mu
        with np.errstate(divide="ignore", invalid="ignore"):
            z = (thres - mu_eff) / np.maximum(sd, 1e-300)
        z = np.where(np.isfinite(mu) & np.isfinite(sd), z, np.inf)
        return mu_eff, z

    def _audit_polish(self, X0, thres, margin=0.0, n_local=256,
                      sigma_frac=0.06):
        """Move each audit pick to the most UNEXPLORED plausible point of
        its region: the local argmax of sigma among cloud points that
        still pass the screen's own suspicion test (z < kappa AND
        mu_eff < thres - margin), over a Gaussian cloud around the pick
        (sigma = ``sigma_frac`` of the box span per dimension, clipped to
        the box).  One batched surrogate predict for ALL picks' clouds —
        costs no truth evals.

        Why argmin-z *within the suspicious set* and not a UCB ascent or
        argmax-sd: an unrestricted UCB drifts to whatever nearby
        direction has the largest sigma (uninformed space, away from the
        flagged region), and argmax-sd picks the deepest-uncertainty
        point — usually the floor of an empty basin, whose very low truth
        value then hardens the GP's confident no (measured: 2/3
        Himmelblau seeds regressed to momKL ~650 under max-sd).  The
        min-z point is where in-band truth is LIKELIEST under the
        floor-corrected belief; entering a missed mode through that edge
        is how every successful discovery in the battery happened.
        Returns (polished points, their effective mu)."""
        import jax.numpy as jnp
        from gpry_tpu.models.gp import surrogate_mean_std_smooth
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        span = hi - lo
        n0 = len(X0)
        cloud = np.repeat(X0, n_local, axis=0)
        cloud = cloud + self.rng.normal(
            scale=sigma_frac, size=cloud.shape) * span
        cloud = np.clip(cloud, lo, hi)
        cloud[::n_local] = X0  # keep the original picks as candidates
        p = self.gpr.sweep_params()
        mu, sd = surrogate_mean_std_smooth(
            self.gpr.family, p, jnp.asarray(cloud, p.X.dtype))
        mu_eff, z = self._audit_zscore(
            np.asarray(mu, float), np.asarray(sd, float), thres)
        z = np.where(mu_eff < thres - margin, z, np.inf)
        if self._X_audit_hist:
            # keep polished picks out of already-audited zones too (the
            # cloud can reach back into a masked region)
            hist = np.asarray(self._X_audit_hist)
            cn = (cloud - lo) / (hi - lo)
            d2 = np.min(np.sum(
                (cn[:, None, :] - hist[None, :, :]) ** 2, axis=-1),
                axis=1)
            z = np.where(d2 >= (0.08 ** 2) * len(lo), z, np.inf)
        best = z.reshape(n0, n_local).argmin(axis=1) \
            + np.arange(n0) * n_local
        return cloud[best], mu_eff[best]

    def _mode_center_calibration(self):
        """
        Calibration phase of the convergence audit: the surrogate must be
        RIGHT at the centers of its own detected modes.

        The below-band screen (_convergence_audit) finds mass the
        surrogate doesn't know about; it is blind to mass the surrogate
        knows but models badly.  A GP whose single per-dim lengthscale
        must span a broad mode and a narrow spike in the same dimension
        smooths the spike's peak down and confidently under-integrates it
        (measured on the reference's Spike fixture: mu at the true mode
        centers -4/-8/-12 vs truth 0, sd < 0.1, every narrow mode's
        weight ~2x low, momKL 0.15-0.18 at declaration) — CorrectCounter
        never sees it because the mass-weighted acquisition stops
        proposing points in a mode it believes settled.

        So: for every detected mode of the acquisition's MC sample whose
        center is not ANCHORED (no training point within 0.5 of the
        cluster's own per-dim sigma) and not already audited, spend one
        truth eval at the center.  |y_true - mu| > band/4 means the
        surrogate is miscalibrated where it claims to know the posterior:
        veto, train on the point (which re-levels the mode), and demand a
        fresh mode-stability streak.  On well-trained targets every
        center is anchored and the phase costs nothing.
        """
        modes = self._last_modes or []
        if not modes:
            return True
        from gpry_tpu.utils.tools import delta_logp_of_1d_nstd
        band = delta_logp_of_1d_nstd(self.audit_band_nstd, self.d)
        tol = 0.25 * band
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        r2_hist = (0.08 ** 2) * self.d
        X_tr = np.asarray(self.gpr.X_train, float)
        centers = []
        for c in modes:
            ctr = np.asarray(c["mean"], float)
            sig = np.sqrt(np.maximum(np.diag(np.asarray(c["cov"])), 0.0))
            if len(X_tr) and np.any(np.all(
                    np.abs(X_tr - ctr) <= 0.5 * sig, axis=1)):
                continue  # anchored: data at the mode's own scale
            if self._X_audit_hist:
                cn = (ctr - lo) / (hi - lo)
                hist = np.asarray(self._X_audit_hist)
                if np.min(np.sum((hist - cn) ** 2, axis=1)) < r2_hist:
                    continue  # this center's region was already audited
            centers.append(ctr)
        if not centers:
            return True
        n_budget = min(self.max_audit - self._n_audited, self.n_total_left)
        if n_budget <= 0:
            return True
        X_cal = np.asarray(centers[:int(n_budget)])
        import jax.numpy as jnp
        from gpry_tpu.models.gp import surrogate_mean_std_smooth
        p = self.gpr.sweep_params()
        mu, _ = surrogate_mean_std_smooth(
            self.gpr.family, p, jnp.asarray(X_cal, p.X.dtype))
        mu = np.asarray(mu, float)
        with Timer() as timer_truth:
            y_cal = np.asarray(self.executor.logp_batch(X_cal))
        self.progress.add_truth(timer_truth, n_evals=len(X_cal),
                                accumulate=True)
        self._n_audited += len(X_cal)
        self._X_audit_hist.extend((X_cal - lo) / (hi - lo))
        self._feed_offbatch_convergence(y_cal, mu)
        err = np.where(np.isfinite(y_cal) & np.isfinite(mu),
                       np.abs(y_cal - mu), 0.0)
        bad = err > tol
        with TimerCounter(self.gpr) as timer_fit:
            self.gpr.append_to_data(
                X_cal, y_cal,
                fit_gpr=({"n_restarts": self._fit_restarts()}
                         if np.any(bad) else "simple"))
        self.progress.add_fit(timer_fit, accumulate=True)
        self._touch_liveness()
        if np.any(bad):
            self._mode_sig_hist.clear()
            self._audit_dirty_vetoes = 0
            self._mode_veto_streak = 0
            k = int(np.argmax(err))
            self.log("[AUDIT] convergence vetoed: surrogate miscalibrated "
                     f"at {int(bad.sum())}/{len(X_cal)} of its own mode "
                     f"centers (worst: truth {y_cal[k]:.4g} vs predicted "
                     f"{mu[k]:.4g}, tol {tol:.3g}); audit spend "
                     f"{self._n_audited}/{self.max_audit}.",
                     _VERBOSITY_WARN)
            return False
        self.log(f"[AUDIT] {len(X_cal)} unanchored mode centers "
                 "calibration-checked: surrogate agrees with truth "
                 f"(spend {self._n_audited}/{self.max_audit}).",
                 _VERBOSITY_INFO)
        return True

    def _apex_calibration(self):
        """
        Calibration of the surrogate's SECONDARY belief apexes.

        A GP whose per-dim lengthscale is set by a broad mode smooths a
        narrow co-located feature's peak down and confidently
        under-integrates it (the reference's Spike fixture: apexes
        predicted 4-8 log-units low with z-scores ~10-50, every narrow
        mode's weight ~2x low).  Both other guards are structurally blind
        to it: the smoothed apex is predicted IN-band (the below-band
        screen skips it as known mass) and the posterior is one
        *connected* blob (mode detection correctly reports a single
        cluster, so the signature veto and center calibration never
        engage).

        So: find the local maxima of the surrogate mean over the audit
        screen's Sobol net (kNN-16 local-max test — scale-free in any d),
        keep only SECONDARY apexes (more than band/8 below the net's
        global max: the global mode's shape is continuously validated by
        CorrectCounter on acquired points, so unimodal targets never pay
        an eval here), polish each with two free batched cloud ascents of
        the mean, and spend one truth eval per unanchored, not-yet-audited
        apex.  |y_true - mu| > band/4 at a point the surrogate itself
        calls a posterior peak means its mass accounting there is wrong:
        veto and train on the point (which restores the apex height and,
        through the refit, the mode's integral).
        """
        from gpry_tpu.utils.tools import delta_logp_of_1d_nstd
        band = delta_logp_of_1d_nstd(self.audit_band_nstd, self.d)
        tol = 0.25 * band
        n_budget = min(self.max_audit - self._n_audited, self.n_total_left)
        if n_budget <= 0:
            return True
        thres = self.gpr.y_max - band
        Xs, mu, _ = self._audit_screen(thres)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        Xn = (Xs - lo) / (hi - lo)
        from scipy.spatial import cKDTree
        tree = cKDTree(Xn)
        k = min(len(Xn), 17)  # self + 16 neighbors
        _, nbr = tree.query(Xn, k=k)
        is_max = mu >= mu[nbr].max(axis=1) - 1e-12
        # Secondary apexes only, by value — and only down to one band
        # below the band edge: an apex the belief puts in-band or in the
        # margin shell can move the moments if its height is wrong (the
        # z-screen skips the shell by design — its margin exists to stop
        # boundary-chasing — so shell APEXES, few and high-leverage, are
        # exactly this phase's jurisdiction; measured: spike tail apexes
        # over-predicted by 20 log-units lived there).  Apexes deeper
        # than a full band carry negligible mass under any correction
        # that the z-screen would not itself flag.  Measured: on the
        # curved-degeneracy fixture an unfiltered phase burned 8 evals
        # confirming accurate deep-tail wiggles.
        gap = 0.125 * band
        cand = np.flatnonzero(is_max & (mu < mu.max() - gap)
                              & (mu > thres - band) & np.isfinite(mu))
        if len(cand) == 0:
            return True
        cand = cand[np.argsort(-mu[cand])][:4]
        # polish: two batched cloud ascents of the belief (free)
        X_apex = Xs[cand]
        for frac in (0.06, 0.015):
            X_apex, _ = self._apex_polish(X_apex, frac)
        # drop apexes anchored by a training point (apex height is then
        # data-pinned: a point this close either already fixed it or
        # will via CorrectCounter), already-audited ones, and collapse
        # near-duplicate apexes (two net maxima of one smoothed feature)
        r_anchor2 = (0.01 ** 2) * self.d
        r2_hist = (0.08 ** 2) * self.d
        Xn_tr = (np.asarray(self.gpr.X_train, float) - lo) / (hi - lo)
        keep = []
        for x in X_apex:
            xn = (x - lo) / (hi - lo)
            if len(Xn_tr) and np.min(
                    np.sum((Xn_tr - xn) ** 2, axis=1)) < r_anchor2:
                continue
            if self._X_audit_hist and np.min(np.sum(
                    (np.asarray(self._X_audit_hist) - xn) ** 2,
                    axis=1)) < r2_hist:
                continue
            if keep and np.min(np.sum(
                    (np.asarray(keep) - xn) ** 2, axis=1)) < r_anchor2:
                continue
            keep.append(xn)
        if not keep:
            return True
        X_cal = np.asarray(keep)[:int(n_budget)] * (hi - lo) + lo
        import jax.numpy as jnp
        from gpry_tpu.models.gp import surrogate_mean_std_smooth
        p = self.gpr.sweep_params()
        mu_cal, _ = surrogate_mean_std_smooth(
            self.gpr.family, p, jnp.asarray(X_cal, p.X.dtype))
        mu_cal = np.asarray(mu_cal, float)
        with Timer() as timer_truth:
            y_cal = np.asarray(self.executor.logp_batch(X_cal))
        self.progress.add_truth(timer_truth, n_evals=len(X_cal),
                                accumulate=True)
        self._n_audited += len(X_cal)
        self._X_audit_hist.extend((X_cal - lo) / (hi - lo))
        self._feed_offbatch_convergence(y_cal, mu_cal)
        err = np.where(np.isfinite(y_cal) & np.isfinite(mu_cal),
                       np.abs(y_cal - mu_cal), 0.0)
        bad = err > tol
        with TimerCounter(self.gpr) as timer_fit:
            self.gpr.append_to_data(
                X_cal, y_cal,
                fit_gpr=({"n_restarts": self._fit_restarts()}
                         if np.any(bad) else "simple"))
        self.progress.add_fit(timer_fit, accumulate=True)
        self._touch_liveness()
        if np.any(bad):
            self._mode_sig_hist.clear()
            self._audit_dirty_vetoes = 0
            self._mode_veto_streak = 0
            j = int(np.argmax(err))
            self.log("[AUDIT] convergence vetoed: surrogate miscalibrated "
                     f"at {int(bad.sum())}/{len(X_cal)} of its own belief "
                     f"apexes (worst: truth {y_cal[j]:.4g} vs predicted "
                     f"{mu_cal[j]:.4g}, tol {tol:.3g}); audit spend "
                     f"{self._n_audited}/{self.max_audit}.",
                     _VERBOSITY_WARN)
            return False
        self.log(f"[AUDIT] {len(X_cal)} secondary belief apexes "
                 "calibration-checked: surrogate agrees with truth "
                 f"(spend {self._n_audited}/{self.max_audit}).",
                 _VERBOSITY_INFO)
        return True

    def _apex_polish(self, X0, sigma_frac, n_local=256):
        """One batched cloud ascent of the surrogate mean around each
        point of ``X0`` (free: surrogate predicts only)."""
        import jax.numpy as jnp
        from gpry_tpu.models.gp import surrogate_mean_std_smooth
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        span = hi - lo
        n0 = len(X0)
        cloud = np.repeat(X0, n_local, axis=0)
        cloud = cloud + self.rng.normal(
            scale=sigma_frac, size=cloud.shape) * span
        cloud = np.clip(cloud, lo, hi)
        cloud[::n_local] = X0
        p = self.gpr.sweep_params()
        mu, _ = surrogate_mean_std_smooth(
            self.gpr.family, p, jnp.asarray(cloud, p.X.dtype))
        mu = np.asarray(mu, float)
        mu = np.where(np.isfinite(mu), mu, -np.inf)
        best = mu.reshape(n0, n_local).argmax(axis=1) \
            + np.arange(n0) * n_local
        return cloud[best], mu[best]

    def _convergence_audit(self):
        """
        Audit a declared convergence against UNDISCOVERED posterior mass.

        The reference's criteria only ever score points the acquisition
        itself proposed (gpry/convergence.py:755-879), so a surrogate that
        never saw a mode converges without it.  This audit asks the
        surrogate's own *ungated* belief where it cannot rule out top-band
        mass: screen a scrambled-Sobol net over the prior box and flag
        points whose in-band z-score ``(y_max - band - mu)/sigma`` is below
        ``kappa`` while ``mu < y_max - band`` (i.e. not a known-mass region
        — there the mean itself is in-band).  Candidates are audited in
        ASCENDING z order — i.e. by probability of hiding top-band mass —
        NOT by upper-confidence bound: a UCB ranking degenerates to
        whatever has the largest sigma (box corners), while the points most
        likely to hide a missed mode sit at moderate sigma and much higher
        mu (measured on Himmelblau: missed modes screen at z≈0.7 vs
        corners at z≈2).

        The audit iterates screen→evaluate→refit rounds within one
        declaration (``audit_rounds`` rounds of up to ``n_audit`` truth
        evals; ``max_audit`` total per run): auditing a region pins the GP
        there over a lengthscale-sized ball, so the suspicious set shrinks
        geometrically.  Any truth value inside the band is real mass the
        surrogate missed: the declaration is vetoed and the points (all
        informative: tails train the GP too) feed the training set.

        Returns True when the declaration survives.  With a clean first
        screen the audit is FREE (no truth evals) — on well-trained
        unimodal targets it usually costs nothing.
        """
        from gpry_tpu.utils.tools import delta_logp_of_1d_nstd
        band = delta_logp_of_1d_nstd(self.audit_band_nstd, self.d)
        lo, hi = self.prior_bounds[:, 0], self.prior_bounds[:, 1]
        r2 = (0.15 ** 2) * self.d
        # history-mask radius, tighter than the within-batch diversity
        # radius: wide enough to stop re-auditing a region whose belief
        # an eval cannot move (a very low truth value is swallowed by the
        # infinities classifier and never reaches the GP — observed: the
        # same corner picked 7x), narrow enough that a near-miss outside
        # a mode's in-band catchment does not shadow the mode core
        r2_hist = (0.08 ** 2) * self.d
        if not self._mode_center_calibration():
            return False
        if not self._apex_calibration():
            return False
        for audit_round in range(self.audit_rounds):
            thres = self.gpr.y_max - band
            n_budget = min(self.max_audit - self._n_audited,
                           self.n_total_left)
            if n_budget <= 0:
                self.log("[AUDIT] budget spent "
                         f"({self._n_audited}/{self.max_audit}); accepting "
                         "convergence unaudited.", _VERBOSITY_WARN)
                return True
            Xs, mu, z = self._audit_screen(thres)
            # A suspicious point must be a genuine SURPRISE candidate:
            # the surrogate claims clearly-below-band (margin of band/2)
            # yet cannot back it at kappa sigma.  Without the margin the
            # audit chases the band-boundary shell — points predicted a
            # hair below thres whose truth is a hair above: "mass" the
            # surrogate already models correctly (measured on d=4
            # Gaussians: every shell audit "hit" had |y - mu| < 0.5 and
            # each spurious veto dragged the run +1 batch, inflating
            # evals-to-stop 36 -> 78).  With the margin, any in-band
            # truth at an audited point automatically exceeds its
            # prediction by > band/2 — a real discovery.
            margin = 0.5 * band
            suspicious = (z < self.audit_kappa) & (mu < thres - margin)
            if np.any(suspicious) and self._X_audit_hist:
                # drop candidates whose REGION was already audited this
                # run: a far-from-data region with a large prior
                # amplitude and a short lengthscale re-screens as
                # suspicious forever (one truth eval cannot shrink its
                # sigma beyond a lengthscale ball) — without this mask
                # every round re-picks the same miscalibrated corner and
                # the genuinely suspicious moderate-z regions (missed
                # modes screen at z~0.7-0.9) are never reached.
                Xn_all = (Xs - lo) / (hi - lo)
                hist = np.asarray(self._X_audit_hist)
                d2 = np.min(np.sum(
                    (Xn_all[:, None, :] - hist[None, :, :]) ** 2,
                    axis=-1), axis=1)
                suspicious &= d2 >= r2_hist
            if not np.any(suspicious):
                self.log("[AUDIT] no plausibly-missed mass at "
                         f"{self.audit_kappa} sigma over {len(Xs)} "
                         "screening points (outside already-audited "
                         "regions); convergence accepted "
                         f"({self._n_audited} audit evals so far).",
                         _VERBOSITY_INFO)
                return True
            n_pick = int(min(self.n_audit, n_budget))
            # greedy min-z selection with a diversity radius, in
            # box-normalized coordinates: d audit points in one
            # lengthscale-ball would waste the batch
            Xn = (Xs[suspicious] - lo) / (hi - lo)
            order = np.argsort(z[suspicious])
            picked = []
            for j in order:
                if len(picked) >= n_pick:
                    break
                if picked and np.min(np.sum(
                        (Xn[picked] - Xn[j]) ** 2, axis=1)) < r2:
                    continue
                picked.append(j)
            # polish each pick to its region's local UCB argmax with one
            # extra batched SURROGATE predict (free: no truth evals).  A
            # raw Sobol point flags a suspicious REGION but rarely sits on
            # the region's plausible-mass peak (a mode's in-band catchment
            # can be much smaller than the screen spacing); spending the
            # truth eval anywhere else both wastes it and then masks the
            # region with an unfair "checked, empty" verdict (observed:
            # Himmelblau's 4th mode shadowed by a near-miss audit).
            X_audit, mu_audit = self._audit_polish(
                Xs[suspicious][picked], thres, margin=margin)
            with Timer() as timer_truth:
                y_audit = self.executor.logp_batch(X_audit)
            self.progress.add_truth(timer_truth, n_evals=len(X_audit),
                                    accumulate=True)
            self._n_audited += len(X_audit)
            y_audit = np.asarray(y_audit)
            self._feed_offbatch_convergence(y_audit, mu_audit)
            found = y_audit > thres
            # mask the audited POINTS unconditionally (with the tight
            # r2_hist radius): a truth value below the infinities
            # threshold never reaches the GP, so the local belief cannot
            # change and an unmasked empty pick would be re-selected
            # verbatim every round until the budget is gone
            self._X_audit_hist.extend((X_audit - lo) / (hi - lo))
            # all audit points are informative (in-band hits map new mass;
            # low tails pin down where mass is NOT): train on all of them
            with TimerCounter(self.gpr) as timer_fit:
                self.gpr.append_to_data(
                    X_audit, np.asarray(y_audit),
                    fit_gpr=({"n_restarts": self._fit_restarts()}
                             if np.any(found) else "simple"))
            self.progress.add_fit(timer_fit, accumulate=True)
            self._touch_liveness()
            if np.any(found):
                # the mode census just changed: demand a fresh stability
                # streak before convergence can be declared again
                self._mode_sig_hist.clear()
                self._audit_dirty_vetoes = 0
                self._mode_veto_streak = 0
                self.log("[AUDIT] convergence vetoed: found REAL top-band "
                         f"mass at {int(found.sum())}/{len(X_audit)} "
                         f"audited points (best logp "
                         f"{np.max(y_audit):.4g} vs predicted "
                         f"{mu_audit[np.argmax(y_audit)]:.4g}, band "
                         f"{thres:.4g}); audit spend "
                         f"{self._n_audited}/{self.max_audit}.",
                         _VERBOSITY_WARN)
                return False
            self.log(f"[AUDIT] round {audit_round + 1}: {len(X_audit)} "
                     "suspicious points audited, no real mass found "
                     f"(spend {self._n_audited}/{self.max_audit}).",
                     _VERBOSITY_INFO)
        # Rounds exhausted with a DIRTY screen: while per-run audit
        # budget remains, veto rather than accept — plausibly-missed
        # regions are still unchecked, and the loop's next declaration
        # resumes auditing them with the region masks carried over
        # (observed: Himmelblau seed 102 accepted at 44 evals with two
        # modes still screening suspicious and 10/16 budget unspent).
        if self._n_audited < self.max_audit \
                and self.n_total_left > 0:
            # NOTE: no early acceptance on a finding-less dirty streak —
            # tried and reverted: Himmelblau's missed modes only yield
            # their finding after several persistent screen rounds
            # (tiny in-band catchments vs net spacing), and the throttle
            # let 2/3 seeds accept with modes missing (momKL 404/645).
            # Persistence until max_audit is the contract.
            self._audit_dirty_vetoes += 1
            self.log(f"[AUDIT] convergence vetoed: screen still dirty "
                     f"after {self.audit_rounds} rounds (spend "
                     f"{self._n_audited}/{self.max_audit}); auditing "
                     "resumes at the next declaration.", _VERBOSITY_WARN)
            return False
        self.log(f"[AUDIT] audit budget spent without a clean screen; "
                 f"convergence accepted unaudited (spend "
                 f"{self._n_audited}/{self.max_audit}).", _VERBOSITY_WARN)
        return True

    def do_initial_training(self):
        """
        Draw initial points until n_initial finite truth values
        (reference: gpry/run.py:1063-1198).
        """
        n_finite, n_tried = 0, 0
        X_all, y_all = [], []
        while n_finite < self.n_initial:
            if n_tried >= self.max_initial:
                raise RuntimeError(
                    f"Could not find {self.n_initial} finite initial points "
                    f"within max_initial={self.max_initial} evaluations. "
                    "Try decreasing your prior volume.")
            # size each top-up batch to the remaining deficit, capped by
            # the remaining budget: truth evaluations are the expensive
            # resource, and a 1-point deficit must not trigger another
            # full n_initial-sized batch
            batch = min(max(self.n_initial - n_finite, 2),
                        self.max_initial - n_tried)
            X = np.atleast_2d(self.initial_proposer.get_batch(
                batch, self.rng))
            y = self.executor.logp_batch(X)
            X_all.append(X)
            y_all.append(y)
            n_tried += len(X)
            y_cat = np.concatenate(y_all)
            # count under the same thresholding the GPR will apply
            n_finite = int(np.sum(
                np.isfinite(y_cat)
                & (y_cat >= np.nanmax(y_cat) - self.gpr._diff_threshold)))
            self.log(f"[INITIAL] {n_finite}/{self.n_initial} finite points "
                     f"after {n_tried} evaluations", _VERBOSITY_INFO)
        X_init = np.vstack(X_all)
        y_init = np.concatenate(y_all)
        self.gpr.append_to_data(
            X_init, y_init,
            fit_gpr={"n_restarts": self._fit_restarts()})

    def _fit_restarts(self):
        # Explicit None checks, NOT truthiness: n_restarts_optimizer=0 is
        # a legitimate "never re-optimize hyperparameters" configuration
        # and must not be silently replaced by the default.  The GPR's own
        # attribute covers the prebuilt-instance and checkpoint-resume
        # paths, where _construct_gpr (which sets _gpr_fit_restarts)
        # never ran.
        configured = getattr(self, "_gpr_fit_restarts", None)
        if configured is None:
            configured = getattr(self.gpr, "n_restarts_optimizer", None)
        return (10 + 2 * self.d) if configured is None else int(configured)

    def _fit_gpr(self, new_X, new_y):
        """
        Fit cadence (reference: gpry/run.py:1238-1301): full multi-restart
        fit every ``fit_full_every`` iterations, single-start ("simple")
        fit every ``fit_simple_every``, plain factorization otherwise.
        """
        it = self.current_iteration
        if self.fit_full_every and it % self.fit_full_every == 0:
            fit = {"n_restarts": self._fit_restarts()}
        elif self.fit_simple_every and it % self.fit_simple_every == 0:
            fit = "simple"
        else:
            fit = False
        self.gpr.append_to_data(new_X, new_y, fit_gpr=fit)

    def _check_convergence(self, new_X, new_y, y_pred):
        """
        Evaluate all criteria and combine by policy
        (reference: gpry/run.py:1303-1333).
        """
        necessary_ok, any_sufficient, has_sufficient = True, False, False
        value = np.nan
        for cc in self.convergence_criterion:
            try:
                converged = cc.is_converged(
                    self.gpr, new_X=new_X, new_y=new_y, pred_y=y_pred,
                    acquisition=self.acquisition)
            except ConvergenceCheckError:
                converged = False
            if np.isnan(value):
                value = cc.last_value
            if cc.is_monitor:
                continue
            if cc.is_sufficient:
                has_sufficient = True
                any_sufficient = any_sufficient or converged
            if cc.is_necessary and not converged:
                necessary_ok = False
        converged_total = necessary_ok and \
            (any_sufficient if has_sufficient else True)
        return bool(converged_total), value

    def update_mean_cov(self, use_mc_sample=None):
        """
        Pull the current mean/cov estimate, preferring an explicit MC sample
        if given, then the acquisition engine, then convergence criteria
        (reference: gpry/run.py:1335-1352).
        """
        if use_mc_sample is not None:
            try:
                self.mean, self.cov = mean_covmat_from_samples(
                    use_mc_sample["X"], use_mc_sample["weights"])
                return
            except Exception:
                pass
        self.mean, self.cov = None, None
        acq_mean = getattr(self.acquisition, "mean", None)
        if acq_mean is not None:
            self.mean = acq_mean
            self.cov = self.acquisition.cov
            return
        for cc in self.convergence_criterion:
            if getattr(cc, "mean", None) is not None:
                self.mean, self.cov = cc.mean, cc.cov
                return

    # ------------------------------------------------------------- MC sampling

    def _touch_liveness(self):
        """Touch ``<checkpoint>/liveness.heartbeat``: proof of forward
        progress for external checkpoint-mtime hang watchdogs
        at phase boundaries finer than the per-iteration checkpoint —
        single phases (an escalating fit ladder, a long final-MC NS) can
        legitimately run for many minutes.  Watchdogs must exclude
        ``*.heartbeat`` files from *progress* accounting (they prove
        liveness, not advancement)."""
        _touch_liveness_file(self.checkpoint)

    def generate_mc_sample(self, sampler=None, output=None, add_options=None,
                           rng=None):
        """
        MC-sample the surrogate (reference: gpry/run.py:1594-1714).
        Returns the samples dict and stores it as ``last_mc_result``.
        """
        from gpry_tpu.mc.samples import mc_sample_from_gp, write_samples_txt
        sampler = sampler or self._mc_options["sampler"]
        options = dict(self._mc_options["options"])
        options.update(add_options or {})
        # inject the run's covariance estimate into MCMC-family samplers
        # (reference: gpry/mc.py:106-156 mcmc_info_from_run cov injection)
        if "mcmc" in str(sampler) and getattr(self, "cov", None) is not None:
            options.setdefault("covmat", self.cov)
        if str(sampler) == "nested" and self.checkpoint is not None:
            # keep external checkpoint-mtime liveness watchdogs
            # fed while a long final MC runs between iteration checkpoints
            options.setdefault("heartbeat", self._touch_liveness)
        result = mc_sample_from_gp(
            self.gpr, bounds=self.truth.prior_bounds, sampler=sampler,
            rng=rng or self.rng, options=options, verbose=self.verbose)
        self.last_mc_result = result
        self._mc_at_n_total = self.gpr.n_total
        # the MC sample is the best moment estimate from here on
        # (reference: gpry/run.py:1713 update_mean_cov(use_mc_sample=...))
        self.update_mean_cov(use_mc_sample=result)
        out_path = output
        if out_path is None and self.checkpoint is not None:
            out_path = os.path.join(self.checkpoint, "chains",
                                    "mc_samples.txt")
        if out_path:
            write_samples_txt(result, out_path, params=self.truth.params)
        return result

    def last_mc_samples(self, as_getdist=False):
        """Last MC samples as (X, weights, logpost), or getdist MCSamples
        (reference: gpry/run.py:1716-1745)."""
        if self.last_mc_result is None:
            raise ValueError("No MC sample generated yet.")
        if as_getdist:
            from gpry_tpu.mc.samples import samples_dict_to_getdist
            return samples_dict_to_getdist(self.last_mc_result,
                                           params=self.truth.params)
        r = self.last_mc_result
        return r["X"], r["weights"], r["logpost"]

    def last_mc_samples_pandas(self):
        """Last MC samples as a pandas DataFrame
        (reference: gpry/run.py:1716 as_pandas)."""
        import pandas as pd
        if self.last_mc_result is None:
            raise ValueError("No MC sample generated yet.")
        r = self.last_mc_result
        data = {p: r["X"][:, i] for i, p in enumerate(self.truth.params)}
        data["weight"] = r["weights"]
        data["logpost"] = r["logpost"]
        return pd.DataFrame(data)

    def diagnose_last_mc_sample(self):
        """
        Post-MC diagnosis (reference: gpry/run.py:1747-1784): (1) the
        training mean must lie within 0.5 central credibility of the MC
        sample; (2) KL(acquisition Gaussian || MC Gaussian) < d.
        Failure vetoes convergence.
        """
        if self.last_mc_result is None:
            return True
        X, w = self.last_mc_result["X"], self.last_mc_result["weights"]
        if len(X) < 2 * self.d:
            return False
        mean_mc, cov_mc = mean_covmat_from_samples(X, w)
        ok = True
        try:
            from gpry_tpu.utils.tools import mean_covmat_from_evals
            mean_train = mean_covmat_from_evals(
                self.gpr.X_train, self.gpr.y_train)[0]
            dist = gaussian_distance(mean_train[None], mean_mc, cov_mc)[0]
            cred = credibility_of_nstd(dist, self.d)
            if not (0 <= cred < 0.5):
                self.log(f"[DIAGNOSIS] training-mean credibility {cred:.3f}"
                         " >= 0.5", _VERBOSITY_WARN)
                ok = False
        except Exception as excpt:
            self.log(f"[DIAGNOSIS] alignment check failed: {excpt}",
                     _VERBOSITY_WARN)
        # KL(mc || acq) < d against the acquisition's OWN last sample
        # (reference: gpry/run.py:1775-1784 — skipped for engines without
        # one, e.g. BatchOptimizer; a failed moment computation leaves the
        # training test as the verdict).
        if ok and hasattr(self.acquisition, "last_MC_sample"):
            try:
                X_a, _, w_a = self.acquisition.last_MC_sample()
                mean_acq, cov_acq = mean_covmat_from_samples(X_a, w_a)
                kl = kl_norm(mean_mc, cov_mc, mean_acq, cov_acq)
            except Exception as excpt:
                self.log(f"[DIAGNOSIS] KL check skipped: {excpt}",
                         _VERBOSITY_WARN)
            else:
                if not (kl < self.d):
                    self.log(f"[DIAGNOSIS] KL(mc||acq)={kl:.3g} >= d",
                             _VERBOSITY_WARN)
                    ok = False
        return ok

    # ------------------------------------------------------------- fiducials

    def set_fiducial_point(self, X, logpost=None):
        """Store a fiducial point for plots (reference: gpry/run.py:1354)."""
        self.fiducial_point = np.atleast_1d(np.asarray(X, dtype=float))
        self.fiducial_logpost = logpost

    def set_fiducial_MC(self, X, weights=None, logpost=None):
        """Store a fiducial MC sample for plots
        (reference: gpry/run.py:1400)."""
        self.fiducial_MC = {
            "X": np.atleast_2d(X),
            "weights": weights if weights is not None
            else np.ones(len(np.atleast_2d(X))),
            "logpost": logpost,
        }

    # ------------------------------------------------------------ checkpointing

    def save_checkpoint(self, update_truth=False):
        """Public checkpoint save (reference: gpry/run.py:736).
        ``update_truth=False`` skips re-pickling the (never-changing) truth
        when it is already on disk."""
        return self._save_checkpoint(update_truth=update_truth)

    def read_checkpoint(self, truth=None):
        """Reload the checkpoint objects into this Runner
        (reference: gpry/run.py:723)."""
        (self.truth, self.gpr, self.acquisition,
         self.convergence_criterion, self.options,
         self.progress) = gio.read_checkpoint(self.checkpoint, truth=truth)
        if isinstance(self.options, dict):
            self.options.pop("_runtime", None)
        return self

    def _save_checkpoint(self, update_truth=False):
        if self.checkpoint is None:
            return
        try:
            options = dict(self.options)
            options["_runtime"] = {
                "current_iteration": int(self.current_iteration),
                "has_converged": bool(self.has_converged),
                "rng_state": self.rng.bit_generator.state,
                "n_explored": int(self._n_explored),
                "explore_net_i": int(self._explore_net_i),
                "explore_seed": self._explore_seed,
                "flat_explored": bool(self._flat_explored),
                "n_audited": int(self._n_audited),
                "audit_dirty_vetoes": int(self._audit_dirty_vetoes),
                "mode_veto_streak": int(self._mode_veto_streak),
                "mode_sig_hist": [[s[0], list(s[1])]
                                  for s in self._mode_sig_hist],
                "audit_hist": [list(map(float, x))
                               for x in self._X_audit_hist],
            }
            gio.save_checkpoint(
                self.checkpoint, self.truth, self.gpr, self.acquisition,
                self.convergence_criterion, options, self.progress,
                update_truth=update_truth)
        except Exception as excpt:
            self.log(f"Checkpoint saving failed: {excpt}", _VERBOSITY_WARN)

    # ------------------------------------------------------------------ plots

    def plot_progress(self, timing=True, convergence=True, trace=False,
                      slices=False, ext="png"):
        """Progress plots into <checkpoint>/images
        (reference: gpry/run.py:1470-1592)."""
        from gpry_tpu import plots as gplots
        path = os.path.join(self.checkpoint or ".", "images")
        os.makedirs(path, exist_ok=True)
        if timing:
            self.progress.plot_timing(
                save=os.path.join(path, f"timing.{ext}"))
        if convergence:
            gplots.plot_convergence(
                self.convergence_criterion,
                save=os.path.join(path, f"convergence.{ext}"))
        if trace:
            gplots.plot_trace(self.gpr,
                              save=os.path.join(path, f"trace.{ext}"))
        if slices:
            gplots.plot_slices(self.truth, self.gpr,
                               save=os.path.join(path, f"slices.{ext}"))

    def plot_mc(self, add_training=True, output=None):
        """Corner plot of the last MC sample (reference: gpry/run.py:1786)."""
        from gpry_tpu import plots as gplots
        if self.last_mc_result is None:
            raise ValueError("No MC sample generated yet.")
        return gplots.plot_corner(
            self.last_mc_result, params=self.truth.params,
            gpr=self.gpr if add_training else None,
            fiducial_point=self.fiducial_point,
            fiducial_MC=self.fiducial_MC, save=output)

    def plot_distance_distribution(self, output=None):
        """Reference: gpry/run.py:1866."""
        from gpry_tpu import plots as gplots
        if self.last_mc_result is None:
            raise ValueError("No MC sample generated yet.")
        return gplots.plot_distance_distribution(
            self.gpr, self.last_mc_result, save=output)


def _touch_liveness_file(checkpoint_dir):
    """Write ``<checkpoint_dir>/liveness.heartbeat`` (see
    Runner._touch_liveness).  Module-level and argument-closed so it can be
    attached to checkpoint-pickled objects (e.g. ``gpr.liveness_callback``)
    via functools.partial without capturing the Runner."""
    if checkpoint_dir is None:
        return
    try:
        with open(os.path.join(checkpoint_dir,
                               "liveness.heartbeat"), "w") as f:
            f.write(str(time.time()))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Crash-resilient driver (checkpoint resume)
# ---------------------------------------------------------------------------

#: error-message fragments identifying a retryable accelerator-runtime
#: failure (status codes of a runtime that lost its device state; device
#: buffers are gone, so recovery means rebuilding the Runner from the
#: per-iteration checkpoint).  A machine without its accelerator fails at
#: once: that is not retryable.
_RETRYABLE_ERROR_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED")


def is_retryable_device_error(excpt):
    """Whether an exception looks like a transient accelerator-runtime
    failure (rather than a bug in user code or this library)."""
    msg = f"{type(excpt).__name__}: {excpt}"
    return any(m.lower() in msg.lower() for m in _RETRYABLE_ERROR_MARKERS)


def run_resilient(loglike=None, checkpoint=None, max_retries=3,
                  retry_wait_s=10, verbose=3, **runner_kwargs):
    """
    Build and run a Runner, retrying through transient accelerator-runtime
    failures by re-materializing ALL device state from the per-iteration
    checkpoint and resuming, ``retry_wait_s`` seconds after each failure.

    ``checkpoint`` is required (it is the recovery mechanism).  The first
    attempt honors ``runner_kwargs['load_checkpoint']`` (default
    "overwrite"); every retry resumes.  Non-retryable exceptions propagate
    immediately.  Returns the finished Runner.
    """
    import gc
    import time

    if checkpoint is None:
        raise ValueError("run_resilient requires a checkpoint path "
                         "(it is the crash-recovery mechanism).")
    runner_kwargs.setdefault("load_checkpoint", "overwrite")
    attempt = 0
    while True:
        try:
            runner = Runner(loglike, checkpoint=checkpoint,
                            verbose=verbose, **runner_kwargs)
            runner.run()
            return runner
        except Exception as excpt:
            if not is_retryable_device_error(excpt) \
                    or attempt >= max_retries:
                raise
            wait = retry_wait_s
            attempt += 1
            print(f"[RESILIENT] accelerator-runtime failure "
                  f"({type(excpt).__name__}); retry {attempt}/"
                  f"{max_retries} in {wait}s: {excpt}")
            # drop every live device buffer before the backend restarts;
            # the caught exception's traceback frames reference the
            # Runner (run()'s ``self``), so the name must be released
            # too or gc frees nothing during the backoff wait
            excpt = None
            try:
                del runner
            except NameError:
                pass
            gc.collect()
            time.sleep(wait)
            runner_kwargs["load_checkpoint"] = "resume"
            # a retry must CONTINUE the checkpointed RNG stream, not
            # replay it from the seed (Runner honors the checkpointed
            # rng_state only when seed is None)
            runner_kwargs.pop("seed", None)
