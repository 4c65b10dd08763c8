"""
BatchOptimizer: gradient-based batch acquisition with Kriging-believer.

Reference behavior: gpry/gp_acquisition.py:121-523.  The reference splits
``n_restarts_optimizer`` scipy L-BFGS-B runs across MPI ranks for each of the
``n_points`` sequential Kriging-believer steps.  Here each KB step is ONE
device computation: a batched screening of proposer draws followed by a
vmapped bounded L-BFGS ascent of the acquisition over all restarts at once;
the believer "lie" is folded into the surrogate with an O(nmax^2) block
Cholesky append (no model copies, no refits).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gpry_tpu.acquisition.base import GenericGPAcquisition, append_lie
from gpry_tpu.acquisition.proposal import CentroidsProposer, PartialProposer
from gpry_tpu.models.gp import (SurrogateParams, surrogate_mean_std_smooth,
                                surrogate_predict)
from gpry_tpu.ops.lbfgs import minimize_lbfgs_bounded
from gpry_tpu.utils.tools import check_and_return_bounds


@partial(jax.jit, static_argnames=("family",))
def _acq_values_gated(family, p: SurrogateParams, zeta, noise_std_raw,
                      X_raw):
    """LogExp-family acquisition with all gates (-inf outside).

    ``noise_std_raw`` is the raw-space noise std sigma_n, squared here —
    the same convention as ``LogExp.values`` and NORA, so engines agree
    bitwise (reference: gpry/acquisition_functions.py:973-983)."""
    mu, std = surrogate_predict(family, p, X_raw)
    var = std * std - noise_std_raw * noise_std_raw
    ok = (var > 0) & jnp.isfinite(mu)
    vals = 2.0 * zeta * (mu - p.y_max) + \
        0.5 * jnp.log(jnp.where(ok, var, 1.0))
    return jnp.where(ok, vals, -jnp.inf)


@partial(jax.jit, static_argnames=("family", "key"))
def _acq_values_generic(family, key, p: SurrogateParams, noise_std_raw,
                        X_raw):
    """Gated acquisition values for an ARBITRARY acquisition function
    (``key = (acqf, params-token)``, the same static-key convention as
    ``functions.acq_values_jit``).  The LogExp production path uses the
    fused ``_acq_values_gated`` instead; this generic path serves every
    other configured ``acq_func`` (Mu, Std, EI, operators, ...) so the
    engine optimizes what the user actually asked for."""
    acqf = key[0]
    mu, std = surrogate_predict(family, p, X_raw)
    vals = acqf.values(mu, std, p.y_max, noise_std_raw)
    return jnp.where(jnp.isfinite(mu), vals, -jnp.inf)


@partial(jax.jit, static_argnames=("family", "key", "maxiter"))
def _optimize_restarts_generic(family, key, p: SurrogateParams,
                               noise_std_raw, x0s, lo, hi, maxiter=100):
    """Vmapped multistart ascent of an arbitrary acquisition function
    over the smooth (ungated) surrogate; endpoints re-scored gated."""
    acqf = key[0]

    def neg_acq(x):
        mu, std = surrogate_mean_std_smooth(family, p, x[None])
        mu_c = jnp.minimum(mu[0], p.clip_max)
        return -acqf.values(mu_c, std[0], p.y_max, noise_std_raw)

    tol = 1e-8 if x0s.dtype == jnp.float64 else 1e-3
    solve = lambda x0: minimize_lbfgs_bounded(neg_acq, x0, lo, hi,
                                              maxiter=maxiter, tol=tol)
    xs, _ = jax.vmap(solve)(x0s)
    vals = _acq_values_generic(family, key, p, noise_std_raw, xs)
    return xs, vals


@partial(jax.jit, static_argnames=("family", "maxiter"))
def _optimize_restarts(family, p: SurrogateParams, zeta, noise_std_raw,
                       x0s, lo, hi, maxiter=100):
    """
    Vmapped multistart bounded maximization of the *smooth* acquisition
    (gates applied post-hoc to the final values, mirroring the reference's
    use of analytic smooth gradients, gpry/gp_acquisition.py:316-334).
    Returns (xs, gated acq values).
    """

    def neg_acq(x):
        mu, std = surrogate_mean_std_smooth(family, p, x[None])
        var = std[0] * std[0] - noise_std_raw * noise_std_raw
        mu_c = jnp.minimum(mu[0], p.clip_max)
        # smooth surrogate of the log-term; clipped from below to keep the
        # objective finite during line searches
        return -(2.0 * zeta * (mu_c - p.y_max)
                 + 0.5 * jnp.log(jnp.maximum(var, 1e-300)))

    # dtype-matched gradient tolerance (see models/gp.py): default 1e-8
    # is unreachable in f32 and burns all iterations on rounding noise
    tol = 1e-8 if x0s.dtype == jnp.float64 else 1e-3
    solve = lambda x0: minimize_lbfgs_bounded(neg_acq, x0, lo, hi,
                                              maxiter=maxiter, tol=tol)
    xs, _ = jax.vmap(solve)(x0s)
    vals = _acq_values_gated(family, p, zeta, noise_std_raw, xs)
    return xs, vals


class BatchOptimizer(GenericGPAcquisition):
    """
    Reference-compatible constructor (gpry/gp_acquisition.py:208-218):
    defaults ``n_restarts_optimizer="5d"``, ``n_repeats_propose=10``.
    """

    def __init__(self, bounds, acq_func="LogExp", acq_optimizer="lbfgs",
                 n_restarts_optimizer="5d", n_repeats_propose=10,
                 preprocessing_X=None, zeta_scaling=0.85, verbose=1,
                 proposer=None, random_state=None):
        super().__init__(bounds, acq_func=acq_func,
                         preprocessing_X=preprocessing_X,
                         zeta_scaling=zeta_scaling, verbose=verbose)
        self.acq_optimizer = acq_optimizer
        self.n_restarts_optimizer = self._parse_dim_spec(
            n_restarts_optimizer, "n_restarts_optimizer")
        self.n_repeats_propose = int(n_repeats_propose)
        # Default proposer: centroids of training subsets + 25% uniform
        # (reference: gpry/gp_acquisition.py:236-247 via proposal.py:163).
        self.proposer = proposer or PartialProposer(
            self.bounds, CentroidsProposer(self.bounds))
        self.obj_fun_eval_num = 0

    def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                  force_resample=False):
        """
        Propose ``n_points`` Kriging-believer points.
        Returns (X (n,d), y_lies (n,), acq_values (n,)).
        ``force_resample`` is accepted for engine-API parity
        (gpry/gp_acquisition.py:392); fresh proposer draws are made every
        call here, so it is a no-op.
        """
        if n_points < 1:
            raise ValueError(f"n_points must be >= 1, got {n_points}")
        rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)
        bounds = check_and_return_bounds(
            bounds if bounds is not None else self.bounds)
        family = gpr.family
        # Sweep dtype (models/gp.py:sweep_dtype) for screening, the L-BFGS
        # ascent, believer lies and final acquisition values.
        p = gpr.sweep_params()
        # LogExp (the production acquisition) takes the fused fast path;
        # any other configured acq_func is evaluated/ascended through its
        # own jittable ``values`` so the engine optimizes what the user
        # asked for (NonlinearLogExp subclasses LogExp with a different
        # formula, so the dispatch is on the exact type).
        from gpry_tpu.acquisition.functions import LogExp, _params_token
        fused = type(self.acq_func) is LogExp
        acq_key = (self.acq_func, _params_token(self.acq_func))
        zeta = getattr(self.acq_func, "zeta", 1.0)
        # the acq function's own noise convention: mean noise std by
        # default, or an explicit LogExp(sigma_n=...) override
        noise_std_raw = float(self.acq_func._noise_std(gpr))

        def score(p_, X_):
            if fused:
                return _acq_values_gated(family, p_, zeta, noise_std_raw,
                                         X_)
            return _acq_values_generic(family, acq_key, p_, noise_std_raw,
                                       X_)

        def ascend(p_, x0s_, lo_, hi_):
            if fused:
                return _optimize_restarts(family, p_, zeta, noise_std_raw,
                                          x0s_, lo_, hi_)
            return _optimize_restarts_generic(family, acq_key, p_,
                                              noise_std_raw, x0s_, lo_, hi_)

        lo = jnp.asarray(bounds[:, 0], p.X.dtype)
        hi = jnp.asarray(bounds[:, 1], p.X.dtype)
        dt = p.X.dtype

        self.proposer.update(gpr)
        self.proposer.update_bounds(bounds)

        X_out = np.empty((n_points, self.d))
        y_lies = np.empty(n_points)
        acq_out = np.empty(n_points)

        from gpry_tpu.models.gp import LBFGS_CHUNK
        # Screen-then-polish (same structure as the hyperparameter fit,
        # models/gp.py): ``n_restarts_optimizer`` drives the screening
        # breadth, but only LBFGS_CHUNK lanes are polished — under vmap
        # the L-BFGS runs lock-step, so ascent wall time is proportional
        # to the lane count while the extra lanes only re-polish losing
        # screened starts.
        R = max(2, self.n_restarts_optimizer)
        R_polish = min(LBFGS_CHUNK, R)
        for i in range(n_points):
            # --- screening: one batched acq evaluation over proposer draws
            n_screen = min(10 * self.d * R, 4000)
            cand = self.proposer.get_batch(n_screen, rng)
            acq_cand = np.asarray(score(p, jnp.asarray(cand, dt)))
            self.obj_fun_eval_num += n_screen
            order = np.argsort(acq_cand)[::-1]
            starts = [cand[order[:R_polish - 1]]]
            # restart 0 from the last in-bounds training point
            # (reference: gpry/gp_acquisition.py:342-351)
            Xt = gpr.X_train
            in_b = np.all((Xt >= bounds[:, 0]) & (Xt <= bounds[:, 1]),
                          axis=1) if len(Xt) else np.array([], bool)
            if np.any(in_b):
                starts.insert(0, Xt[in_b][-1:])
            x0s = np.vstack(starts)[:R_polish]
            if len(x0s) < R_polish:
                x0s = np.vstack([x0s, cand[order[len(x0s):R_polish]]])

            # --- multistart polish of the screened starts
            if self.acq_optimizer in ("lbfgs", "fmin_l_bfgs_b", None):
                # vmapped L-BFGS ascent on the *conditioned* acquisition
                # surface (p is re-conditioned after every believer append,
                # Kriging-believer semantics, gpry/gp_acquisition.py:478-497)
                xs, vals = ascend(p, jnp.asarray(x0s, dt), lo, hi)
                xs, vals = np.asarray(xs), np.asarray(vals)
            else:
                # gradient-free "sampling" (Powell) fallback or a user
                # callable (reference: gpry/gp_acquisition.py:502-523)
                xs, vals = self._polish_gradient_free(score, p, x0s,
                                                      bounds, dt)
            # fall back to the best screened candidate if optimization failed
            if not np.any(np.isfinite(vals)):
                best_x = cand[order[0]]
                best_val = acq_cand[order[0]]
            else:
                j = int(np.nanargmax(vals))
                best_x, best_val = xs[j], vals[j]
                if acq_cand[order[0]] > best_val:
                    best_x, best_val = cand[order[0]], acq_cand[order[0]]
            X_out[i] = best_x
            acq_out[i] = best_val

            # --- Kriging believer: lie = GP prediction, conditioned in
            y_lie, _ = surrogate_predict(
                family, p, jnp.asarray(best_x[None], dt))
            y_lie = float(y_lie[0])
            if not np.isfinite(y_lie):
                y_lie = float(np.min(gpr.y_train)) if gpr.n else 0.0
            y_lies[i] = y_lie
            if i + 1 < n_points:
                # append_lie grows the padded buffers if the bucket is full
                p = append_lie(family, p, jnp.asarray(best_x[None], dt),
                               jnp.asarray([y_lie], dt))
        self.mean, self.cov = None, None
        return X_out, y_lies, acq_out

    def _polish_gradient_free(self, score, p, x0s, bounds, dt):
        """
        Host-driven gradient-free polish, for the reference's
        ``acq_optimizer="sampling"`` (scipy Powell) option and user
        callables (gpry/gp_acquisition.py:511-523).  Each objective call is
        one batched device evaluation of the gated acquisition (``score``,
        already bound to the configured acq_func); Powell is sequential,
        so only a few starts are polished (the dense screen has already
        located the basin).
        """
        import scipy.optimize

        def neg_acq(x):
            v = float(np.asarray(score(
                p, jnp.asarray(np.atleast_2d(x), dt)))[0])
            self.obj_fun_eval_num += 1
            return -v if np.isfinite(v) else 1e30

        xs, vals = [], []
        for x0 in np.asarray(x0s)[:max(2, min(4, len(x0s)))]:
            if callable(self.acq_optimizer):
                x_opt, f_opt = self.acq_optimizer(
                    neg_acq, x0, bounds=bounds)
            elif self.acq_optimizer == "sampling":
                res = scipy.optimize.minimize(
                    neg_acq, x0, method="Powell", bounds=bounds)
                x_opt, f_opt = res.x, float(res.fun)
            else:
                raise ValueError(
                    f"Unknown optimizer {self.acq_optimizer!r}.")
            xs.append(np.asarray(x_opt, dtype=float))
            vals.append(-f_opt if np.isfinite(f_opt) else -np.inf)
        return np.asarray(xs), np.asarray(vals)
