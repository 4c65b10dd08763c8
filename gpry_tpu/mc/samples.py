"""
Monte-Carlo samples of the surrogate: generation and conversion.

Reference surface: gpry/mc.py (532 LoC) — final/diagnostic sampling of the
surrogate posterior plus getdist conversion.  Here the default sampler is
the on-device nested sampler (mc.nested); host interop adapters live in
mc.interfaces; getdist export is gated on its availability.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from gpry_tpu.mc.nested import run_nested_device
from gpry_tpu.mc.mcmc import run_mcmc_device
from gpry_tpu.models.gp import surrogate_predict_mean
from gpry_tpu.utils.tools import (check_and_return_bounds, generic_params_names,
                                  get_Xnumber)


_LOGP_FNS = {}


def surrogate_logp_fn(family):
    """
    The gated surrogate log-density as a stable-identity function
    ``f(params, X) -> logp`` suitable for jit-cached samplers.
    """
    fn = _LOGP_FNS.get(family)
    if fn is None:
        def fn(params, X):
            return surrogate_predict_mean(family, params, X)
        fn.__name__ = f"surrogate_logp_{family}"
        _LOGP_FNS[family] = fn
    return fn


def mc_sample_from_gp(gpr, bounds=None, sampler="nested", rng=None,
                      options=None, verbose=1):
    """
    Draw MC samples from the surrogate posterior.

    Replaces the reference's ``mc_sample_from_gp_ns/cobaya``
    (gpry/mc.py:173-455).  ``sampler``: "nested" (on-device NS, default,
    final-quality ``nlive=50d`` as in gpry/run.py:1660) or "mcmc" (on-device
    ensemble of adaptive MH chains), or "uniform" (tests only).

    Returns a samples dict: {"X", "logpost", "weights", "logZ"(NS only)}.
    """
    options = dict(options or {})
    # liveness hook for external watchdogs (e.g. checkpoint-mtime hang
    # detectors): called after every bounded NS device segment
    heartbeat = options.pop("heartbeat", None)
    if sampler in ("cobaya_mcmc", "cobaya_polychord", "cobaya"):
        # Surrogate-as-Cobaya-likelihood route (reference: gpry/mc.py:173)
        from gpry_tpu.mc.cobaya_mc import mc_sample_from_gp_cobaya
        flavor = "polychord" if sampler.endswith("polychord") else "mcmc"
        return mc_sample_from_gp_cobaya(
            gpr, bounds=bounds, params=options.pop("params", None),
            sampler=flavor, covmat=options.pop("covmat", None),
            add_options=options, rng=rng, verbose=verbose)
    bounds = check_and_return_bounds(
        bounds if bounds is not None else gpr.bounds)
    d = bounds.shape[0]
    # sweep dtype policy: models/gp.py:sweep_dtype
    p = gpr.sweep_params()
    dt = p.X.dtype
    lo = jnp.asarray(bounds[:, 0], dt)
    hi = jnp.asarray(bounds[:, 1], dt)
    logp = surrogate_logp_fn(gpr.family)
    seed = None
    if isinstance(rng, np.random.Generator):
        seed = int(rng.integers(2**31))
    elif rng is not None:
        seed = int(rng)
    else:
        # fresh OS entropy — a fixed default key would perfectly correlate
        # e.g. every fallback-MCMC convergence estimate of a run (and of
        # every run), hiding the estimator's stochastic variability
        seed = int(np.random.default_rng().integers(2**31))
    key = jax.random.PRNGKey(seed)

    if sampler in ("polychord", "ultranest", "nessai"):
        # Host NS engines over the surrogate (reference:
        # gpry/mc.py:328-455 dispatching into gpry/ns_interfaces.py); the
        # likelihood they see is one batched jitted device predict.
        from gpry_tpu.mc.interfaces import _ns_interfaces
        iface = _ns_interfaces[sampler](
            verbose=verbose, out_dir=options.get("out_dir"))
        iface.set_prior(bounds, params=options.get("params"))
        nlive = get_Xnumber(options.get("nlive", "50d"), "d", d, dtype=int,
                            varname="nlive")
        num_repeats = get_Xnumber(options.get("num_repeats", "5d"), "d", d,
                                  dtype=int, varname="num_repeats")
        iface.set_precision(
            nlive=int(nlive), num_repeats=int(num_repeats),
            precision_criterion=float(options.get("precision_criterion",
                                                  0.01)),
            nprior=options.get("nprior"), seed=seed)

        def logp_host(X):
            X = np.atleast_2d(np.asarray(X, dtype=float))
            return np.asarray(surrogate_predict_mean(
                gpr.family, p, jnp.asarray(X, dt)), dtype=float)

        out = iface.run(logp_host)
        gpr.n_eval += int(out.get("n_calls", len(out["X"])))
        return out
    if sampler == "nested":
        nlive = get_Xnumber(options.get("nlive", "50d"), "d", d, dtype=int,
                            varname="nlive")
        num_repeats = get_Xnumber(options.get("num_repeats", "5d"), "d", d,
                                  dtype=int, varname="num_repeats")
        max_dead = int(options.get("max_dead", max(4000, 60 * d * nlive //
                                                   max(1, d))))
        from gpry_tpu.models.gp import ns_proposal_params
        from gpry_tpu.parallel.mesh import available_mesh
        # NS proposal loop in f32 only when asked for; the sample is then
        # re-scored in the sweep dtype below (models/gp.py:ns_proposal_params)
        p_ns, corrected = ns_proposal_params(
            p, gpr.f32_sweep_error_estimate())
        ndt = p_ns.X.dtype
        res = run_nested_device(
            logp, p_ns, key, lo.astype(ndt), hi.astype(ndt),
            nlive=int(nlive), num_repeats=int(num_repeats),
            precision_criterion=float(options.get("precision_criterion",
                                                  0.01)),
            max_dead=max_dead, mesh=available_mesh(p_ns.X),
            # final-MC outer steps are heavy (nlive=50d chains x 5d
            # repeats); keep each device program short.  Overridden by
            # the ns_steps_per_call option or GPRY_TPU_NS_SEG_STEPS.
            max_steps_per_call=options.get(
                "ns_steps_per_call",
                int(os.environ.get("GPRY_TPU_NS_SEG_STEPS", 8))),
            on_segment=heartbeat)
        logw = np.asarray(res.logw, dtype=float)
        keep = np.isfinite(logw) & np.isfinite(np.asarray(res.logl))
        X = np.asarray(res.X, dtype=float)[keep]
        logl = np.asarray(res.logl, dtype=float)[keep]
        logw = logw[keep]
        logZ = float(res.logZ)
        if corrected:
            from scipy.special import logsumexp
            mu = np.asarray(surrogate_predict_mean(
                gpr.family, p, jnp.asarray(X, dt)), dtype=float)
            lse_old = logsumexp(logw)
            with np.errstate(invalid="ignore"):
                logw = logw + (mu - logl)
            logw = np.where(np.isfinite(logw), logw, -np.inf)
            logZ += float(logsumexp(logw) - lse_old)
            logl = mu
        w = np.exp(logw - np.max(logw))
        out = {
            "X": X,
            "logpost": logl,
            "weights": w,
            "logZ": logZ,
            "n_calls": int(res.n_calls),
        }
        gpr.n_eval += int(res.n_calls)
        if options.get("refine", True):
            # Mixture-IS refinement (mc/refine.py): one huge batched
            # device predict fixes the NS sample's mode-weight noise —
            # on multimodal targets the dominant final-sample error.
            from gpry_tpu.mc.refine import is_refine_sample
            out = is_refine_sample(
                gpr, out, bounds, rng=rng,
                n_draw=int(options.get("refine_n_draw", 65536)),
                verbose=verbose)
        return out
    if sampler == "mcmc":
        from gpry_tpu.mc.mcmc import split_rhat
        n_chains = int(options.get("n_chains", max(8, 2 * d)))
        n_steps = int(options.get("n_steps", 2000))
        X3, logpost3 = run_mcmc_device(
            logp, p, key, lo, hi, n_chains=n_chains, n_steps=n_steps,
            covmat=options.get("covmat"))
        # cross-chain convergence diagnostic (the reference leans on
        # Cobaya's R-1 here, gpry/convergence.py:430-472)
        rhat = split_rhat(np.asarray(X3))
        if verbose >= 2 and not (rhat - 1.0 < 0.1):
            import warnings
            warnings.warn(
                f"On-device MCMC may not have converged: split-R-hat = "
                f"{rhat:.3f} (> 1.1). Increase n_steps/n_chains.")
        X = np.asarray(X3).reshape(-1, d)
        logpost = np.asarray(logpost3).ravel()
        keep = np.isfinite(logpost)
        # exact device-eval count: 16 start tries per chain, then one
        # proposal eval per chain per step over warmup (n_steps//2, the
        # run_mcmc_device default) + sampling phases
        gpr.n_eval += n_chains * (16 + n_steps // 2 + n_steps)
        out = {"X": X[keep], "logpost": logpost[keep],
               "weights": np.ones(int(keep.sum())), "rhat": rhat}
        if options.get("refine", True):
            from gpry_tpu.mc.refine import is_refine_sample
            out = is_refine_sample(
                gpr, out, bounds, rng=rng,
                n_draw=int(options.get("refine_n_draw", 65536)),
                verbose=verbose)
        return out
    if sampler == "uniform":
        # For tests only (reference: gpry/gp_acquisition.py:748-758).
        n = int(options.get("n_samples", 5000))
        X = np.asarray(jax.random.uniform(key, (n, d), dt) * (hi - lo) + lo)
        logpost = np.asarray(surrogate_predict_mean(
            gpr.family, p, jnp.asarray(X, dt)))
        gpr.n_eval += n
        return {"X": X, "logpost": logpost, "weights": np.ones(n)}
    raise ValueError(f"Unknown sampler '{sampler}'.")


def process_gdsamples(samples_dict, params=None, name=None):
    """Alias of :func:`samples_dict_to_getdist` (reference: gpry/mc.py:459)."""
    return samples_dict_to_getdist(samples_dict, params=params, name=name)


def samples_dict_to_getdist(samples_dict, params=None, name=None):
    """
    Convert a samples dict to a getdist.MCSamples (reference:
    gpry/mc.py:484).  Requires getdist (optional dependency).
    """
    try:
        from getdist import MCSamples
    except ImportError as excpt:
        raise ImportError(
            "getdist is not installed; install it for MCSamples export."
        ) from excpt
    X = np.asarray(samples_dict["X"])
    d = X.shape[1]
    names = params or generic_params_names(d)
    return MCSamples(
        samples=X,
        weights=np.asarray(samples_dict.get("weights")),
        loglikes=-np.asarray(samples_dict.get("logpost")),
        names=names,
        name_tag=name,
    )


def write_samples_txt(samples_dict, path, params=None):
    """
    Plain-text chain output (weight, -logpost, params...) like the
    reference's final-MC chain files (gpry/mc.py:432-455).
    """
    X = np.asarray(samples_dict["X"])
    w = np.asarray(samples_dict.get("weights", np.ones(len(X))))
    logp = np.asarray(samples_dict.get("logpost", np.zeros(len(X))))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = np.column_stack([w, -logp, X])
    header = "weight minus_logpost " + " ".join(
        params or generic_params_names(X.shape[1]))
    np.savetxt(path, data, header=header)
