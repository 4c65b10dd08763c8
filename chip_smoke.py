"""
Smoke test of gpry_tpu on an NVIDIA GPU, through the entry points a user
calls.

    python chip_smoke.py          # phases (a), (b), (c) on one card
    python chip_smoke.py --four   # the automatic multi-card mesh path,
                                  # against the same run on one card

Phases (one card):

(a) canonical drive: a d=2 GP surrogate of a Gaussian, nested-sampled;
    the weighted mean and logZ are checked against the analytic truth.
(b) reference comparison at real widths: a d=16, N=1024 hyperparameter
    fit; the predictive mean and variance on 4096 points and the LML, at
    the fitted and at unit hyperparameters, are compared with a
    NumPy/SciPy float64 reference built here; then one NORA ``multi_add``
    of d points.
(c) the main path end to end: ``Runner(...).run()`` and
    ``generate_mc_sample()`` on the d=8 random Gaussian of
    ``tests/model_generator.py``, gated on convergence and KL <= 0.05.

Each phase prints one JSON line with its numbers and the seconds it took,
its first call's compilation included; any failure exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``.  Without a GPU the script
exits non-zero before any phase.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

KL_GATE = 0.05


def emit(phase, **numbers):
    print(json.dumps({"phase": phase, **numbers}, default=_jsonable),
          flush=True)


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.generic,)):
        return x.item()
    return str(x)


def check(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def memory_stats_of(compiled):
    """Byte counts of ``compiled.memory_analysis()`` (None where the
    backend reports none)."""
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: int(getattr(ma, k)) for k in dir(ma)
            if k.endswith("_in_bytes")}


# ---------------------------------------------------------------------------
# (a) canonical drive
# ---------------------------------------------------------------------------

def phase_canonical(n_train=40, seed=2):
    """d=2 GP + nested MC on a Gaussian; mean within 3% of the box of the
    truth, logZ within 3 sigma of its analytic value."""
    from gpry_tpu.mc import mc_sample_from_gp
    from gpry_tpu.models import GaussianProcessRegressor
    from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y

    t0 = time.perf_counter()
    bounds = np.array([[-2.0, 2.0], [-2.0, 2.0]])
    mu, sigma = np.array([0.2, -0.3]), np.array([0.35, 0.2])

    def loglike(X):
        return -0.5 * np.sum(((np.atleast_2d(X) - mu) / sigma) ** 2, axis=1)

    X = np.random.default_rng(1).uniform(-2, 2, size=(n_train, 2))
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=10,
        random_state=3, verbose=0)
    gpr.append_to_data(X, loglike(X))
    nlive = 50 * 2
    s = mc_sample_from_gp(gpr, sampler="nested", rng=seed,
                          options={"nlive": nlive})
    w = s["weights"] / np.sum(s["weights"])
    mean = w @ s["X"]
    box = bounds[:, 1] - bounds[:, 0]
    mean_err_box = float(np.max(np.abs(mean - mu) / box))
    # uniform prior on the box: Z = (2 pi sigma_1 sigma_2) / box volume
    logz_true = float(np.log(2 * np.pi * np.prod(sigma) / np.prod(box)))
    # NS evidence error sqrt(H / nlive), H the prior-to-posterior KL
    info = float(w @ s["logpost"] - s["logZ"])
    logz_sigma = float(np.sqrt(max(info, 0.0) / nlive))
    out = dict(n_train=n_train, mean=mean, mean_err_over_box=mean_err_box,
               logZ=s["logZ"], logZ_true=logz_true, logZ_sigma=logz_sigma,
               seconds=time.perf_counter() - t0)
    emit("a_canonical", **out)
    check(mean_err_box <= 0.03, "weighted mean within 3% of the box")
    check(abs(s["logZ"] - logz_true) <= 3 * logz_sigma,
          "logZ within 3 sigma of the analytic value")
    return out


# ---------------------------------------------------------------------------
# (b) reference comparison at real widths
# ---------------------------------------------------------------------------

def fitted_gpr(d, n, seed=0):
    """A GP fitted to bench.py's quadratic data with 10 + 2d restarts."""
    from bench import make_data
    from gpry_tpu.models import GaussianProcessRegressor
    from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y

    bounds, X, y = make_data(d, n, seed)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=seed, verbose=0)
    gpr.append_to_data(X, y, fit_gpr=False)
    gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * d)
    return gpr


def at_unit_theta(gpr):
    """The GP refactorized at unit amplitude and unit length-scales (in the
    normalized box): a dense, non-trivial kernel matrix whatever the fit
    found."""
    gpr._theta = np.zeros(1 + gpr.d)
    gpr._update_model()
    return gpr


#: (quantity, tolerance) of the reference comparison: mean over max|y|,
#: variance over the prior variance (from which the posterior variance is
#: subtracted: near the data it is a small difference of large terms),
#: LML relative
REFERENCE_TOLERANCES = {"mean": 1e-8, "var": 1e-6, "lml": 1e-8}


def compare_with_reference(gpr, Xq):
    """Deviations of the GP's prediction and LML from the reference, each
    in the units of ``REFERENCE_TOLERANCES``, beside the float64 floor of
    the problem: how far the Cholesky reference is from the same
    quantities computed through an eigendecomposition (on an
    ill-conditioned kernel, cond(K) ~ 1e12, two float64 algorithms differ
    by more than 1e-8 in the LML)."""
    mean, std = gpr.predict(Xq, return_std=True)
    var = np.asarray(std, dtype=float) ** 2
    lml = gpr.log_marginal_likelihood()
    mean_r, var_r, prior_var, lml_r = reference_prediction(gpr, Xq)
    mean_e, var_e, _, lml_e = reference_prediction(gpr, Xq, eigh=True)
    y_max = float(np.max(np.abs(gpr.y_train)))

    def devs(m, v, l):
        return {"mean": float(np.max(np.abs(m - mean_r)) / y_max),
                "var": float(np.max(np.abs(v - var_r)) / prior_var),
                "lml": float(abs(l - lml_r) / abs(lml_r))}

    return dict(theta=np.asarray(gpr._theta), lml=lml,
                mean_range=float(np.ptp(mean_r)), err=devs(mean, var, lml),
                float64_floor=devs(mean_e, var_e, lml_e))


def check_reference(cmp, where):
    """Each deviation within its tolerance, or within twice the float64
    floor where the problem's conditioning puts that floor higher."""
    for k, tol in REFERENCE_TOLERANCES.items():
        bound = max(tol, 2 * cmp["float64_floor"][k])
        check(cmp["err"][k] <= bound,
              f"{where}: {k} within {bound:.3g} of the reference")


def reference_prediction(gpr, Xq, eigh=False):
    """Mean, latent variance, prior variance and LML of the fitted GP,
    recomputed in plain NumPy/SciPy float64 from its training set and
    hyperparameters, through a Cholesky factorization (or, with ``eigh``,
    an eigendecomposition of the kernel matrix)."""
    from scipy.linalg import cho_factor, cho_solve
    from scipy.spatial.distance import cdist

    from gpry_tpu.models.preprocessing import affine_params_X, \
        affine_params_y

    d, n = gpr.d, gpr.n
    x_loc, x_scale = affine_params_X(gpr.preprocessing_X, d)
    y_loc, y_scale = affine_params_y(gpr.preprocessing_y)
    Xt = (gpr.X_train - x_loc) / x_scale
    yt = (gpr.y_train - y_loc) / y_scale
    theta = np.asarray(gpr._theta, dtype=float)
    amp, ls = np.exp(theta[0]), np.exp(theta[1:])

    def k(A, B):   # RBF with ARD length-scales
        return amp * np.exp(-0.5 * cdist(A / ls, B / ls, "sqeuclidean"))

    noise = np.broadcast_to(np.asarray(gpr._noise_var_, dtype=float),
                            (int(gpr._dX.shape[0]),))[:n]
    K = k(Xt, Xt) + np.diag(noise)
    Ks = k((Xq - x_loc) / x_scale, Xt)
    if eigh:
        lam, U = np.linalg.eigh(K)
        alpha = U @ ((U.T @ yt) / lam)
        quad = np.sum((Ks @ U) ** 2 / lam, axis=1)
        half_logdet = 0.5 * np.sum(np.log(lam))
    else:
        c = cho_factor(K, lower=True)
        alpha = cho_solve(c, yt)
        quad = np.sum(Ks * cho_solve(c, Ks.T).T, axis=1)
        half_logdet = np.sum(np.log(np.diagonal(c[0])))
    mean = Ks @ alpha * y_scale + y_loc
    clip = 1.1 * np.max(gpr.y_train) - 0.1 * np.min(gpr.y_train)
    mean = np.minimum(mean, clip)
    var = (amp - quad) * y_scale ** 2
    lml = -0.5 * yt @ alpha - half_logdet - 0.5 * n * np.log(2 * np.pi)
    return mean, np.maximum(var, 0.0), amp * y_scale ** 2, float(lml)


def ns_segment_memory(gpr, acq):
    """``memory_analysis()`` of one compiled NORA nested-sampling segment."""
    import jax
    import jax.numpy as jnp

    from gpry_tpu.mc.nested import _ns_init, _ns_segment
    from gpry_tpu.mc.samples import surrogate_logp_fn

    p = gpr.sweep_params()
    lo = jnp.asarray(gpr.bounds[:, 0], p.X.dtype)
    hi = jnp.asarray(gpr.bounds[:, 1], p.X.dtype)
    nlive = acq._nlive(gpr)
    max_dead = int(nlive * max(8, 2 * gpr.d))
    n_prior = int(acq.nprior_per_nlive) * nlive
    logl = surrogate_logp_fn(gpr.family)
    state = _ns_init(logl, p, jax.random.PRNGKey(0), lo, hi, nlive=nlive,
                     n_prior=n_prior, max_dead=max_dead)
    kill_batch = max(1, nlive // 6)
    compiled = _ns_segment.lower(
        logl, p, state, lo, hi, acq.precision_criterion_target,
        nlive=nlive, num_repeats=int(acq.num_repeats), max_dead=max_dead,
        kill_batch=kill_batch, mesh=None, n_prior=n_prior,
        seg_steps=min(max_dead // kill_batch + 2, 32)).compile()
    return memory_stats_of(compiled)


def fit_memory(gpr, maxiter=120):
    """``memory_analysis()`` of the compiled multi-restart fit."""
    import jax.numpy as jnp

    from gpry_tpu.models.gp import LBFGS_CHUNK, _fit_theta_restarts

    lo, hi = np.asarray(gpr.theta_bounds, dtype=float).T
    theta0s = np.random.default_rng(0).uniform(
        lo, hi, size=(LBFGS_CHUNK, len(lo)))
    dt = gpr._dX.dtype
    compiled = _fit_theta_restarts.lower(
        gpr.family, gpr._dX, gpr._dy, gpr.n, gpr._noise_var_,
        jnp.asarray(theta0s, dt), jnp.asarray(lo, dt), jnp.asarray(hi, dt),
        maxiter=maxiter).compile()
    return memory_stats_of(compiled)


def phase_reference(d=16, n=1024, n_query=4096, seed=0):
    """Fit at real widths, compare with the float64 reference at the fitted
    and at unit hyperparameters, and run one NORA batch of d points."""
    import jax

    from gpry_tpu.acquisition import NORA

    t0 = time.perf_counter()
    gpr = fitted_gpr(d, n, seed)
    t_fit = time.perf_counter() - t0
    Xq = np.random.default_rng(seed + 1).uniform(size=(n_query, d))
    at_fit = compare_with_reference(gpr, Xq)

    t1 = time.perf_counter()
    acq = NORA(gpr.bounds, acq_func={"LogExp": {"dimension": d}},
               rng=np.random.default_rng(seed + 2), verbose=0)
    X_new, _, acq_vals = acq.multi_add(gpr, n_points=d)
    t_acq = time.perf_counter() - t1
    in_bounds = bool(np.all((X_new >= gpr.bounds[:, 0])
                            & (X_new <= gpr.bounds[:, 1])))
    distinct = len(np.unique(X_new, axis=0)) == len(X_new)

    fit_mem = fit_memory(gpr)
    ns_mem = ns_segment_memory(gpr, acq)
    at_unit = compare_with_reference(at_unit_theta(gpr), Xq)
    stats = jax.devices()[0].memory_stats() or {}
    out = dict(
        d=d, n=n, n_query=n_query, at_fitted_theta=at_fit,
        at_unit_theta=at_unit, n_points=len(X_new),
        in_bounds=in_bounds, distinct=distinct,
        acq_finite=bool(np.all(np.isfinite(acq_vals))),
        fit_seconds=t_fit, nora_seconds=t_acq,
        fit_memory=fit_mem, ns_segment_memory=ns_mem,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        bytes_limit=stats.get("bytes_limit"),
        seconds=time.perf_counter() - t0)
    emit("b_reference", **out)
    check_reference(at_fit, "fitted theta")
    check_reference(at_unit, "unit theta")
    check(len(X_new) == d and in_bounds and distinct,
          "NORA: d distinct points in bounds")
    check(out["acq_finite"], "NORA: finite acquisition values")
    return out


# ---------------------------------------------------------------------------
# (c) main path end to end
# ---------------------------------------------------------------------------

def run_main_path(d=8, seed=8, gp_acquisition=None):
    """``Runner(...).run()`` then ``generate_mc_sample()``, at defaults
    unless an acquisition engine is named."""
    from model_generator import kl_truth_gaussian, random_gaussian

    from gpry_tpu.run import Runner

    m = random_gaussian(d=d, rng=seed)
    t0 = time.perf_counter()
    kw = {} if gp_acquisition is None else {"gp_acquisition": gp_acquisition}
    runner = Runner(m.loglike, bounds=m.bounds, seed=seed, verbose=1, **kw)
    runner.run()
    runner.generate_mc_sample()
    X, w, _ = runner.last_mc_samples()
    return dict(d=d, seed=seed, truth_evals=int(runner.gpr.n_total),
                converged=bool(runner.has_converged),
                kl=float(kl_truth_gaussian(X, w, m.mean, m.cov)),
                seconds=time.perf_counter() - t0)


def phase_main_path(d=8, seed=8):
    out = run_main_path(d, seed)
    emit("c_main_path", **out)
    check(out["converged"], "the Runner converged")
    check(out["kl"] <= KL_GATE, f"KL <= {KL_GATE}")
    return out


# ---------------------------------------------------------------------------
# --four: the automatic mesh path against one card
# ---------------------------------------------------------------------------

def phase_four(d=8, seed=8, d_tp=16, n_tp=1024, n_query=256):
    """Runner on the automatic multi-device mesh and again on one device
    under ``mesh_disabled()``; then TP prediction against one device.  The
    Runner uses NORA, whose nested-sampling sweeps take the row-sharded
    predict path (the default engine's sweeps do not)."""
    import jax
    import jax.numpy as jnp

    from gpry_tpu.models.gp import surrogate_predict
    from gpry_tpu.parallel.mesh import SHARD_STATS, available_mesh, \
        mesh_disabled, tp_predict

    before = dict(SHARD_STATS)
    mesh_run = run_main_path(d, seed, "NORA")
    shard = {k: SHARD_STATS[k] - before[k] for k in SHARD_STATS}
    with mesh_disabled():
        one_run = run_main_path(d, seed, "NORA")
    evals_ratio = mesh_run["truth_evals"] / one_run["truth_evals"]
    emit("four_runner", n_devices=len(jax.devices()), mesh=mesh_run,
         one_device=one_run, shard_dispatches=shard,
         truth_evals_ratio=evals_ratio)

    t0 = time.perf_counter()
    gpr = at_unit_theta(fitted_gpr(d_tp, n_tp))
    p = gpr.surrogate_params()
    mesh = available_mesh(p.X)
    Xq = jnp.asarray(np.random.default_rng(3).uniform(size=(n_query, d_tp)),
                     p.X.dtype)
    m_tp, s_tp = (np.asarray(a) for a in tp_predict(gpr.family, p, Xq, mesh))
    m_1, s_1 = (np.asarray(a) for a in surrogate_predict(gpr.family, p, Xq))
    mean_rel = float(np.max(np.abs(m_tp - m_1)) / np.max(np.abs(m_1)))
    prior_var = float(np.exp(gpr._theta[0])) * float(p.y_scale) ** 2
    var_rel = float(np.max(np.abs(s_tp ** 2 - s_1 ** 2)) / prior_var)
    emit("four_tp_predict", d=d_tp, n=n_tp, n_query=n_query,
         theta=np.asarray(gpr._theta),
         mesh_size=None if mesh is None else int(mesh.size),
         mean_rel_err=mean_rel, var_err_over_prior_var=var_rel,
         seconds=time.perf_counter() - t0)

    check(shard["fit"] > 0 and shard["predict"] > 0,
          "the mesh run used the sharded fit and predict")
    check(abs(evals_ratio - 1) <= 0.10, "truth evals within 10%")
    for name, run in (("mesh", mesh_run), ("one device", one_run)):
        check(run["converged"] and run["kl"] <= KL_GATE,
              f"{name} run converged with KL <= {KL_GATE}")
    check(mesh is not None, "a multi-device mesh is available")
    check(mean_rel <= 1e-9 and var_rel <= 1e-9,
          "TP prediction within 1e-9 relative of one device")


def main(argv):
    import jax

    from gpry_tpu import config
    from gpry_tpu.utils.device import card_name_and_power_limit, \
        device_info, require_gpu

    four = "--four" in argv
    devices = require_gpu()
    if four and len(devices) < 2:
        raise RuntimeError(f"--four needs several GPUs, found {len(devices)}")
    card = card_name_and_power_limit()
    print(card, flush=True)
    emit("setup", nvidia_smi=card, jax_version=jax.__version__,
         device=device_info(), compile_cache_dir=config.comp_cache_dir())
    if four:
        phase_four()
    else:
        phase_canonical()
        phase_reference()
        phase_main_path()
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
