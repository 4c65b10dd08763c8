"""
Single-process timer of one surrogate-side iteration on a GPU.

One iteration is a full multi-restart hyperparameter fit (10 + 2d
restarts, gpry/run.py:317) plus one NORA ``multi_add`` of d
Kriging-believer points (a fresh on-device NS run + ranked-pool
selection), on a quadratic log-posterior at two operating points: d=8 with
N=224 training points (the expected training-set size at convergence,
tests/grid.py:77-80 heuristic) and d=16 with N=1024.  Each point is run
once cold (its compilation included, reported apart) and then timed
``--iters`` times; the median is reported beside every sample.

    python bench.py                  # both operating points
    python bench.py --sweep-compare  # d=8: float64 vs float32 sweeps

``--sweep-compare`` times the d=8 iteration with the default float64
sweeps and again with ``SWEEP_DTYPE="float32"`` (float32 products at
highest precision), and reports the largest float32-vs-float64 difference
in predicted log-posterior over the last NS sample.

Fails without a GPU.  Prints the card's name and power limit, then one
JSON line.
"""

import json
import sys
import time

import numpy as np


def make_data(d, n, seed=0):
    """A quadratic log-posterior on the unit box, sampled uniformly."""
    rng = np.random.default_rng(seed)
    bounds = np.array([[0.0, 1.0]] * d)
    X = rng.uniform(size=(n, d))
    y = -0.5 * 25 * np.sum((X - 0.5) ** 2, axis=1)
    return bounds, X, y


def setup(d, n):
    from gpry_tpu.acquisition import NORA
    from gpry_tpu.models.gp import GaussianProcessRegressor
    from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y

    bounds, X, y = make_data(d, n)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), random_state=0, verbose=0)
    gpr.append_to_data(X, y, fit_gpr=False)
    acq = NORA(bounds, acq_func={"LogExp": {"dimension": d}},
               rng=np.random.default_rng(1), verbose=0)
    return gpr, acq


def iteration(gpr, acq):
    """Seconds of one fit + NORA batch (its outputs are host arrays, so
    the device work has finished when it returns)."""
    d = gpr.d
    t0 = time.perf_counter()
    gpr.fit_gpr_hyperparameters(n_restarts=10 + 2 * d)
    acq.force_resample()      # a fresh NS every iteration
    acq.multi_add(gpr, n_points=d)
    return time.perf_counter() - t0


def time_iterations(gpr, acq, n_iters):
    cold = iteration(gpr, acq)
    times = [iteration(gpr, acq) for _ in range(n_iters)]
    return {"median_s": float(np.median(times)), "samples_s": times,
            "cold_s": cold}


def sweep_compare(n_iters):
    """d=8, N=224: float64 sweeps, then float32 sweeps, in one process."""
    import jax.numpy as jnp

    from gpry_tpu import config
    from gpry_tpu.models.gp import cast_surrogate, surrogate_predict_mean

    gpr, acq = setup(8, 224)
    out = {"float64": time_iterations(gpr, acq, n_iters)}
    old = config.SWEEP_DTYPE
    config.SWEEP_DTYPE = "float32"
    try:
        out["float32"] = time_iterations(gpr, acq, n_iters)
    finally:
        config.SWEEP_DTYPE = old
    p64 = gpr.surrogate_params()
    p32 = cast_surrogate(p64, jnp.float32)
    X = acq.last_MC_X
    mu64 = np.asarray(surrogate_predict_mean(gpr.family, p64,
                                             jnp.asarray(X, jnp.float64)))
    mu32 = np.asarray(surrogate_predict_mean(gpr.family, p32,
                                             jnp.asarray(X, jnp.float32)),
                      dtype=float)
    ok = np.isfinite(mu64) & np.isfinite(mu32)
    out["ns_sample_size"] = len(X)
    out["max_abs_logp_diff_f32_vs_f64"] = float(np.max(np.abs(
        mu32[ok] - mu64[ok])))
    out["f32_sweep_error_estimate"] = float(gpr.f32_sweep_error_estimate())
    return out


def main(argv):
    import argparse

    import jax

    from gpry_tpu.utils.device import card_name_and_power_limit, \
        device_info, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--sweep-compare", action="store_true")
    args = ap.parse_args(argv)
    require_gpu()
    card = card_name_and_power_limit()
    print(card, flush=True)
    result = {"device": device_info(), "card": card,
              "jax_version": jax.__version__, "iters": args.iters}
    if args.sweep_compare:
        result["sweep_compare_d8_n224"] = sweep_compare(args.iters)
    else:
        for d, n in ((8, 224), (16, 1024)):
            gpr, acq = setup(d, n)
            result[f"d{d}_n{n}"] = time_iterations(gpr, acq, args.iters)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
