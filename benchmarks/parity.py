"""
Head-to-head parity runs: this repo vs the LIVE reference implementation
(/root/reference) on identical fixtures and seeds.

North-star metric (BASELINE.md): evals-to-convergence and final posterior
quality (KL vs the analytically-known truth Gaussian, gate <= 0.05 as in
reference tests/test_pipeline.py:88) must match or beat the reference.

Methodology
-----------
* Same fixture per (d, seed): ``model_generator.random_gaussian(d, rng=seed)``.
* Both engines run their DEFAULT configuration: BatchOptimizer acquisition
  (the reference default, gpry/run.py:359) + CorrectCounter[s] convergence,
  default budgets (n_initial=3d, max_total=70d^1.5).
* The in-loop MC+diagnosis step is disabled on BOTH engines (the reference
  cannot run it on this host: its nested/cobaya MC backends are not
  installed), so both stop purely on the convergence criterion.
* Final KL is computed with ONE COMMON estimator for both engines: a
  numpy ensemble-MH sampler over each final surrogate's host ``predict``
  API, then the symmetric Gaussian-KL of the weighted sample vs the known
  truth (tests/model_generator.py:kl_truth_gaussian).

Usage: python benchmarks/parity.py [--dims 2,4,8] [--seeds 100,101,102]
Writes benchmarks/results_parity.json.
"""

import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))


# ---------------------------------------------------------------------------
# Common posterior-quality estimator (identical for both engines)
# ---------------------------------------------------------------------------


def mh_sample_surrogate(predict, bounds, rng, n_walkers=64, n_steps=4000):
    """
    Ensemble random-walk MH over a batched host ``predict(X) -> logp``.
    Returns (X (n, d), weights): post-burn-in equal-weight samples.
    """
    bounds = np.asarray(bounds, dtype=float)
    d = len(bounds)
    lo, hi = bounds[:, 0], bounds[:, 1]
    # start walkers at the best of a prior scatter
    X0 = rng.uniform(lo, hi, size=(n_walkers * 8, d))
    lp0 = np.asarray(predict(X0), dtype=float).ravel()
    order = np.argsort(lp0)[::-1]
    x = X0[order[:n_walkers]].copy()
    lp = lp0[order[:n_walkers]].copy()
    step = (hi - lo) / 20.0
    burn = n_steps // 3
    chains = []
    acc_hist = []
    for i in range(n_steps):
        prop = x + rng.normal(size=x.shape) * step
        inside = np.all((prop >= lo) & (prop <= hi), axis=1)
        lp_prop = np.full(n_walkers, -np.inf)
        if np.any(inside):
            lp_prop[inside] = np.asarray(
                predict(prop[inside]), dtype=float).ravel()
        accept = np.log(rng.uniform(size=n_walkers)) < (lp_prop - lp)
        x[accept] = prop[accept]
        lp[accept] = lp_prop[accept]
        rate = float(np.mean(accept))
        acc_hist.append(rate)
        if i < burn:
            # Robbins-Monro towards ~23.4% acceptance
            step = step * np.exp(0.1 * (rate - 0.234))
        else:
            chains.append(np.copy(x))
    Xs = np.concatenate(chains, axis=0)
    return Xs, np.ones(len(Xs))


# ---------------------------------------------------------------------------
# Engine drivers
# ---------------------------------------------------------------------------


def run_repo(model, seed, verbose=1):
    """Run this repo's Runner with MC+diagnosis disabled."""
    from gpry_tpu.run import Runner

    class _NoMCRunner(Runner):
        def generate_mc_sample(self, *a, **k):
            return None

        def diagnose_last_mc_sample(self):
            return True

    t0 = time.time()
    runner = _NoMCRunner(model.loglike, bounds=model.bounds, seed=seed,
                         verbose=verbose)
    runner.run()
    return {
        "engine": "gpry_tpu",
        "converged": bool(runner.has_converged),
        "n_total": int(runner.gpr.n_total),
        "n_finite": int(runner.gpr.n),
        "wall_s": time.time() - t0,
        "predict": lambda X: runner.gpr.predict(np.atleast_2d(X)),
    }


def _install_getdist_stub():
    if "getdist" in sys.modules:
        return
    gd = types.ModuleType("getdist")
    gd.__path__ = []
    mcs = types.ModuleType("getdist.mcsamples")
    mcs.MCSamples = object
    mcs.loadMCSamples = lambda *a, **k: None
    gm = types.ModuleType("getdist.gaussian_mixtures")
    gm.GaussianND = object
    for name, mod in (("getdist", gd), ("getdist.mcsamples", mcs),
                      ("getdist.gaussian_mixtures", gm)):
        sys.modules.setdefault(name, mod)


def run_reference(model, seed, verbose=1):
    """Run the LIVE reference Runner (CPU) with MC+diagnosis disabled."""
    _install_getdist_stub()
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    from gpry.run import Runner as RefRunner

    class _NoMCRefRunner(RefRunner):
        def generate_mc_sample(self, *a, **k):
            return None

        def diagnose_last_mc_sample(self):
            return True

    t0 = time.time()
    runner = _NoMCRefRunner(model.loglike, bounds=model.bounds, seed=seed,
                            verbose=verbose)
    runner.run()
    return {
        "engine": "reference",
        "converged": bool(runner.has_converged),
        "n_total": int(runner.gpr.n_total),
        "n_finite": int(runner.gpr.n),
        "wall_s": time.time() - t0,
        "predict": lambda X: runner.gpr.predict(np.atleast_2d(X)),
    }


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------


def run_parity(dims=(2, 4, 8), seeds=(100, 101, 102), verbose=1,
               fixture="gaussian"):
    from model_generator import (curved_degeneracy, kl_truth_gaussian,
                                 random_gaussian)

    rows = []
    for d in dims:
        for seed in seeds:
            if fixture == "gaussian":
                model = random_gaussian(d=d, rng=seed)
            elif fixture == "curved":
                model = curved_degeneracy()
            else:
                raise ValueError(fixture)
            for driver in (run_repo, run_reference):
                print(f"--- d={d} seed={seed} engine="
                      f"{driver.__name__} ...", flush=True)
                try:
                    res = driver(model, seed, verbose=verbose)
                except Exception as excpt:
                    rows.append({"d": d, "seed": seed,
                                 "engine": driver.__name__,
                                 "error": f"{type(excpt).__name__}: "
                                          f"{excpt}"})
                    print(f"    FAILED: {excpt}", flush=True)
                    continue
                predict = res.pop("predict")
                if model.mean is not None:
                    rng_mc = np.random.default_rng(10_000 + seed)
                    Xs, w = mh_sample_surrogate(predict, model.bounds,
                                                rng_mc)
                    kl = float(kl_truth_gaussian(Xs, w, model.mean,
                                                 model.cov))
                else:
                    kl = None
                res.update({"d": d, "seed": seed, "kl_final": kl})
                rows.append(res)
                print(f"    {res['engine']}: converged={res['converged']} "
                      f"n_total={res['n_total']} KL={kl} "
                      f"wall={res['wall_s']:.1f}s", flush=True)
    return rows


def summarize(rows):
    out = {"rows": rows, "summary": []}
    dims = sorted({r["d"] for r in rows if "error" not in r})
    for d in dims:
        for engine in ("gpry_tpu", "reference"):
            sel = [r for r in rows
                   if r.get("d") == d and r.get("engine") == engine
                   and "error" not in r]
            if not sel:
                continue
            out["summary"].append({
                "d": d,
                "engine": engine,
                "evals_to_stop": [r["n_total"] for r in sel],
                "evals_to_stop_median": float(np.median(
                    [r["n_total"] for r in sel])),
                "kl_final": [r["kl_final"] for r in sel],
                "kl_final_median": float(np.median(
                    [r["kl_final"] for r in sel
                     if r["kl_final"] is not None] or [np.nan])),
                "n_converged": int(sum(r["converged"] for r in sel)),
                "wall_s_median": float(np.median(
                    [r["wall_s"] for r in sel])),
            })
    return out


if __name__ == "__main__":
    import argparse

    # evals-to-convergence is hardware-independent; run on CPU (as
    # benchmarks/grid.py does by default)
    import jax
    jax.config.update("jax_default_device", "cpu")

    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="2,4,8")
    ap.add_argument("--seeds", default="100,101,102")
    ap.add_argument("--fixture", default="gaussian")
    ap.add_argument("--verbose", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dims = tuple(int(x) for x in args.dims.split(","))
    seeds = tuple(int(x) for x in args.seeds.split(","))
    rows = run_parity(dims=dims, seeds=seeds, verbose=args.verbose,
                      fixture=args.fixture)
    out = summarize(rows)
    path = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results_parity.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps(out["summary"], indent=1))
    print(f"-> {path}")
