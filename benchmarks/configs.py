"""
BASELINE.md benchmark configs 2 and 5 (configs 1/3/4 are covered by
tests/test_pipeline.py + bench.py + tests/test_curved.py):

2. 8-D correlated Gaussian, Matérn-3/2 kernel, periodic hyperparameter
   refits (the default fit_full_every cadence);
5. Cobaya-wrapped smooth 6-D likelihood (LCDM-like stand-in: correlated
   Gaussian) driven through the CobayaWrapper with host-parallel truth
   evaluation, final MC through the surrogate-as-Cobaya-likelihood route.

Writes benchmarks/results_configs.json.  Runs on CPU (see grid.py note).
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))


def config2_matern(n_runs=3, seed0=300, verbose=1):
    from model_generator import kl_truth_gaussian, random_gaussian
    from gpry_tpu.run import Runner

    out = []
    for i in range(n_runs):
        m = random_gaussian(d=8, rng=seed0 + i)
        t0 = time.time()
        runner = Runner(m.loglike, bounds=m.bounds, seed=seed0 + i,
                        verbose=verbose,
                        gpr={"kernel": {"Matern": {"nu": 1.5}}},
                        gp_acquisition={"NORA": {}})
        runner.run()
        X, w, _ = runner.last_mc_samples()
        out.append({
            "run": i, "converged": runner.has_converged,
            "n_total": runner.gpr.n_total,
            "kl_final": kl_truth_gaussian(X, w, m.mean, m.cov),
            "wall_s": round(time.time() - t0, 1),
        })
        print(f"config2 run {i}: {out[-1]}")
    return out


def config5_cobaya(n_runs=3, seed0=400, verbose=1):
    import minicobaya
    from model_generator import kl_truth_gaussian, random_gaussian
    minicobaya.install()   # API-compatible double; real cobaya if installed
    try:
        from cobaya.model import get_model
        from gpry_tpu.cobaya import CobayaWrapper

        out = []
        for i in range(n_runs):
            m = random_gaussian(d=6, rng=seed0 + i)
            params = [f"p{j}" for j in range(6)]

            def make_lkl(m):
                def lkl(**kw):
                    return m.loglike(np.array([kw[p] for p in params]))
                return lkl

            info = {
                "likelihood": {"gauss": {"external": make_lkl(m),
                                         "input_params": params}},
                "params": {p: {"prior": [float(b[0]), float(b[1])]}
                           for p, b in zip(params, m.bounds)},
            }
            model = get_model(info)
            t0 = time.time()
            wrapper = CobayaWrapper({
                "seed": seed0 + i, "verbose": verbose,
                "mc_sampler": "cobaya_mcmc",
            }, model)
            wrapper.run()
            sample = wrapper.samples()
            out.append({
                "run": i,
                "converged": wrapper.gpry_runner.has_converged,
                "n_total": wrapper.gpry_runner.gpr.n_total,
                "kl_final": kl_truth_gaussian(
                    sample["X"], sample["weights"], m.mean, m.cov),
                "wall_s": round(time.time() - t0, 1),
            })
            print(f"config5 run {i}: {out[-1]}")
        return out
    finally:
        minicobaya.uninstall()


if __name__ == "__main__":
    if "--accelerator" not in sys.argv:
        import jax
        jax.config.update("jax_default_device", "cpu")
    n_runs = int(sys.argv[1]) if len(sys.argv) > 1 and \
        sys.argv[1].isdigit() else 3
    results = {
        "config2_matern32_d8": config2_matern(n_runs=n_runs),
        "config5_cobaya_wrapped_d6": config5_cobaya(n_runs=n_runs),
    }
    for name, runs in results.items():
        kls = [r["kl_final"] for r in runs]
        evals = [r["n_total"] for r in runs]
        print(f"{name}: evals median {np.median(evals):.0f}, "
              f"KL median {np.median(kls):.4f}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_configs.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=float)
    print("->", path)
