"""
Benchmark grid driver.

Mirrors the reference's tests/grid.py: run the full loop on a grid of
random correlated Gaussians at a given dimension (optionally over a grid of
zeta values), tracking KL(surrogate Gaussian || truth) against the number
of truth evaluations; the expected-convergence heuristic is
``n_approx_conv(d) = 3.5 d^2`` truth evaluations (reference:
tests/grid.py:77-80).

Usage: python benchmarks/grid.py [d] [n_runs]
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).parent.parent))


def n_approx_conv(d):
    """Expected truth evals to convergence on Gaussians (reference
    heuristic, tests/grid.py:77-79)."""
    return int(3.5 * d**2)


def run_grid(d=4, n_runs=3, zeta_scaling=0.85, seed0=100, verbose=1):
    from model_generator import kl_truth_gaussian, random_gaussian
    from gpry_tpu.run import Runner
    from gpry_tpu.utils.tools import kl_norm, mean_covmat_from_evals

    results = []
    for i in range(n_runs):
        m = random_gaussian(d=d, rng=seed0 + i)
        kl_track = []

        def callback(runner):
            # KL of a Gaussian fit to the training evals vs the truth,
            # every iteration (reference: tests/grid.py:88-120)
            try:
                mean, cov = mean_covmat_from_evals(runner.gpr.X_train,
                                                   runner.gpr.y_train)
                kl = kl_norm(mean, cov, m.mean, m.cov)
            except Exception:
                kl = np.nan
            kl_track.append((runner.gpr.n_total, kl))

        t0 = time.time()
        runner = Runner(m.loglike, bounds=m.bounds, seed=seed0 + i,
                        verbose=verbose, callback=callback,
                        gp_acquisition={"NORA": {"zeta_scaling":
                                                 zeta_scaling}})
        runner.run()
        X, w, _ = runner.last_mc_samples()
        kl_final = kl_truth_gaussian(X, w, m.mean, m.cov)
        results.append({
            "run": i,
            "converged": runner.has_converged,
            "n_total": runner.gpr.n_total,
            "n_expected": n_approx_conv(d),
            "kl_final": kl_final,
            "wall_s": time.time() - t0,
            "kl_track": kl_track,
        })
        print(f"run {i}: converged={runner.has_converged} "
              f"n_total={runner.gpr.n_total} (expected ~{n_approx_conv(d)}) "
              f"KL={kl_final:.4f} wall={results[-1]['wall_s']:.1f}s")
    return results


if __name__ == "__main__":
    import json
    import os

    # The grid measures evals-to-convergence and posterior quality —
    # hardware-independent — so it runs on CPU by default (pass
    # --accelerator to run on the default device).
    if "--accelerator" not in sys.argv:
        import jax
        jax.config.update("jax_default_device", "cpu")
    sys.argv = [a for a in sys.argv if a != "--accelerator"]

    d = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_runs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    res = run_grid(d=d, n_runs=n_runs)
    n_tot = [r["n_total"] for r in res]
    kls = [r["kl_final"] for r in res]
    summary = {
        "d": d,
        "n_runs": n_runs,
        "evals_to_stop": n_tot,
        "evals_to_stop_median": float(np.median(n_tot)),
        "reference_heuristic_3.5d2": n_approx_conv(d),
        "kl_final": kls,
        "kl_final_median": float(np.median(kls)),
        "n_converged": int(sum(r["converged"] for r in res)),
        "wall_s": [round(r["wall_s"], 1) for r in res],
        "runs": [{k: v for k, v in r.items() if k != "kl_track"}
                 for r in res],
    }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       f"results_d{d}.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1, default=float)
    print(f"\nd={d}: evals-to-stop median {np.median(n_tot):.0f} "
          f"(heuristic {n_approx_conv(d)}), KL median {np.median(kls):.4f} "
          f"-> {out}")
