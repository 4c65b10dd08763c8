"""
Production-deployment example: crash-resilient driving + multi-host truth
evaluation + multi-chip sharding.

* ``run_resilient`` survives accelerator-runtime failures by rebuilding
  all device state from the per-iteration checkpoint.
* ``truth_executor="mpi"``: under ``mpirun -n k python this_script.py``,
  rank 0 drives the single-controller device loop while every truth batch
  is split over all k host ranks (for expensive likelihoods, e.g. a
  Boltzmann code).  Single-process launches fall back to serial
  transparently.
* Multi-chip sharding needs no configuration: with >1 device visible,
  LML-fit restarts, NS chain batches and prediction sweeps DP-shard over
  the mesh, and small-query/large-N predictions use the training-axis TP
  path (parallel/mesh.py).
"""

import numpy as np

from gpry_tpu.run import run_resilient

# an (artificially cheap) stand-in for an expensive likelihood
mean = np.array([0.3, -0.2, 0.1, 0.0])
widths = np.array([0.35, 0.2, 0.5, 0.3])


def loglike(x):
    return float(-0.5 * np.sum(((np.asarray(x) - mean) / widths) ** 2))


if __name__ == "__main__":
    bounds = np.array([[-2.0, 2.0]] * 4)
    runner = run_resilient(
        loglike,
        bounds=bounds,
        checkpoint="output/resilient_example",
        max_retries=3,          # rebuild-from-checkpoint retries
        retry_wait_s=60,        # let the accelerator runtime recover
        truth_executor="mpi",   # multi-host truth evals under mpirun
        gp_acquisition={"NORA": {}},
        seed=0,
    )
    from gpry_tpu import mpi
    if mpi.is_main_process:
        # only rank 0 runs the MC; worker ranks have served truth evals
        # and re-synced their GPR/has_converged from the checkpoint
        X, w, logp = runner.last_mc_samples()
        m = np.average(X, axis=0, weights=w)
        print("converged:", runner.has_converged,
              "evals:", runner.gpr.n_total)
        print("posterior mean:", np.round(m, 3), "(truth:", mean, ")")
    else:
        print(f"rank {mpi.RANK}: served truth evaluations; "
              f"converged={runner.has_converged}, "
              f"n_total={runner.gpr.n_total}")
