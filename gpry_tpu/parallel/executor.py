"""
Host-side parallel truth evaluation.

The reference parallelizes user-likelihood evaluations by splitting batches
across MPI ranks (gpry/run.py:1200-1236, gpry/mpi.py:80-102).  In the
single-controller design the only genuinely host-bound work is this
user-Python callable, so it runs in a local executor by default: serial
(zero overhead for fast likelihoods), thread pool for I/O-bound or
GIL-releasing likelihoods, process pool (cloudpickled) for CPU-bound ones.
Pool workers are spawned, never forked, and start with JAX held to the CPU,
so that no worker inherits or opens the accelerator the controller holds.

For MULTI-HOST truth evaluation over DCN there is additionally
``mode="mpi"``: under ``mpirun -n k`` rank 0 keeps driving the device loop
(single-controller) while each ``logp_batch`` is contiguously split over
all k ranks (the exact decomposition of the reference's
``_eval_truth_parallel``, gpry/run.py:1200-1236 + gpry/mpi.py:80-102);
non-root ranks run ``serve()`` — a command loop evaluating their slice of
every broadcast batch — until the controller sends a stop.
"""

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# Worker-side cache of deserialized likelihood callables, keyed by payload
# hash: the closure is shipped once as cloudpickle bytes (stock pickle
# cannot carry lambdas/closures — the common case for user likelihoods) and
# materialized once per worker process.
_WORKER_FNS = {}


def _worker_init():
    """Hold a pool worker's JAX, if any, to the CPU."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_platforms", "cpu")


def _call_pickled(payload, x):
    import cloudpickle
    key = hash(payload)
    fn = _WORKER_FNS.get(key)
    if fn is None:
        fn = cloudpickle.loads(payload)
        _WORKER_FNS[key] = fn
    return fn(x)


class TruthExecutor:
    """
    Evaluate ``truth.logp`` over batches of points.

    Parameters
    ----------
    mode : "serial" (default), "threads", "processes", or "mpi"
    max_workers : int, optional (default: CPU count)
    """

    def __init__(self, truth, mode="serial", max_workers=None):
        self.truth = truth
        self.mode = mode
        self.max_workers = max_workers or min(32, (os.cpu_count() or 1))
        self._pool = None
        self._payload = None
        if mode == "threads":
            self._pool = ThreadPoolExecutor(max_workers=self.max_workers)
        elif mode == "processes":
            # cloudpickle the callable so closures/lambdas cross the
            # process boundary (the reference uses dill for the same
            # reason, gpry/mpi.py:7-11)
            import cloudpickle
            self._payload = cloudpickle.dumps(truth.logp)
            self._pool = ProcessPoolExecutor(
                max_workers=self.max_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init)
        elif mode not in ("serial", "mpi"):
            raise ValueError(f"Unknown executor mode '{mode}'.")

    # -- MPI (multi-host, DCN) mode ------------------------------------------

    @staticmethod
    def _mpi():
        from gpry_tpu import mpi
        return mpi

    def _eval_slice(self, X, rank, size):
        """This rank's contiguous slice of the batch, evaluated
        (reference decomposition: gpry/mpi.py:80-102)."""
        from gpry_tpu.mpi import split_number_for_parallel_processes
        sizes = split_number_for_parallel_processes(len(X), size)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        return [self.truth.logp(x) for x in X[offs[rank]:offs[rank + 1]]]

    def serve(self):
        """Worker command loop for non-root ranks under ``mode="mpi"``:
        evaluate this rank's slice of every broadcast batch until the
        controller broadcasts a stop (the DCN analogue of the reference's
        lockstep `_eval_truth_parallel`, gpry/run.py:1200-1236)."""
        mpi = self._mpi()
        comm = mpi.mpi_comm
        while True:
            cmd = comm.bcast(None, root=0)
            if cmd is None or cmd[0] == "stop":
                break
            X = np.atleast_2d(cmd[1])
            # An exception must still reach the gather or rank 0 blocks
            # forever in its collective (and conversely, this worker must
            # keep serving so later collectives stay aligned): ship an
            # error marker instead of raising.
            try:
                res = self._eval_slice(X, mpi.RANK, mpi.SIZE)
            except Exception as excpt:  # noqa: BLE001 — user loglike
                res = ("__truth_error__",
                       f"rank {mpi.RANK}: {excpt!r}")
            comm.gather(res, root=0)

    def stop_workers(self):
        """Release serving worker ranks (controller only)."""
        mpi = self._mpi()
        if self.mode == "mpi" and mpi.multiple_processes \
                and mpi.is_main_process and mpi.mpi_comm is not None:
            mpi.mpi_comm.bcast(("stop",), root=0)

    def logp_batch(self, X):
        """Evaluate the truth at each row of X, returning an array."""
        X = np.atleast_2d(X)
        if self.mode == "mpi":
            mpi = self._mpi()
            if mpi.multiple_processes and mpi.mpi_comm is not None:
                comm = mpi.mpi_comm
                comm.bcast(("eval", X), root=0)
                # Complete the gather even if this rank's slice raises,
                # or the workers (already past the bcast) deadlock in
                # THEIR gather; errors travel as markers and re-raise
                # here once the collective is done.
                try:
                    mine = self._eval_slice(X, mpi.RANK, mpi.SIZE)
                except Exception as excpt:  # noqa: BLE001 — user loglike
                    mine = ("__truth_error__", f"rank 0: {excpt!r}")
                gathered = comm.gather(mine, root=0)
                errors = [g[1] for g in gathered
                          if isinstance(g, tuple) and len(g) == 2
                          and g[0] == "__truth_error__"]
                if errors:
                    raise RuntimeError(
                        "truth evaluation failed on: "
                        + "; ".join(errors))
                return np.concatenate(
                    [np.asarray(g, dtype=float) for g in gathered])
            # single-process launch: plain serial
            return np.array([self.truth.logp(x) for x in X])
        if self._pool is None:
            return np.array([self.truth.logp(x) for x in X])
        if self._payload is not None:
            futures = [self._pool.submit(_call_pickled, self._payload, x)
                       for x in X]
        else:
            futures = [self._pool.submit(self.truth.logp, x) for x in X]
        return np.array([f.result() for f in futures])

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.shutdown()
        except Exception:
            pass
