"""
MPI compatibility shim.

The reference's entire communication layer (gpry/mpi.py, 218 LoC) exists to
split embarrassingly-parallel batch axes across MPI ranks.  This
design replaces every use with batched/sharded device computation
(see parallel/mesh.py), so this module provides the same *names* as
single-process no-ops — user code and scripts written against the
reference's module keep working.

Under an actual mpi4py world (the user launched mpirun) the design stays
single-controller: ``Runner.run()`` executes the loop on rank 0 only, the
other ranks block at a barrier and re-sync from the checkpoint when the
loop finishes (see run.Runner.run).  Ranks do NOT each duplicate the loop.
Per-rank RNGs (get_random_generator) exist for user code that wants rank-
parallel truth evaluation around the Runner.
"""

import numpy as np

try:  # pragma: no cover - exercised only under mpirun
    from mpi4py import MPI
    mpi_comm = MPI.COMM_WORLD
    RANK = mpi_comm.Get_rank()
    SIZE = mpi_comm.Get_size()
except ImportError:
    MPI = None
    mpi_comm = None
    RANK = 0
    SIZE = 1

is_main_process = (RANK == 0)
multiple_processes = SIZE > 1


def get_random_generator(seed=None):
    """Per-rank generator via SeedSequence spawning
    (reference: gpry/mpi.py:31-50)."""
    if isinstance(seed, np.random.Generator):
        return seed
    if multiple_processes:
        ss = np.random.SeedSequence(seed)
        children = ss.spawn(SIZE)
        return np.random.default_rng(children[RANK])
    return np.random.default_rng(seed)


def bcast(value, root=0):
    if mpi_comm is None:
        return value
    return mpi_comm.bcast(value, root=root)


def gather(value, root=0):
    if mpi_comm is None:
        return [value]
    return mpi_comm.gather(value, root=root)


def allgather(value):
    if mpi_comm is None:
        return [value]
    return mpi_comm.allgather(value)


def scatter(values, root=0):
    if mpi_comm is None:
        return values[0] if values else None
    return mpi_comm.scatter(values, root=root)


def sync_processes():
    if mpi_comm is not None:
        mpi_comm.barrier()


def share_attr(obj, attr, root=0):
    """Broadcast an attribute from root to all ranks
    (reference: gpry/mpi.py:173-179)."""
    setattr(obj, attr, bcast(getattr(obj, attr, None), root=root))


def split_number_for_parallel_processes(n, n_proc=None):
    """Contiguous split sizes of n items over ranks
    (reference: gpry/mpi.py:80-102)."""
    n_proc = n_proc or SIZE
    base = n // n_proc
    rest = n % n_proc
    return np.array([base + (1 if i < rest else 0) for i in range(n_proc)])


def step_split(n, rank=None, n_proc=None):
    """Strided index split, so every rank sees a similar value range
    (reference: gpry/mpi.py:105-116)."""
    rank = RANK if rank is None else rank
    n_proc = n_proc or SIZE
    return np.arange(rank, n, n_proc)


def merge_step_split(*arrays, n_proc=None):
    """Inverse of step_split over gathered per-rank arrays
    (reference: gpry/mpi.py:118-131)."""
    n_proc = n_proc or len(arrays)
    total = sum(len(a) for a in arrays)
    first = np.asarray(arrays[0])
    out = np.empty((total,) + first.shape[1:], dtype=first.dtype)
    for r, a in enumerate(arrays):
        out[r::n_proc] = a
    return out


def multi_gather_array(arrays, root=0):
    """Gather and concatenate per-rank arrays (reference:
    gpry/mpi.py:134-161)."""
    gathered = gather(arrays, root=root)
    if gathered is None:
        return None
    return [np.concatenate([g[i] for g in gathered])
            for i in range(len(arrays))]


def compute_y_parallel(gpr, X, with_std=False):
    """Strided-parallel GP prediction (reference: gpry/mpi.py:182-218).
    Prediction is already one batched device call here, so this just
    forwards."""
    return gpr.predict(X, return_std=with_std)
