"""
Multi-chip sharding over a jax device Mesh.

The reference's parallelism is MPI task-parallelism over batch axes
(restarts, Kriging-believer candidates, NS-sample rows — SURVEY.md section
2.2 / gpry/mpi.py).  The equivalents here, over the device interconnect instead of MPI:

* **DP (data parallel)** over the candidate/sample axis: acquisition and
  prediction sweeps are sharded row-wise with ``shard_map``; no collectives
  needed (embarrassingly parallel), results gathered by the out_spec.
* **DP over optimizer restarts**: the vmapped multi-start LML fit / acq
  ascent shards its restart axis; the best-of reduction is a tiny
  ``argmin`` after an implicit all-gather.
* **TP (tensor/model parallel)** over the *training-point* axis for the
  predictive mean: K(Xq, X) columns and alpha are sharded, each device
  computes a partial matvec, combined with ``psum`` — the analogue of
  sharding the kernel matrix when N grows.

Single-chip execution is the degenerate mesh; the same code paths run.
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpry_tpu.models.gp import surrogate_predict
from gpry_tpu.ops.kernels import cross_kernel
from gpry_tpu.ops.lbfgs import minimize_lbfgs_bounded
from gpry_tpu.ops.linalg import masked_lml


def make_mesh(devices=None, axis_name="data"):
    """1-D mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


# ---------------------------------------------------------------------------
# Automatic mesh selection for the production loop
# ---------------------------------------------------------------------------
# The GP fit, NORA sweeps and ranked-pool conditioning dispatch through these
# helpers: with >= 2 devices on the platform holding the arrays they shard
# over the full 1-D mesh, otherwise they run the plain single-device path.
# Sharding is row-/restart-parallel with no cross-shard reductions, so the
# sharded and unsharded paths produce identical results.

_MESH_CACHE = {}
_MESH_ENABLED = True

#: host-side counters of sharded-path dispatches (observability: lets the
#: multichip dry run assert the production loop really used the mesh)
SHARD_STATS = {"predict": 0, "fit": 0, "tp": 0}

#: TP routing threshold: the TP (training-axis) predict path engages when
#: the padded training buffer is at least this large AND the query batch is
#: too small for row-DP to occupy the mesh.  Not measured on NVLink.  At this workload's N the
#: crossover favors DP whenever enough query rows exist (DP has zero
#: comms); TP covers the starved-DP regime (few queries, large N), where
#: single-device execution was the previous fallback.
TP_NMAX_MIN = 512


@contextlib.contextmanager
def mesh_disabled():
    """Force the single-device code paths (for tests / A-B comparisons)."""
    global _MESH_ENABLED
    prev = _MESH_ENABLED
    _MESH_ENABLED = False
    try:
        yield
    finally:
        _MESH_ENABLED = prev


def available_mesh(x=None, platform=None, axis_name="data"):
    """
    Cached 1-D mesh over all devices of the platform holding ``x``
    (or ``platform``), or None when fewer than 2 devices are available.
    Never touches any backend other than the one the arrays live on.
    """
    if not _MESH_ENABLED:
        return None
    if platform is None:
        if isinstance(x, jax.Array):
            platform = next(iter(x.devices())).platform
        else:
            platform = jax.default_backend()
    try:
        devices = jax.devices(platform)
    except RuntimeError:
        return None
    if len(devices) < 2:
        return None
    key = (platform, len(devices), axis_name)
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = Mesh(np.asarray(devices), (axis_name,))
    return _MESH_CACHE[key]


def pad_to_multiple(X, m, axis=0):
    """Pad axis length up to a multiple of m; returns (padded, n_valid)."""
    n = X.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return X, n
    widths = [(0, 0)] * X.ndim
    widths[axis] = (0, pad)
    return jnp.pad(X, widths), n


def sharded_predict(family, p, Xq, mesh, axis_name="data"):
    """
    DP prediction: rows of Xq sharded over the mesh.  Xq's leading dim must
    be a multiple of the mesh size (use pad_to_multiple).
    """

    def local(Xq_shard):
        return surrogate_predict(family, p, Xq_shard)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(axis_name, None),),
                   out_specs=(P(axis_name), P(axis_name)),
                   check_vma=False)
    return fn(Xq)


def device_put_sharded_rows(X, mesh, axis_name="data"):
    """Place an array with its leading axis sharded over the mesh."""
    return jax.device_put(X, NamedSharding(mesh, P(axis_name)))


# ---------------------------------------------------------------------------
# TP (training-axis) gated prediction
# ---------------------------------------------------------------------------
# Mean: partial K(q, X_shard) @ alpha_shard, psum over shards (as in
# the deleted legacy tp_predict_mean).  Std: with W = L^-1 sharded by rows,
# sigma^2(q) = prior_var(q) - ||W k_q||^2, where each device computes its
# rows of v = W_shard @ k_q_full and their squared sum; one tiled
# all_gather of k_q + one psum.  The sum of squares is as accurate as the
# single-device triangular solve, where an explicit K^-1 quadratic form
# loses ~cond(K) digits on ill-conditioned kernels.  W is computed once per
# factorization from the padded L (identity padding makes its padded block
# the identity; masked k_q rows keep it inert) and cached against the L
# buffer identity.

_KINV_CACHE = []  # [(weakref-to-L, M)], newest last, bounded
_KINV_CACHE_MAX = 2


def _kinv_for(p):
    """L^-1 for the factorization ``p.L``, cached by L-buffer identity.

    Entries hold only a WEAK reference to L, so an O(nmax^2) M buffer dies
    with its factorization instead of pinning device memory after the GPR is torn
    down.  Callers get stable L identity across calls because the GPR
    memoizes its cast sweep pytree per factorization
    (models/gp.py:sweep_params)."""
    import weakref

    from jax.scipy.linalg import solve_triangular
    M_found = None
    alive = []
    for ref, M in _KINV_CACHE:
        L = ref()
        if L is None:
            continue
        alive.append((ref, M))
        if L is p.L:
            M_found = M
    _KINV_CACHE[:] = alive
    if M_found is not None:
        return M_found
    nmax = p.L.shape[0]
    M = solve_triangular(p.L, jnp.eye(nmax, dtype=p.L.dtype), lower=True)
    _KINV_CACHE.append((weakref.ref(p.L), M))
    del _KINV_CACHE[:-_KINV_CACHE_MAX]
    return M


@partial(jax.jit, static_argnames=("family", "mesh", "axis_name"))
def _tp_predict_raw(family, p, M, Xq_, mesh, axis_name="data"):
    from gpry_tpu.ops.kernels import kernel_diag
    nmax = p.X.shape[0]
    n_dev = mesh.shape[axis_name]
    row_starts = (jnp.arange(n_dev) * (nmax // n_dev))[:, None]

    def local(X_shard, alpha_shard, M_shard, row0):
        idx = row0[0] + jnp.arange(X_shard.shape[0])
        m = (idx < p.n).astype(X_shard.dtype)
        Kq_shard = cross_kernel(family, p.theta, X_shard, Xq_) \
            * m[:, None]                                     # (nloc, nq)
        mean_part = Kq_shard.T @ alpha_shard                 # (nq,)
        k_full = jax.lax.all_gather(Kq_shard, axis_name,
                                    axis=0, tiled=True)      # (nmax, nq)
        v_shard = M_shard @ k_full                           # (nloc, nq)
        quad_part = jnp.sum(v_shard * v_shard, axis=0)       # (nq,)
        return (jax.lax.psum(mean_part, axis_name),
                jax.lax.psum(quad_part, axis_name))

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(axis_name, None),
                  P(axis_name, None)),
        out_specs=(P(None), P(None)), check_vma=False)
    mean_, quad = fn(p.X, p.alpha, M, row_starts)
    prior_var = kernel_diag(family, p.theta, Xq_)
    return mean_, jnp.maximum(prior_var - quad, 0.0)


def tp_predict(family, p, Xq_raw, mesh, axis_name="data"):
    """
    Gated (mean, std) prediction with the TRAINING axis TP-sharded over the
    mesh — same semantics as ``surrogate_predict`` (clip + SVM + trust
    gates applied in a replicated elementwise pass).
    """
    from gpry_tpu.models.classifier import svm_decision
    Xq_ = (Xq_raw - p.x_loc) / p.x_scale
    M = _kinv_for(p)
    mean_, var_ = _tp_predict_raw(family, p, M, Xq_, mesh,
                                  axis_name=axis_name)
    mean = jnp.minimum(mean_ * p.y_scale + p.y_loc, p.clip_max)
    std = jnp.sqrt(var_) * p.y_scale
    finite = svm_decision(p.svm, Xq_)
    in_trust = jnp.all((Xq_raw >= p.trust_lo) & (Xq_raw <= p.trust_hi),
                       axis=-1)
    ok = finite & in_trust
    mean = jnp.where(ok, mean, jnp.asarray(-jnp.inf, mean.dtype))
    std = jnp.where(ok, std, 0.0)
    return mean, std


# ---------------------------------------------------------------------------
# Production entry points (used by models.gp / acquisition when a mesh is up)
# ---------------------------------------------------------------------------


def predict_maybe_sharded(family, p, Xq, min_rows=256, axis_name="data",
                          row_bucket=256):
    """
    Gated surrogate prediction with (a) the row count padded up to a
    multiple of ``row_bucket`` — bulk sweeps (NS samples, ranked-pool
    conditioning) have run-dependent lengths, and without bucketing every
    distinct length would trigger a fresh jit compile — and (b) the row axis DP-sharded over the available
    mesh.  Falls back to the plain single-device call for small batches.
    Row-parallel with no reductions, padding sliced off: results are
    identical to ``surrogate_predict``.
    """
    mesh = available_mesh(Xq)
    nq = Xq.shape[0]
    if nq < min_rows:
        # starved-DP regime: too few query rows to shard.  With a mesh and
        # a large training buffer, split the O(nmax^2 nq) work over the
        # TRAINING axis instead (TP); otherwise single-device.
        if (mesh is not None and p.X.shape[0] >= TP_NMAX_MIN
                and p.X.shape[0] % mesh.shape[axis_name] == 0):
            SHARD_STATS["tp"] += 1
            return tp_predict(family, p, Xq, mesh, axis_name=axis_name)
        return surrogate_predict(family, p, Xq)
    pad = (-nq) % row_bucket
    Xp = Xq
    if pad:
        # dummy rows replicate row 0 (known in-bounds, finite)
        Xp = jnp.concatenate(
            [Xq, jnp.broadcast_to(Xq[:1], (pad, Xq.shape[1]))])
    if mesh is None:
        mean, std = surrogate_predict(family, p, Xp)
    else:
        SHARD_STATS["predict"] += 1
        Xp, _ = pad_to_multiple(Xp, mesh.shape[axis_name])
        mean, std = sharded_predict(family, p, Xp, mesh,
                                    axis_name=axis_name)
    return mean[:nq], std[:nq]


@partial(jax.jit,
         static_argnames=("family", "mesh", "maxiter", "axis_name"))
def _sharded_fit_theta(family, X, y, n, noise_var, theta0s, lo, hi, mesh,
                       maxiter=200, axis_name="data"):
    """Restart-sharded multi-start LML fit body (same math as
    models.gp._fit_theta_restarts, restarts DP over the mesh — the
    analogue of the reference's MPI restart split, gpry/run.py:1253-1293)."""
    # dtype-matched tolerance — keep in sync with models/gp.py
    tol = 1e-8 if theta0s.dtype == jnp.float64 else 1e-3

    def local(t0s_shard):
        def nll(theta):
            return -masked_lml(family, theta, X, y, n, noise_var)

        solve = lambda t0: minimize_lbfgs_bounded(
            nll, t0, lo, hi, maxiter=maxiter, tol=tol, count_evals=True)
        return jax.vmap(solve)(t0s_shard)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(axis_name, None),),
                       out_specs=(P(axis_name, None), P(axis_name),
                                  P(axis_name)),
                       check_vma=False)
    return fn(theta0s)


def fit_theta_restarts_maybe_sharded(family, X, y, n, noise_var, theta0s,
                                     lo, hi, maxiter=200):
    """
    Multi-restart LML fit, restart axis DP-sharded when a mesh is available
    and divides the restart count; identical results either way (each
    restart is an independent lock-step L-BFGS lane).
    Returns (thetas, nlls, n_evals) with exact per-lane objective-eval
    counts (for Progress telemetry).
    """
    from gpry_tpu.models.gp import _fit_theta_restarts
    mesh = available_mesh(X)
    n_restarts = theta0s.shape[0]
    if mesh is not None and n_restarts % mesh.shape["data"] == 0:
        SHARD_STATS["fit"] += 1
        return _sharded_fit_theta(family, X, y, n, noise_var, theta0s, lo,
                                  hi, mesh, maxiter=maxiter)
    return _fit_theta_restarts(family, X, y, n, noise_var, theta0s, lo, hi,
                               maxiter=maxiter)
