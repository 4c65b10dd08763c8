"""
Masked / padded linear algebra for the fixed-shape GP core.

The training set grows every active-learning iteration; to keep every GP
operation compiled once per padded-buffer size, all arrays are padded to a
bucket size ``Nmax`` with a validity count ``n``:

* ``X``      (Nmax, d): rows >= n are arbitrary (zeros)
* ``y``      (Nmax,)  : entries >= n are zero
* ``K``      (Nmax, Nmax): the padded kernel matrix is the block matrix
  ``[[K_valid, 0], [0, I]]``, so its Cholesky factor is ``[[L, 0], [0, I]]``
  and all downstream solves/logdets are exact for the valid block while the
  padding contributes nothing.

This replaces the reference's from-scratch refactorization on every data
append (gpry/gpr.py:996-1020, 1453-1465) with an O(Nmax^2 k) *block append
update* (``chol_append``), which is also what makes Kriging-believer
conditioning (gpry/gp_acquisition.py:1522-1555) cheap on the device.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from gpry_tpu.ops.kernels import cross_kernel, kernel_diag


def _row_mask(n, nmax, dtype):
    return (jnp.arange(nmax) < n).astype(dtype)


def masked_kernel_matrix(family, theta, X, n, noise_var):
    """
    Padded training covariance: ``K[valid, valid] + noise_var * I`` on the
    valid block, identity on the padding.
    """
    nmax = X.shape[0]
    m = _row_mask(n, nmax, X.dtype)
    K = cross_kernel(family, theta, X, X)
    # same-point covariance can exceed the cross form's diagonal
    # (WhiteKernel members, sklearn semantics); restore it before masking
    K = K + jnp.diag(kernel_diag(family, theta, X) - jnp.diagonal(K))
    K = K * (m[:, None] * m[None, :])
    # noise_var may be a scalar or a per-point (nmax,) vector
    diag = jnp.broadcast_to(jnp.asarray(noise_var, X.dtype), (nmax,))
    diag_fill = jnp.where(m > 0, diag, 1.0)
    K = K + jnp.diag(diag_fill)
    return K


@jax.jit
def masked_cholesky(K):
    """Cholesky of a padded kernel matrix (identity padding preserved)."""
    return jnp.linalg.cholesky(K)


def solve_lower(L, B):
    """Triangular solve L z = B (lower)."""
    return solve_triangular(L, B, lower=True)


@partial(jax.jit, static_argnames=("family",))
def factorize(family, theta, X, y, n, noise_var):
    """
    Full (re-)factorization: returns ``(L, alpha)`` with
    ``alpha = (K + noise I)^-1 y`` zero-padded.
    """
    K = masked_kernel_matrix(family, theta, X, n, noise_var)
    L = jnp.linalg.cholesky(K)
    z = solve_triangular(L, y, lower=True)
    alpha = solve_triangular(L.T, z, lower=False)
    return L, alpha


@partial(jax.jit, static_argnames=("family",))
def chol_append(family, theta, X, y, n, noise_var, L, X_new, y_new):
    """
    Incremental block Cholesky append: given the factor ``L`` for the current
    ``n`` valid rows of ``X``, insert ``k = X_new.shape[0]`` new points at
    rows ``n..n+k`` and return ``(X', y', n', L', alpha')``.

    Cost O(Nmax^2 k) instead of the reference's O(N^3) refactorization.
    The new rows of L are ``[S12^T, S22]`` with
    ``S12 = L^-1 K(X_old, X_new)`` and ``S22 = chol(K22 - S12^T S12)``.
    """
    nmax, d = X.shape
    k = X_new.shape[0]
    dtype = X.dtype
    m = _row_mask(n, nmax, dtype)

    # Insert the new rows into the padded buffers.
    row_ids = n + jnp.arange(k)
    X2 = X.at[row_ids].set(X_new.astype(dtype))
    y2 = y.at[row_ids].set(y_new.astype(dtype))

    # Cross-covariance of old valid rows vs new points, zero on padding.
    K12 = cross_kernel(family, theta, X, X_new) * m[:, None]        # (Nmax, k)
    S12 = solve_triangular(L, K12, lower=True)                       # (Nmax, k)
    # per-point noise: rows n..n+k of the padded noise vector (scalar case
    # broadcasts trivially)
    if jnp.ndim(noise_var) == 0:
        noise_new = jnp.broadcast_to(jnp.asarray(noise_var, dtype), (k,))
    else:
        noise_new = jax.lax.dynamic_slice(
            jnp.asarray(noise_var, dtype), (n,), (k,))
    K22 = cross_kernel(family, theta, X_new, X_new)
    K22 = K22 + jnp.diag(kernel_diag(family, theta, X_new)
                         - jnp.diagonal(K22) + noise_new)
    S22 = jnp.linalg.cholesky(K22 - S12.T @ S12)                     # (k, k)

    # Write the new block rows of L: [S12^T, S22, 0].  S12^T columns >= n are
    # zero already (K12 masked rows and identity padding of L solve to zero).
    col_ids = jnp.arange(nmax)
    in_block = (col_ids[None, :] >= n) & (col_ids[None, :] < n + k)
    rel = jnp.clip(col_ids[None, :] - n, 0, k - 1)
    s22_spread = jnp.take_along_axis(
        S22, jnp.broadcast_to(rel, (k, nmax)), axis=1)
    Lrows = jnp.where(in_block, s22_spread, S12.T)                   # (k, Nmax)
    L2 = jax.lax.fori_loop(
        0, k,
        lambda i, acc: acc.at[n + i].set(Lrows[i]),
        L,
    )

    # Refresh alpha with one padded solve (O(Nmax^2)).
    z = solve_triangular(L2, y2, lower=True)
    alpha2 = solve_triangular(L2.T, z, lower=False)
    return X2, y2, n + k, L2, alpha2


@partial(jax.jit, static_argnames=("family",))
def masked_lml(family, theta, X, y, n, noise_var):
    """
    Log marginal likelihood of the valid block, identical to sklearn's
    ``log_marginal_likelihood`` for the same theta
    (``-1/2 y^T alpha - sum log diag L - n/2 log 2pi``).

    Differentiable in theta (use ``jax.value_and_grad``).
    """
    nmax = X.shape[0]
    m = _row_mask(n, nmax, X.dtype)
    K = masked_kernel_matrix(family, theta, X, n, noise_var)
    L = jnp.linalg.cholesky(K)
    z = solve_triangular(L, y, lower=True)
    quad = jnp.sum(z * z)
    logdet = jnp.sum(m * jnp.log(jnp.diagonal(L)))
    return -0.5 * quad - logdet - 0.5 * n * jnp.log(2.0 * jnp.pi)


@partial(jax.jit, static_argnames=("family",))
def predict_mean(family, theta, X, n, alpha, Xq):
    """
    GP posterior mean only: ``K(Xq, X) @ alpha`` — no triangular solve.
    The hot path for nested-sampling/MCMC log-density sweeps (which never
    use sigma), ~an order of magnitude cheaper per call than
    ``predict_meanvar``.
    """
    nmax = X.shape[0]
    m = _row_mask(n, nmax, X.dtype)
    Kq = cross_kernel(family, theta, Xq, X) * m[None, :]
    return Kq @ alpha


@partial(jax.jit, static_argnames=("family",))
def predict_meancov(family, theta, X, n, noise_var, L, alpha, Xq):
    """
    GP posterior mean and full covariance at ``Xq`` (nq, d), given the
    padded factorization (reference: gpry/gpr.py predict(return_cov=True)).
    """
    nmax = X.shape[0]
    m = _row_mask(n, nmax, X.dtype)
    Kq = cross_kernel(family, theta, Xq, X) * m[None, :]             # (nq, Nmax)
    mean = Kq @ alpha
    V = solve_triangular(L, Kq.T, lower=True)                        # (Nmax, nq)
    Kqq = cross_kernel(family, theta, Xq, Xq)
    # same-point covariance can exceed the cross form's diagonal
    # (WhiteKernel members, sklearn semantics) — restore it so
    # diag(cov) == predict_meanvar's variance for every kernel spec
    Kqq = Kqq + jnp.diag(kernel_diag(family, theta, Xq)
                         - jnp.diagonal(Kqq))
    cov = Kqq - V.T @ V
    return mean, cov


@partial(jax.jit, static_argnames=("family",))
def predict_meanvar(family, theta, X, n, noise_var, L, alpha, Xq):
    """
    GP posterior mean and latent variance at query points ``Xq`` (nq, d),
    given the padded factorization.  Variance excludes the noise term,
    matching sklearn's ``return_std`` semantics used by the reference
    (gpry/gpr.py:1204-1220).
    """
    nmax = X.shape[0]
    m = _row_mask(n, nmax, X.dtype)
    Kq = cross_kernel(family, theta, Xq, X) * m[None, :]             # (nq, Nmax)
    mean = Kq @ alpha
    V = solve_triangular(L, Kq.T, lower=True)                        # (Nmax, nq)
    prior_var = kernel_diag(family, theta, Xq)
    var = prior_var - jnp.sum(V * V, axis=0)
    return mean, jnp.maximum(var, 0.0)
