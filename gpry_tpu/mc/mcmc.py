"""
On-device ensemble MCMC over the surrogate.

Device replacement for the reference's Cobaya-MCMC route
(gpry/mc.py:173-325, gpry/convergence.py:430-472): instead of one chain per
MPI rank, a whole ensemble of adaptive random-walk Metropolis chains runs as
one vmapped ``lax.scan`` on device.  Used by the GaussianKL convergence
criterion and as the "mcmc" option of the final MC step.

Adaptation: each chain scales an empirically-estimated proposal covariance
(from a warmup phase) by the standard 2.38^2/d factor, with a global
acceptance-targeting step-size multiplier.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def split_rhat(chains):
    """
    Max (over dimensions) split-R-hat of an MCMC ensemble (Gelman-Rubin
    with each chain split in half) — the on-device analogue of the
    reference's reliance on Cobaya's cross-chain R-1
    (gpry/convergence.py:430-472).  ``chains``: (n_chains, n_steps, d).
    """
    chains = np.asarray(chains)
    m, n, d = chains.shape
    half = n // 2
    if half < 2 or m < 1:
        return np.inf
    segs = chains[:, :2 * half].reshape(m * 2, half, d)
    means = segs.mean(axis=1)                     # (2m, d)
    within = segs.var(axis=1, ddof=1).mean(axis=0)
    between = half * means.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * within + between / half
    return float(np.sqrt(var_plus / np.maximum(within, 1e-300)).max())


@partial(jax.jit, static_argnames=("logp_fn", "n_chains", "n_steps",
                                   "n_warmup"))
def run_mcmc_device(logp_fn, params, key, lo, hi, n_chains=8, n_steps=2000,
                    n_warmup=None, covmat=None):
    """
    Run ``n_chains`` adaptive MH chains for ``n_steps`` each (after a warmup
    of ``n_warmup``, default n_steps // 2).  ``logp_fn(params, X)`` must be a
    stable-identity jittable log-density.  Returns (X (chains, steps, d),
    logp (chains, steps)) post-warmup samples.
    """
    d = lo.shape[0]
    dtype = lo.dtype
    if n_warmup is None:
        n_warmup = n_steps // 2

    k_init, k_run = jax.random.split(key)
    # start chains from uniform draws, keep best of a few tries each
    n_tries = 16
    X0 = jax.random.uniform(k_init, (n_chains * n_tries, d), dtype) \
        * (hi - lo) + lo
    lp0 = logp_fn(params, X0).reshape(n_chains, n_tries)
    best = jnp.argmax(lp0, axis=1)
    x0 = X0.reshape(n_chains, n_tries, d)[jnp.arange(n_chains), best]
    lp_x0 = lp0[jnp.arange(n_chains), best]

    if covmat is None:
        scale0 = (hi - lo) / 10.0
        cov0 = jnp.diag(scale0 * scale0)
    else:
        cov0 = jnp.asarray(covmat, dtype)
    chol0 = jnp.linalg.cholesky(cov0 * (2.38**2 / d))

    def in_box(x):
        return jnp.all((x >= lo) & (x <= hi), axis=-1)

    def phase(carry, keys, chol, adapt):
        """Scan one phase (warmup: adapt=True collects moments)."""

        def step(state, kk):
            x, lp_x, log_step, acc, s1, s2, t = state
            k1, k2 = jax.random.split(kk)
            prop = x + jnp.exp(log_step) * (
                jax.random.normal(k1, x.shape, dtype) @ chol.T)
            lp_prop = jnp.where(in_box(prop),
                                logp_fn(params, prop), -jnp.inf)
            lu = jnp.log(jax.random.uniform(k2, (x.shape[0],), dtype))
            accept = lu < (lp_prop - lp_x)
            x = jnp.where(accept[:, None], prop, x)
            lp_x = jnp.where(accept, lp_prop, lp_x)
            # Robbins-Monro step-size adaptation towards 23.4% acceptance
            if adapt:
                log_step = log_step + 0.05 * (
                    accept.astype(dtype).mean() - 0.234)
                s1 = s1 + x.reshape(-1, d).sum(axis=0)
                s2 = s2 + x.reshape(-1, d).T @ x.reshape(-1, d)
                t = t + x.shape[0]
            return (x, lp_x, log_step, acc + accept.astype(dtype).mean(),
                    s1, s2, t), (x, lp_x)

        return jax.lax.scan(step, carry, keys)

    keys_w = jax.random.split(k_run, n_warmup + n_steps)
    state = (x0, lp_x0, jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype),
             jnp.zeros(d, dtype), jnp.zeros((d, d), dtype),
             jnp.asarray(0, jnp.int32))
    state, _ = phase(state, keys_w[:n_warmup], chol0, adapt=True)

    # Re-estimate the proposal covariance from warmup samples.
    x, lp_x, log_step, _, s1, s2, t = state
    tt = jnp.maximum(t, 2).astype(dtype)
    mean_w = s1 / tt
    cov_w = s2 / tt - jnp.outer(mean_w, mean_w)
    cov_w = cov_w + 1e-10 * jnp.eye(d, dtype=dtype)
    chol_w = jnp.linalg.cholesky(cov_w * (2.38**2 / d))
    chol_w = jnp.where(jnp.any(jnp.isnan(chol_w)), chol0, chol_w)

    state = (x, lp_x, log_step, jnp.asarray(0.0, dtype),
             jnp.zeros(d, dtype), jnp.zeros((d, d), dtype),
             jnp.asarray(0, jnp.int32))
    _, (Xs, lps) = phase(state, keys_w[n_warmup:], chol_w, adapt=False)
    # (steps, chains, d) -> (chains, steps, d)
    return jnp.swapaxes(Xs, 0, 1), jnp.swapaxes(lps, 0, 1)
