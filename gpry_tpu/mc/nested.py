"""
On-device vectorized nested sampling.

Device replacement for the reference's external nested samplers
(PolyChord / UltraNest / nessai behind gpry/ns_interfaces.py:36-543): the
GP surrogate is cheap and jittable, so the whole NS run — live-point
evolution, constrained slice sampling, evidence bookkeeping — executes as a
single ``lax.while_loop`` on device with fixed shapes.

Algorithm: batched nested sampling with PolyChord-style constrained slice
sampling (arXiv:1506.00171's search strategy, vectorized):

* ``nlive`` live points; each outer step kills the ``B`` worst and replaces
  them with ``B`` vmapped slice-sampling chains started from random
  survivors, each doing ``num_repeats`` passes along directions drawn from
  the live-point covariance Cholesky (whitened slice sampling).
* Volume bookkeeping uses the deterministic approximation
  ``log X_i = -(i+1)/nlive`` per (likelihood-sorted) dead point; dead-point
  weights ``log w_i = logl_i - i/nlive + log(expm1(1/nlive))``.
* Stops when the live-point evidence upper bound falls below
  ``precision_criterion`` of the total (reference target 0.01,
  gpry/gp_acquisition.py:615).

The log-density callable is the *gated* surrogate mean (-inf outside the
classifier/trust region), plus a hard -inf outside the prior box.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp


class NSResult(NamedTuple):
    X: jnp.ndarray        # (n_dead_buffer + nlive, d): dead points then live
    logl: jnp.ndarray     # (n_dead_buffer + nlive,)
    logw: jnp.ndarray     # (n_dead_buffer + nlive,) unnormalized log-weights
    n_dead: jnp.ndarray   # () int32: valid dead entries
    #: Evidence estimate under the DETERMINISTIC volume approximation
    #: log X_i = -i/nlive (no stochastic t-sampling), which biases logZ by
    #: O(sqrt(n_dead)/nlive) nats (~0.4 observed at default settings).
    #: Ample for acquisition ranking and sample reweighting — the uses in
    #: this framework — but NOT a publication-grade evidence estimate; use
    #: an external NS interface (mc.interfaces) if logZ itself is the goal.
    logZ: jnp.ndarray
    n_calls: jnp.ndarray  # () int32: log-density evaluations


def _slice_chain(logl_fn, params, key, x0, logl0, lstar, chol, num_repeats,
                 lo, hi):
    """
    One constrained slice-sampling chain from (x0, logl0 > lstar):
    ``num_repeats`` slice updates along covariance-whitened directions.
    Returns (x, logl, n_calls).  Fully jittable; vmapped over chains.
    """
    d = x0.shape[0]

    def in_box(x):
        return jnp.all((x >= lo) & (x <= hi))

    def eval_logl(x):
        return jnp.where(in_box(x), logl_fn(params, x[None])[0], -jnp.inf)

    def one_repeat(carry, key_r):
        x, lx, calls = carry
        k1, k2, k3 = jax.random.split(key_r, 3)
        nrm = jax.random.normal(k1, (d,), x.dtype)
        e = chol @ (nrm / jnp.linalg.norm(nrm))

        # Step-out by doubling, capped (directions are covariance-scaled, so
        # the unit interval is already the right order of magnitude).  The
        # endpoint log-densities ride in the carry so the condition does not
        # re-evaluate the GP.
        w0 = jax.random.uniform(k2, dtype=x.dtype) * 0.9 + 0.05
        tlo0, thi0 = -w0, 1.0 - w0

        def expand(state):
            tlo, thi, l_lo, l_hi, it, calls = state
            tlo = jnp.where(l_lo > lstar, tlo * 2.0, tlo)
            thi = jnp.where(l_hi > lstar, thi * 2.0, thi)
            l_lo = eval_logl(x + tlo * e)
            l_hi = eval_logl(x + thi * e)
            return tlo, thi, l_lo, l_hi, it + 1, calls + 2

        def expand_cond(state):
            tlo, thi, l_lo, l_hi, it, _ = state
            return ((l_lo > lstar) | (l_hi > lstar)) & (it < 6)

        tlo, thi, _, _, _, calls = jax.lax.while_loop(
            expand_cond, expand,
            (tlo0, thi0, eval_logl(x + tlo0 * e), eval_logl(x + thi0 * e),
             0, calls + 2))

        # Shrinkage sampling.
        def shrink(state):
            key, tlo, thi, t, lx_new, accepted, it, calls = state
            key, kk = jax.random.split(key)
            t = jax.random.uniform(kk, dtype=x.dtype,
                                   minval=tlo, maxval=thi)
            l_new = eval_logl(x + t * e)
            accepted = l_new > lstar
            tlo = jnp.where(~accepted & (t < 0), t, tlo)
            thi = jnp.where(~accepted & (t >= 0), t, thi)
            return key, tlo, thi, t, l_new, accepted, it + 1, calls + 1

        def shrink_cond(state):
            _, _, _, _, _, accepted, it, _ = state
            return (~accepted) & (it < 30)

        key_s, tlo, thi, t, l_new, accepted, _, calls = jax.lax.while_loop(
            shrink_cond, shrink,
            (k3, tlo, thi, jnp.zeros((), x.dtype), lx, False, 0, calls))
        x_new = jnp.where(accepted, x + t * e, x)
        lx_new = jnp.where(accepted, l_new, lx)
        return (x_new, lx_new, calls), None

    keys = jax.random.split(key, num_repeats)
    (x, lx, calls), _ = jax.lax.scan(one_repeat, (x0, logl0, 0), keys)
    return x, lx, calls


def _volume_consts(nlive, n_prior, max_dead):
    """
    Exact volume bookkeeping with a shrinking live count through the
    prior phase: dead point j was killed at live count n_at_kill(j), so
    X_prev(j) = exp(-sum_{i<j} 1/n_at_kill(i)) and its shell is
    X_prev (1 - exp(-1/n_at_kill)).  All static (numpy) arrays.
    """
    import numpy as np
    k0_dead = n_prior - nlive
    max_dead_tot = k0_dead + max_dead
    idx_np = np.arange(max_dead_tot)
    n_at_kill = np.where(idx_np < k0_dead, n_prior - idx_np,
                         float(nlive)).astype(np.float64)
    inv_n = 1.0 / n_at_kill
    logx_prev_np = -(np.cumsum(inv_n) - inv_n)         # exclusive cumsum
    log_shell_np = np.log(-np.expm1(-inv_n))
    H0 = float(inv_n[:k0_dead].sum())  # volume consumed by the prior phase
    return logx_prev_np, log_shell_np, H0


def _dead_logw_of(dead_logl, k, logx_prev, log_shell, max_dead_tot):
    """Unnormalized dead-point log-weights (entries >= k masked)."""
    idx = jnp.arange(max_dead_tot)
    return jnp.where(idx < k, dead_logl + logx_prev + log_shell, -jnp.inf)


def _logx_of(k, nlive, k0_dead, H0, dtype):
    """Remaining log prior volume after k dead points."""
    return -(H0 + (k.astype(dtype) - k0_dead) / nlive)


@partial(jax.jit, static_argnames=("logl_fn", "nlive", "n_prior",
                                   "max_dead"))
def _ns_init(logl_fn, params, key, lo, hi, *, nlive, n_prior, max_dead):
    """Prior phase: n_prior draws, worst ``n_prior - nlive`` recorded dead."""
    d = lo.shape[0]
    dtype = lo.dtype
    k0_dead = n_prior - nlive
    max_dead_tot = k0_dead + max_dead
    k0_key, key = jax.random.split(key)
    pool_X = jax.random.uniform(k0_key, (n_prior, d), dtype) \
        * (hi - lo) + lo
    pool_logl = logl_fn(params, pool_X)
    order0 = jnp.argsort(pool_logl)
    live_X = pool_X[order0[k0_dead:]]
    live_logl = pool_logl[order0[k0_dead:]]

    dead_X = jnp.zeros((max_dead_tot, d), dtype)
    dead_logl = jnp.full((max_dead_tot,), -jnp.inf, dtype)
    if k0_dead:
        dead_X = dead_X.at[:k0_dead].set(pool_X[order0[:k0_dead]])
        dead_logl = dead_logl.at[:k0_dead].set(pool_logl[order0[:k0_dead]])
    return (key, live_X, live_logl, dead_X, dead_logl,
            jnp.asarray(k0_dead, jnp.int32),
            jnp.asarray(n_prior, jnp.int32))


@partial(jax.jit, static_argnames=("logl_fn", "nlive", "num_repeats",
                                   "max_dead", "kill_batch", "mesh",
                                   "n_prior", "seg_steps"))
def _ns_segment(logl_fn, params, state, lo, hi, precision_criterion, *,
                nlive, num_repeats, max_dead, kill_batch, mesh, n_prior,
                seg_steps):
    """
    Advance NS by at most ``seg_steps`` outer iterations (or until the
    termination criterion).  Returns ``(state, done)`` with ``done`` a
    device bool: segmenting bounds the runtime of any single XLA program
    (e.g. the final MC at d>=16, nlive=50d); numerics are identical to an
    unsegmented run because the loop is simply re-entered where it left.
    """
    d = lo.shape[0]
    dtype = lo.dtype
    B = kill_batch
    k0_dead = n_prior - nlive
    max_dead_tot = k0_dead + max_dead
    logx_prev_np, log_shell_np, H0 = _volume_consts(nlive, n_prior, max_dead)
    logx_prev = jnp.asarray(logx_prev_np, dtype)
    log_shell = jnp.asarray(log_shell_np, dtype)

    def logz_dead(dead_logl, k):
        return logsumexp(_dead_logw_of(dead_logl, k, logx_prev, log_shell,
                                       max_dead_tot))

    def logx_at(k):
        return _logx_of(k, nlive, k0_dead, H0, dtype)

    def outer_cond(state):
        key, live_X, live_logl, dead_X, dead_logl, k, calls = state
        logz_d = logz_dead(dead_logl, k)
        logx = logx_at(k)
        logz_live = logsumexp(live_logl) - jnp.log(float(nlive)) + logx
        logz_tot = jnp.logaddexp(logz_d, logz_live)
        not_converged = (logz_live - logz_tot) > jnp.log(precision_criterion)
        has_room = k + B <= max_dead_tot
        # plateau stop: if all live points share (numerically) the same
        # log-density — e.g. the surrogate's clipped flat top — further
        # compression gains nothing and the evidence criterion can never
        # trigger.
        spread = jnp.max(live_logl) - jnp.min(live_logl)
        plateau = (k - k0_dead > nlive) & jnp.isfinite(spread) & \
            (spread < 1e-9 * jnp.maximum(1.0, jnp.abs(jnp.max(live_logl))))
        # keep going while not converged (or nothing finite yet) and room
        return (not_converged | jnp.isinf(logz_tot)) & has_room & ~plateau

    def outer_body(state):
        key, live_X, live_logl, dead_X, dead_logl, k, calls = state
        key, k_pick, k_chains = jax.random.split(key, 3)

        order = jnp.argsort(live_logl)
        kill_idx = order[:B]
        survive_idx = order[B:]
        lstar = live_logl[order[B - 1]]

        # record dead points in ascending-logl order
        dead_X = jax.lax.dynamic_update_slice(
            dead_X, live_X[kill_idx], (k, jnp.zeros((), k.dtype)))
        dead_logl = jax.lax.dynamic_update_slice(
            dead_logl, live_logl[kill_idx], (k,))

        # covariance-whitened directions from survivors
        Xs = live_X[survive_idx]
        mu = jnp.mean(Xs, axis=0)
        diff = Xs - mu
        cov = diff.T @ diff / (nlive - B) + 1e-12 * jnp.eye(d, dtype=dtype)
        chol = jnp.linalg.cholesky(cov)

        starts = jax.random.choice(k_pick, nlive - B, (B,), replace=True)
        x0s = Xs[starts]
        l0s = live_logl[survive_idx][starts]
        chain_keys = jax.random.split(k_chains, B)

        def chains(keys_b, x0_b, l0_b):
            return jax.vmap(
                lambda kk, x0, l0: _slice_chain(
                    logl_fn, params, kk, x0, l0, lstar, chol, num_repeats,
                    lo, hi)
            )(keys_b, x0_b, l0_b)

        if mesh is not None and B % mesh.shape["data"] == 0:
            from jax.sharding import PartitionSpec as P
            chains = jax.shard_map(
                chains, mesh=mesh,
                in_specs=(P("data"), P("data", None), P("data")),
                out_specs=(P("data", None), P("data"), P("data")),
                check_vma=False)
        xs, ls, cs = chains(chain_keys, x0s, l0s)

        live_X = live_X.at[kill_idx].set(xs)
        live_logl = live_logl.at[kill_idx].set(ls)
        return (key, live_X, live_logl, dead_X, dead_logl, k + B,
                calls + jnp.sum(cs).astype(calls.dtype))

    def seg_cond(carry):
        st, s = carry
        return outer_cond(st) & (s < seg_steps)

    def seg_body(carry):
        st, s = carry
        return outer_body(st), s + 1

    state, _ = jax.lax.while_loop(
        seg_cond, seg_body, (state, jnp.asarray(0, jnp.int32)))
    return state, ~outer_cond(state)


@partial(jax.jit, static_argnames=("nlive", "n_prior", "max_dead"))
def _ns_finalize(state, *, nlive, n_prior, max_dead):
    """Assemble weighted samples: dead points + final live points."""
    key, live_X, live_logl, dead_X, dead_logl, k, calls = state
    dtype = live_X.dtype
    k0_dead = n_prior - nlive
    max_dead_tot = k0_dead + max_dead
    logx_prev_np, log_shell_np, H0 = _volume_consts(nlive, n_prior, max_dead)
    logx_prev = jnp.asarray(logx_prev_np, dtype)
    log_shell = jnp.asarray(log_shell_np, dtype)
    dead_logw = _dead_logw_of(dead_logl, k, logx_prev, log_shell,
                              max_dead_tot)
    logx_final = _logx_of(k, nlive, k0_dead, H0, dtype)
    live_logw = live_logl + logx_final - jnp.log(float(nlive))
    X_all = jnp.concatenate([dead_X, live_X], axis=0)
    logl_all = jnp.concatenate([dead_logl, live_logl])
    logw_all = jnp.concatenate([dead_logw, live_logw])
    logZ = logsumexp(logw_all)
    return NSResult(X=X_all, logl=logl_all, logw=logw_all, n_dead=k,
                    logZ=logZ, n_calls=calls)


def run_nested_device(logl_fn, params, key, lo, hi, nlive=200,
                      num_repeats=10, precision_criterion=0.01,
                      max_dead=5000, kill_batch=None, mesh=None,
                      n_prior=None, max_steps_per_call=None,
                      on_segment=None, lookahead=None):
    """
    Run nested sampling on device.  ``logl_fn(params, X)`` is a jittable
    ``(nq, d) -> (nq,)`` log-density (e.g. the gated surrogate mean); it must
    be a *module-level function* (stable identity, so jit caches across
    calls) with all changing state in the traced ``params`` pytree.
    Uniform prior on the box [lo, hi].

    ``n_prior`` (default ``nlive``): size of the initial prior sample, the
    analogue of PolyChord's ``nprior`` (reference default ``10 * nlive``,
    gpry/gp_acquisition.py:633).  The worst ``n_prior - nlive`` prior draws
    are recorded as dead points with exact shrinking-live-count volume
    bookkeeping, so a larger prior phase improves tail coverage without
    biasing the evidence.

    With ``mesh`` (a 1-D device mesh whose size divides the kill batch), the
    per-step batch of slice-sampling chains is DP-sharded over the mesh —
    the analogue of PolyChord parallelizing its live-point evolution
    over MPI ranks (gpry/ns_interfaces.py:199-207).  Chains are independent
    lock-step lanes, so sharded and unsharded runs produce identical
    samples.

    ``max_steps_per_call`` (default: ``GPRY_TPU_NS_SEG_STEPS`` env var, else
    32) caps the outer NS iterations executed per device program.  The run
    is host-driven over bounded jitted segments with all state resident on
    device, so only a scalar ``done`` flag crosses per segment.  Bounded
    segments keep every device program short, so that a runtime watchdog
    never sees a multi-minute program and liveness hooks tick during long
    runs; pass ``0`` to restore single-program behavior.  Whether the
    segmenting costs time on a GPU is not measured yet.

    ``lookahead`` (default: ``GPRY_TPU_NS_SEG_LOOKAHEAD`` env var, else 2)
    pipelines segment dispatch: up to ``lookahead`` segments are enqueued
    on the device before the host reads their ``done`` flags, so the
    device queue never drains while the host waits for a flag.  This is
    sound because a segment entered on a finished state is
    an exact no-op (``outer_cond`` is already false, the while_loop exits
    immediately and returns the state unchanged), so overshooting by up to
    ``lookahead`` segments costs only empty program launches and the final
    state is bit-identical to unpipelined execution.  ``0`` restores
    strict dispatch-then-wait behavior.
    """
    import os

    nlive = int(nlive)
    if kill_batch is None:
        kill_batch = max(1, nlive // 6)
    B = int(kill_batch)
    if n_prior is None or n_prior < nlive:
        n_prior = nlive
    n_prior = int(n_prior)
    max_dead = int(max_dead)
    total_steps = max_dead // B + 2       # has_room bound; cond re-checks
    if max_steps_per_call is None:
        max_steps_per_call = int(os.environ.get("GPRY_TPU_NS_SEG_STEPS", 32))
    max_steps_per_call = int(max_steps_per_call)
    seg = total_steps if max_steps_per_call <= 0 \
        else min(total_steps, max_steps_per_call)

    if lookahead is None:
        lookahead = int(os.environ.get("GPRY_TPU_NS_SEG_LOOKAHEAD", 2))
    lookahead = max(0, int(lookahead))

    state = _ns_init(logl_fn, params, key, lo, hi, nlive=nlive,
                     n_prior=n_prior, max_dead=max_dead)
    pending = []                   # FIFO of not-yet-read device done flags
    while True:
        state, done = _ns_segment(
            logl_fn, params, state, lo, hi, precision_criterion,
            nlive=nlive, num_repeats=int(num_repeats), max_dead=max_dead,
            kill_batch=B, mesh=mesh, n_prior=n_prior, seg_steps=seg)
        pending.append(done)
        if len(pending) <= lookahead:
            continue               # keep the device queue primed
        done = bool(pending.pop(0))  # blocks until THAT segment finished
        if on_segment is not None:
            # liveness hook: the segment has completed on device, so
            # external watchdogs can treat this as proof of forward
            # progress
            on_segment()
        if done:
            break
    return _ns_finalize(state, nlive=nlive, n_prior=n_prior,
                        max_dead=max_dead)
