"""
Vmappable bound-constrained L-BFGS.

Replaces the reference's scipy ``fmin_l_bfgs_b`` calls — GP hyperparameter
fits (gpry/gpr.py:1435-1445) and acquisition optimization
(gpry/gp_acquisition.py:502-510) — whose multi-start restarts the reference
splits across MPI ranks.  Here the restarts run as one batched device
computation.

The solver is a compact hand-written L-BFGS (two-loop recursion with a
static circular history + Armijo backtracking line search) rather than
optax's zoom-linesearch L-BFGS: the zoom linesearch's nested while-loops
produce a graph whose compile time grows quickly with vmap width, while
this formulation is one small ``lax.while_loop`` that compiles quickly at
any batch width.  Multi-start restarts make the simpler line search
statistically equivalent for this workload.

Box constraints use a sigmoid reparametrization
``x = lo + (hi - lo) * sigmoid(u)``: unconstrained in u, jittable, with
asymptotic (never exact) attainment of the bounds — irrelevant here since
the optima of interest are interior or forgiving of ~1e-6 slack.
"""

import jax
import jax.numpy as jnp

_SIGMOID_CLIP = 15.0  # |u| cap: sigmoid(15) differs from 1 by ~3e-7


def to_unconstrained(x, lo, hi):
    """Map x in (lo, hi) to the unconstrained u-space."""
    t = jnp.clip((x - lo) / (hi - lo), 1e-9, 1 - 1e-9)
    return jnp.clip(jnp.log(t) - jnp.log1p(-t), -_SIGMOID_CLIP,
                    _SIGMOID_CLIP)


def to_constrained(u, lo, hi):
    """Map unconstrained u to x in (lo, hi)."""
    return lo + (hi - lo) * jax.nn.sigmoid(
        jnp.clip(u, -_SIGMOID_CLIP, _SIGMOID_CLIP))


def minimize_lbfgs(fun, x0, maxiter=100, tol=1e-8, memory_size=8,
                   max_linesearch_steps=18, stall_patience=5,
                   stall_rtol=None, count_evals=False):
    """
    Minimize ``fun`` (scalar, differentiable) from ``x0`` with L-BFGS +
    Armijo backtracking.  Returns ``(x_opt, f_opt)``, or
    ``(x_opt, f_opt, n_evals)`` with ``count_evals=True`` where ``n_evals``
    is the exact number of objective evaluations (value_and_grad calls +
    line-search probes).  Fully jittable and vmappable.  Non-finite
    objective values during the line search are backtracked past; a
    non-finite start yields (x0, fun(x0)).

    Stall detection: a lane whose objective improves by less than
    ``stall_rtol * (1 + |f|)`` for ``stall_patience`` consecutive
    iterations stops.  Under vmap, lax.while_loop runs lock-step until
    EVERY lane's cond is false, so without this, one restart wandering in
    a bad basin forces all lanes to burn the full ``maxiter`` (the winning
    basin can converge in ~15 polish iterations while losers pin the loop
    at 120).  Default ``stall_rtol``: 16x the dtype's machine
    eps — below that, per-iteration progress is rounding noise anyway.
    """
    value_and_grad = jax.value_and_grad(fun)
    n = x0.shape[0]
    M = memory_size
    dtype = x0.dtype
    eps = jnp.asarray(1e-12, dtype)
    if stall_rtol is None:
        stall_rtol = 16 * float(jnp.finfo(dtype).eps)
    stall_rtol = jnp.asarray(stall_rtol, dtype)

    def two_loop(g, S, Y, rho, kh):
        """
        L-BFGS direction from the (S, Y) history, newest pair at slot 0.
        Statically unrolled over the (small) memory with static indices
        only: no dynamic gathers into the history arrays inside the while
        loop.
        """
        q = g
        alphas = []
        for j in range(M):  # newest -> oldest
            valid = j < kh
            a = jnp.where(valid, rho[j] * jnp.dot(S[j], q), 0.0)
            q = q - a * Y[j]
            alphas.append(a)
        yy = jnp.dot(Y[0], Y[0])
        gamma = jnp.where(kh > 0,
                          jnp.dot(S[0], Y[0]) / jnp.maximum(yy, eps),
                          1.0)
        r = jnp.clip(gamma, 1e-8, 1e8) * q
        for j in reversed(range(M)):  # oldest -> newest
            valid = j < kh
            b = jnp.where(valid, rho[j] * jnp.dot(Y[j], r), 0.0)
            r = r + jnp.where(valid, alphas[j] - b, 0.0) * S[j]
        return -r

    def backtrack(x, f, g, d):
        """Armijo: halve t until sufficient decrease (or give up)."""
        gd = jnp.dot(g, d)

        def cond(st):
            t, f_t, it, ok = st
            return (~ok) & (it < max_linesearch_steps)

        def body(st):
            t, _, it, _ = st
            f_t = fun(x + t * d)
            ok = jnp.isfinite(f_t) & (f_t <= f + 1e-4 * t * gd)
            t_next = jnp.where(ok, t, t * 0.5)
            return t_next, f_t, it + 1, ok

        t, f_t, n_ls, ok = jax.lax.while_loop(
            cond, body, (jnp.asarray(1.0, dtype), f, 0, False))
        return jnp.where(ok, t, 0.0), jnp.where(ok, f_t, f), n_ls, ok

    def cond(state):
        x, f, g, S, Y, rho, kh, it, stall, stop, nev = state
        return (~stop) & (it < maxiter)

    def body(state):
        x, f, g, S, Y, rho, kh, it, stall, _, nev = state
        d = two_loop(g, S, Y, rho, kh)
        # safeguard: fall back to steepest descent if not a descent dir
        descent = jnp.dot(g, d) < 0
        d = jnp.where(descent, d, -g)
        t, f_new, n_ls, ok = backtrack(x, f, g, d)
        nev = nev + n_ls + 1  # line-search evals + the value_and_grad below
        x_new = x + t * d
        f_new2, g_new = value_and_grad(x_new)
        s = x_new - x
        yv = g_new - g
        sy = jnp.dot(s, yv)
        # curvature condition: only store PD-preserving pairs.  History is
        # shifted (newest at slot 0) with static indices only.
        store = ok & (sy > 1e-10)
        S = jnp.where(store, jnp.roll(S, 1, axis=0).at[0].set(s), S)
        Y = jnp.where(store, jnp.roll(Y, 1, axis=0).at[0].set(yv), Y)
        rho = jnp.where(
            store, jnp.roll(rho, 1).at[0].set(1.0 / jnp.maximum(sy, eps)),
            rho)
        kh = jnp.where(store, kh + 1, kh)
        gnorm = jnp.linalg.norm(g_new)
        improved = (f - f_new2) > stall_rtol * (1 + jnp.abs(f_new2))
        stall = jnp.where(improved, 0, stall + 1)
        stop = (~ok) | (gnorm < tol) | ~jnp.isfinite(f_new2) \
            | (stall >= stall_patience)
        return (x_new, f_new2, g_new, S, Y, rho, kh, it + 1, stall, stop,
                nev)

    f0, g0 = value_and_grad(x0)
    state0 = (x0, f0, g0,
              jnp.zeros((M, n), dtype), jnp.zeros((M, n), dtype),
              jnp.zeros(M, dtype), jnp.asarray(0, jnp.int32), 0,
              jnp.asarray(0, jnp.int32), ~jnp.isfinite(f0),
              jnp.asarray(1, jnp.int32))
    out = jax.lax.while_loop(cond, body, state0)
    x, f, nev = out[0], out[1], out[-1]
    bad = ~jnp.isfinite(f)
    x = jnp.where(bad, x0, x)
    f = jnp.where(bad, f0, f)
    if count_evals:
        return x, f, nev
    return x, f


def minimize_lbfgs_bounded(fun, x0, lo, hi, maxiter=100, tol=1e-8, **kw):
    """
    Box-constrained minimization via the sigmoid reparametrization.
    Returns ``(x_opt, f_opt)`` with x_opt strictly inside [lo, hi]
    (plus the exact objective-eval count with ``count_evals=True``).
    """
    u0 = to_unconstrained(x0, lo, hi)
    fun_u = lambda u: fun(to_constrained(u, lo, hi))
    out = minimize_lbfgs(fun_u, u0, maxiter=maxiter, tol=tol, **kw)
    return (to_constrained(out[0], lo, hi),) + tuple(out[1:])


def multistart_minimize(fun, x0s, lo, hi, maxiter=100, tol=1e-8,
                        count_evals=False):
    """
    Vmapped multi-start bounded minimization.  ``x0s`` has shape (R, d).
    Returns ``(xs (R, d), fs (R,))`` — the caller picks the argmin (like the
    reference's best-LML selection across MPI ranks, gpry/run.py:1286-1293).
    With ``count_evals=True`` a third output carries the exact per-lane
    objective evaluation counts (for the Progress "evals" telemetry).
    """
    solve = lambda x0: minimize_lbfgs_bounded(
        fun, x0, lo, hi, maxiter=maxiter, tol=tol, count_evals=count_evals)
    return jax.vmap(solve)(x0s)
