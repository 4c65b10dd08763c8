"""
RankedPool: Kriging-believer ranking of acquisition candidates.

Reference behavior: gpry/gp_acquisition.py:1194-1670.  The reference keeps a
pool of size+1 candidates ranked by *conditioned* acquisition value — the
acquisition each point would have if the points above it in the pool had
already been added (with their predicted values) to the GP — and documents
the conditioned-model cache (deepcopy + refactorize per pool slot) at ~50%
of the ranking cost (gpry/gp_acquisition.py:1530-1546).

Device replacement: conditioning is an O(nmax^2 k) block-Cholesky
append on the ``SurrogateParams`` pytree (acquisition.base.append_lie), and
the pool is filled with the vectorized "bulk" algorithm
(gpry/gp_acquisition.py:1337-1390): at each of the ``size`` steps, ONE
batched device prediction computes the conditioned std of *all* remaining
candidates, the argmax is appended as a believer lie, and -inf entries are
dropped.  Conditioned acquisition can only decrease with more conditioning,
which makes this greedy fill exact for the pool head.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from gpry_tpu.acquisition.base import append_lie
from gpry_tpu.models.gp import surrogate_predict


def _predict(family, p, Xq):
    """Row-sharded over the device mesh when available (identical results);
    lazy import avoids a cycle at module load."""
    from gpry_tpu.parallel.mesh import predict_maybe_sharded
    return predict_maybe_sharded(family, p, Xq)


@partial(jax.jit, static_argnames=("family", "size", "key"))
def _bulk_fill_device(family, size, key, p, Xd_raw, y, sigma, acq0, alive0,
                      noise_std):
    """
    The whole greedy Kriging-believer fill as ONE device program: ``size``
    rounds of (conditioned-sigma sweep -> acq -> argmax -> rank-1 Cholesky
    append).  The host loop version dispatches ~3 device calls + ~1 eager
    sweep per round; fused, the whole fill is one dispatch.  ``key`` is ``(acq_func, params_token)``
    as in ``functions.acq_values_jit``.  ``p`` must have at least ``size``
    free padded rows (the caller pre-grows).  Returns
    ``(outX, outY, outSigma, outAcq, outAcqCond)`` with unfilled slots
    carrying acq_cond = -inf.
    """
    from gpry_tpu.ops.kernels import cross_kernel, kernel_diag
    acqf = key[0]
    dt = p.X.dtype
    nmax = p.X.shape[0]
    N = Xd_raw.shape[0]
    d = Xd_raw.shape[1]
    Xq_ = (Xd_raw - p.x_loc) / p.x_scale
    prior_var = kernel_diag(family, p.theta, Xq_)
    minus_inf = jnp.asarray(-jnp.inf, dt)

    def _noise_at(n):
        # same believer-lie noise convention as ops.linalg.chol_append:
        # the padded per-row default at the insertion row (scalar case
        # broadcasts trivially)
        if jnp.ndim(p.noise_var) == 0:
            return jnp.asarray(p.noise_var, dt)
        return jax.lax.dynamic_slice(
            jnp.asarray(p.noise_var, dt), (n,), (1,))[0]

    def sigma_cond(Xbuf, n, L):
        m = (jnp.arange(nmax) < n).astype(dt)
        Kq = cross_kernel(family, p.theta, Xq_, Xbuf) * m[None, :]
        V = solve_triangular(L, Kq.T, lower=True)
        var = prior_var - jnp.sum(V * V, axis=0)
        return jnp.sqrt(jnp.maximum(var, 0.0)) * p.y_scale

    def select_and_append(carry, acq_cond):
        Xbuf, ybuf, n, L, alive, outs, i = carry
        acq_m = jnp.where(alive, acq_cond, minus_inf)
        j = jnp.argmax(acq_m)
        valid = jnp.isfinite(acq_m[j])
        outX, outY, outS, outA, outC = outs
        outs = (outX.at[i].set(jnp.where(valid, Xd_raw[j], 0.0)),
                outY.at[i].set(jnp.where(valid, y[j], 0.0)),
                outS.at[i].set(jnp.where(valid, sigma[j], 0.0)),
                outA.at[i].set(jnp.where(valid, acq0[j], minus_inf)),
                outC.at[i].set(jnp.where(valid, acq_m[j], minus_inf)))
        alive = alive & (jnp.arange(N) != j)
        # rank-1 Cholesky append of the believer lie at row n
        xj_ = Xq_[j]
        yj_ = (y[j] - p.y_loc) / p.y_scale
        m = (jnp.arange(nmax) < n).astype(dt)
        K12 = cross_kernel(family, p.theta, Xbuf, xj_[None]) * m[:, None]
        S12 = solve_triangular(L, K12, lower=True)[:, 0]
        k22 = kernel_diag(family, p.theta, xj_[None])[0] + _noise_at(n)
        s22 = jnp.sqrt(jnp.maximum(k22 - jnp.sum(S12 * S12), 1e-12))
        Lrow = jnp.where(jnp.arange(nmax) == n, s22, S12)
        ok = valid  # only commit the append for a valid selection
        Xbuf = jnp.where(ok, Xbuf.at[n].set(xj_), Xbuf)
        ybuf = jnp.where(ok, ybuf.at[n].set(yj_), ybuf)
        L = jnp.where(ok, L.at[n].set(Lrow), L)
        n = jnp.where(ok, n + 1, n)
        return (Xbuf, ybuf, n, L, alive, outs, i + 1)

    outs0 = (jnp.zeros((size, d), dt), jnp.zeros(size, dt),
             jnp.zeros(size, dt), jnp.full(size, minus_inf),
             jnp.full(size, minus_inf))
    carry = (p.X, p.y, jnp.asarray(p.n, jnp.int32), p.L, alive0, outs0,
             jnp.asarray(0, jnp.int32))
    # round 0 ranks by the unconditioned acquisition
    carry = select_and_append(carry, jnp.asarray(acq0, dt))

    def body(_, carry):
        Xbuf, ybuf, n, L, alive, outs, i = carry
        sd = sigma_cond(Xbuf, n, L)
        ac = acqf.values(jnp.asarray(y, dt), sd, p.y_max, noise_std)
        finite = jnp.isfinite(ac)
        # f32 conditioning can produce NaN on near-singular appends;
        # conditioned-ineligible candidates drop out permanently
        alive = alive & finite
        carry = (Xbuf, ybuf, n, L, alive, outs, i)
        return select_and_append(carry, jnp.where(finite, ac, minus_inf))

    if size > 1:
        carry = jax.lax.fori_loop(1, size, body, carry)
    return carry[5]


class RankedPool:
    """
    Parameters
    ----------
    size : int
        Number of proposals to keep (the pool has one buffer slot).
    gpr : GaussianProcessRegressor
        The surrogate (used for its params snapshot and kernel family).
    acq_func : callable
        ``acq(y, sigma) -> value`` (hyperparameters already bound).
    """

    def __init__(self, size, gpr, acq_func, verbose=1, acqf=None):
        self.size = int(size)
        self._gpr = gpr
        self._family = gpr.family
        self._acq_func = acq_func
        #: the underlying AcquisitionFunction object (enables the fused
        #: on-device bulk fill; the plain callable is kept for API parity)
        self._acqf = acqf
        self.verbose = verbose
        d = gpr.d
        self.X = np.zeros((size + 1, d))
        self.y = np.zeros(size + 1)
        self.sigma = np.zeros(size + 1)
        self.acq = np.zeros(size + 1)
        self.acq_cond = np.full(size + 1, -np.inf)
        self.cache_counter = 0
        self._base_params = None
        self._cond_params = [None] * (size + 1)  # conditioned on slots < i

    def __len__(self):
        return self.size

    @property
    def min_acq(self):
        """Conditioned acq of the last kept slot; -inf while not full
        (reference: gpry/gp_acquisition.py:1237-1247)."""
        return self.acq_cond[self.size - 1]

    def _params0(self):
        if self._base_params is None:
            # condition-aware sweep dtype (models/gp.py:sweep_dtype)
            self._base_params = self._gpr.sweep_params()
        return self._base_params

    def _conditioned_params(self, i):
        """Surrogate conditioned on pool slots 0..i-1 (cached)."""
        if i == 0:
            return self._params0()
        if self._cond_params[i] is None:
            p = self._conditioned_params(i - 1)
            x = jnp.asarray(self.X[i - 1][None], p.X.dtype)
            y_lie = self.y[i - 1]
            if not np.isfinite(y_lie):  # -inf lie: condition at a low value
                y_lie = float(np.min(self._gpr.y_train)) \
                    if self._gpr.n else 0.0
            y = jnp.asarray([y_lie], p.X.dtype)
            self._cond_params[i] = append_lie(self._family, p, x, y)
            self.cache_counter += 1
        return self._cond_params[i]

    def _invalidate_from(self, i):
        for j in range(i + 1, self.size + 1):
            self._cond_params[j] = None

    # ------------------------------------------------------------------- add

    def add(self, X, y=None, sigma=None, acq=None, method="bulk"):
        """
        Add a batch of candidates (reference:
        gpry/gp_acquisition.py:1290-1335).  ``method``: "bulk" (vectorized,
        default here — chosen among the fastest upstream) or
        "single sort acq" / "single sort y" / "single" (one-by-one
        insertion).
        """
        X = np.atleast_2d(np.asarray(X, dtype=float))
        p0 = self._params0()
        if y is None or sigma is None:
            mu, sd = surrogate_predict(
                self._family, p0, jnp.asarray(X, p0.X.dtype))
            y = np.asarray(mu) if y is None else np.atleast_1d(y)
            sigma = np.asarray(sd) if sigma is None else np.atleast_1d(sigma)
        else:
            y = np.atleast_1d(np.asarray(y, dtype=float))
            sigma = np.atleast_1d(np.asarray(sigma, dtype=float))
        if acq is None:
            acq = np.asarray(self._acq_func(y, sigma))
        else:
            acq = np.atleast_1d(np.asarray(acq, dtype=float))
        method = method.lower()
        if method == "bulk":
            self.add_bulk(X, y, sigma, acq)
        elif method.startswith("single"):
            if "sort" in method:
                key = {"acq": acq, "y": y}[method.split()[-1]]
                order = np.argsort(key)[::-1]
            else:
                order = np.arange(len(X))
            for i in order:
                self.add_one(X[i], y[i], sigma[i], acq[i])
        else:
            raise ValueError(f"Unknown ranking method '{method}'.")

    #: candidate counts are padded to a multiple of this so every
    #: conditioned-prediction sweep reuses one compiled shape (shrinking
    #: the array per step caused a fresh multi-second jit compile per
    #: slot per NS-sample length)
    ROW_BUCKET = 256

    def add_bulk(self, X, y, sigma, acq):
        """
        Vectorized greedy fill (reference: gpry/gp_acquisition.py:1337-1390).
        Fixed-shape: selected/ineligible candidates are masked out instead
        of removed, so all ``size`` conditioning sweeps share one compiled
        shape.
        """
        keep = np.isfinite(acq)
        X, y, sigma, acq = X[keep], y[keep], sigma[keep], acq[keep]
        n = len(X)
        if n == 0:
            return
        pad = (-n) % self.ROW_BUCKET
        if pad:
            X = np.vstack([X, np.repeat(X[:1], pad, axis=0)])
            y = np.concatenate([y, np.full(pad, y[0])])
            sigma = np.concatenate([sigma, np.full(pad, sigma[0])])
            acq = np.concatenate([acq, np.full(pad, -np.inf)])
        alive = np.zeros(len(X), dtype=bool)
        alive[:n] = True
        p0 = self._params0()
        Xd = jnp.asarray(X, p0.X.dtype)
        from gpry_tpu.parallel.mesh import available_mesh
        if available_mesh(p0.X) is None and self._acqf is not None:
            # Single device: the whole greedy fill is one fused program.
            # (With a mesh, the per-round host loop below keeps the
            # conditioning sweeps row-sharded over the devices.)
            from gpry_tpu import config
            from gpry_tpu.acquisition.base import grow_surrogate
            from gpry_tpu.acquisition.functions import _params_token
            p = grow_surrogate(
                p0, config.bucket_size(int(p0.n) + self.size))
            dt = p.X.dtype
            noise_std = float(np.mean(self._gpr.noise_level)) \
                if self._gpr is not None else 0.0
            outX, outY, outS, outA, outC = _bulk_fill_device(
                self._family, self.size,
                (self._acqf, _params_token(self._acqf)), p,
                jnp.asarray(X, dt), jnp.asarray(y, dt),
                jnp.asarray(sigma, dt), jnp.asarray(acq, dt),
                jnp.asarray(alive), noise_std)
            outC = np.asarray(outC, dtype=float)
            filled = np.isfinite(outC)
            k = int(filled.sum())
            self.X[:self.size][filled] = np.asarray(outX, dtype=float)[filled]
            self.y[:self.size][filled] = np.asarray(outY, dtype=float)[filled]
            self.sigma[:self.size][filled] = \
                np.asarray(outS, dtype=float)[filled]
            self.acq[:self.size][filled] = np.asarray(outA, dtype=float)[filled]
            self.acq_cond[:self.size] = outC
            self.cache_counter += k
            self._invalidate_from(0)
            return
        for i in range(self.size):
            if not np.any(alive):
                break
            if i == 0:
                acq_cond = np.where(alive, acq, -np.inf)
            else:
                p = self._conditioned_params(i)
                _, sd_cond = _predict(self._family, p, Xd)
                acq_cond = np.asarray(self._acq_func(y, np.asarray(sd_cond)))
                # f32 conditioning can produce NaN on near-singular appends;
                # conditioned-ineligible candidates drop out permanently
                # (as in the shrinking version)
                acq_cond = np.where(alive & np.isfinite(acq_cond),
                                    acq_cond, -np.inf)
                alive &= np.isfinite(acq_cond)
            j = int(np.argmax(acq_cond))
            if not np.isfinite(acq_cond[j]):
                break
            self.X[i], self.y[i] = X[j], y[j]
            self.sigma[i], self.acq[i] = sigma[j], acq[j]
            self.acq_cond[i] = acq_cond[j]
            self._invalidate_from(i - 1 if i else 0)
            alive[j] = False

    def add_one(self, X, y=None, sigma=None, acq=None):
        """
        Insert a single candidate with conditioned re-ranking
        (reference: gpry/gp_acquisition.py:1392-1520).
        """
        X = np.atleast_1d(np.asarray(X, dtype=float))
        p0 = self._params0()
        if y is None or sigma is None:
            mu, sd = surrogate_predict(
                self._family, p0, jnp.asarray(X[None], p0.X.dtype))
            y = float(mu[0]) if y is None else float(y)
            sigma = float(sd[0]) if sigma is None else float(sigma)
        if acq is None:
            acq = float(self._acq_func(np.atleast_1d(y),
                                       np.atleast_1d(sigma))[0])
        if not np.isfinite(acq) or acq <= self.min_acq:
            return
        # Walk down: conditioned acq can only decrease with depth, so keep
        # descending while the (reconditioned) value loses to the incumbent.
        pos = 0
        acq_cond = acq
        while pos < self.size and acq_cond <= self.acq_cond[pos]:
            pos += 1
            if pos >= self.size:
                return
            pc = self._conditioned_params(pos)
            _, sd_c = surrogate_predict(
                self._family, pc, jnp.asarray(X[None], pc.X.dtype))
            acq_cond = float(self._acq_func(
                np.atleast_1d(y), np.atleast_1d(np.asarray(sd_c)[0]))[0])
            if not np.isfinite(acq_cond):
                return
        # shift down and insert
        self.X[pos + 1:] = self.X[pos:-1]
        self.y[pos + 1:] = self.y[pos:-1]
        self.sigma[pos + 1:] = self.sigma[pos:-1]
        self.acq[pos + 1:] = self.acq[pos:-1]
        self.acq_cond[pos + 1:] = self.acq_cond[pos:-1]
        self.X[pos], self.y[pos] = X, y
        self.sigma[pos], self.acq[pos] = sigma, acq
        self.acq_cond[pos] = acq_cond
        self._invalidate_from(pos)
        # re-rank everything below the insertion point under the new
        # conditioning (cheap batched recomputation)
        self._resort_below(pos)

    def _resort_below(self, pos):
        """Recompute conditioned acq for slots > pos, greedily."""
        tail = slice(pos + 1, self.size + 1)
        Xt = self.X[tail].copy()
        yt = self.y[tail].copy()
        st = self.sigma[tail].copy()
        at = self.acq[tail].copy()
        valid = np.isfinite(self.acq_cond[tail])
        self.acq_cond[tail] = -np.inf
        if not np.any(valid):
            return
        # greedy refill of the tail using conditioned params from pos+1
        Xv, yv, sv, av = Xt[valid], yt[valid], st[valid], at[valid]
        i_out = pos + 1
        for _ in range(len(yv)):
            if i_out > self.size or len(yv) == 0:
                break
            p = self._conditioned_params(i_out)
            _, sd_cond = surrogate_predict(
                self._family, p, jnp.asarray(Xv, p.X.dtype))
            acq_cond = np.asarray(self._acq_func(yv, np.asarray(sd_cond)))
            j = int(np.argmax(acq_cond))
            if not np.isfinite(acq_cond[j]):
                break
            self.X[i_out], self.y[i_out] = Xv[j], yv[j]
            self.sigma[i_out], self.acq[i_out] = sv[j], av[j]
            self.acq_cond[i_out] = acq_cond[j]
            self._invalidate_from(i_out - 1 if i_out else 0)
            sel = np.ones(len(yv), dtype=bool)
            sel[j] = False
            Xv, yv, sv, av = Xv[sel], yv[sel], sv[sel], av[sel]
            i_out += 1

    # --------------------------------------------------------------- results

    def get(self):
        """Top ``size`` proposals as (X, y_lies, acq_values)."""
        filled = np.isfinite(self.acq_cond[:self.size])
        return (self.X[:self.size][filled], self.y[:self.size][filled],
                self.acq_cond[:self.size][filled])

    def reset(self, gpr=None):
        if gpr is not None:
            self._gpr = gpr
            self._family = gpr.family
        self.acq_cond[:] = -np.inf
        self._base_params = None
        self._cond_params = [None] * (self.size + 1)

    def __getstate__(self):
        """Drop unpicklable/heavy refs (reference:
        gpry/gp_acquisition.py:1564-1573)."""
        state = self.__dict__.copy()
        state["_gpr"] = None
        state["_acq_func"] = None
        state["_acqf"] = None
        state["_base_params"] = None
        state["_cond_params"] = [None] * (self.size + 1)
        return state
