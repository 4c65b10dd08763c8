"""
Shared acquisition-engine machinery.

Reference surface: ``GenericGPAcquisition`` (gpry/gp_acquisition.py:38-118):
engines are constructed with the prior bounds and an acquisition function
spec (instance, class name, or single-key dict), and expose
``multi_add(gpr, n_points, bounds, rng)``.
"""

import gpry_tpu.acquisition.functions as af_module
from gpry_tpu.acquisition.functions import AcquisitionFunction, LogExp
from gpry_tpu.models.gp import SurrogateParams
from gpry_tpu.ops.linalg import chol_append
from gpry_tpu.utils.tools import check_and_return_bounds, get_Xnumber

import jax.numpy as jnp


def construct_acq_func(spec, d, zeta_scaling=0.85):
    """
    Build an acquisition function from an instance / name / {name: kwargs}
    (reference: gpry/gp_acquisition.py:51-78).
    """
    if isinstance(spec, AcquisitionFunction):
        return spec
    if isinstance(spec, str):
        spec = {spec: {}}
    if isinstance(spec, dict) and len(spec) == 1:
        name = list(spec)[0]
        kwargs = dict(spec[name] or {})
        cls = getattr(af_module, name, None)
        if cls is None or not issubclass(cls, AcquisitionFunction):
            raise ValueError(f"Unknown acquisition function '{name}'.")
        if cls is LogExp or issubclass(cls, LogExp):
            kwargs.setdefault("dimension", d)
            kwargs.setdefault("zeta_scaling", zeta_scaling)
        return cls(**kwargs)
    raise ValueError(f"Cannot build acquisition function from {spec!r}")


def grow_surrogate(p: SurrogateParams, nmax_new):
    """
    Re-pad a surrogate snapshot to a larger buffer: zeros on X/y/alpha,
    identity on the padded block of L (the invariant of ops.linalg), and the
    mean noise on new per-point noise entries (only believer lies ever land
    there).  Used when Kriging-believer conditioning hits a full bucket.
    """
    nmax = p.X.shape[0]
    k = int(nmax_new) - nmax
    if k <= 0:
        return p
    X2 = jnp.pad(p.X, ((0, k), (0, 0)))
    y2 = jnp.pad(p.y, (0, k))
    alpha2 = jnp.pad(p.alpha, (0, k))
    L2 = jnp.pad(p.L, ((0, k), (0, k)))
    idx = jnp.arange(nmax, nmax + k)
    L2 = L2.at[idx, idx].set(1.0)
    noise = p.noise_var
    if jnp.ndim(noise) > 0:
        noise = jnp.pad(noise, (0, k), constant_values=float(noise.mean()))
    return p._replace(X=X2, y=y2, L=L2, alpha=alpha2, noise_var=noise)


def append_lie(family, p: SurrogateParams, x_raw, y_raw):
    """
    Kriging-believer conditioning as a pure O(nmax^2) update on the
    surrogate pytree: append (x, lie) without refitting anything.  This is
    the device-side replacement for the reference's deepcopy + refactorize
    model cache (gpry/gp_acquisition.py:1522-1555).

    Grows the padded buffers when the bucket is exactly full (n == nmax) —
    otherwise the out-of-bounds scatter would be silently dropped and the
    conditioning would become a no-op.
    """
    x_raw = jnp.atleast_2d(x_raw)
    y_raw = jnp.atleast_1d(y_raw)
    k = x_raw.shape[0]
    if int(p.n) + k > p.X.shape[0]:
        from gpry_tpu import config
        p = grow_surrogate(p, config.bucket_size(int(p.n) + k))
    x_ = (x_raw - p.x_loc) / p.x_scale
    y_ = (y_raw - p.y_loc) / p.y_scale
    X2, y2, n2, L2, alpha2 = chol_append(
        family, p.theta, p.X, p.y, p.n, p.noise_var, p.L, x_, y_)
    return p._replace(X=X2, y=y2, n=n2, L=L2, alpha=alpha2)


class GenericGPAcquisition:
    """Base class for acquisition engines."""

    def __init__(self, bounds, acq_func="LogExp", preprocessing_X=None,
                 zeta_scaling=0.85, verbose=1):
        self.bounds = check_and_return_bounds(bounds)
        self.verbose = verbose
        self.zeta_scaling = zeta_scaling
        self.preprocessing_X = preprocessing_X
        self.acq_func = construct_acq_func(
            acq_func, len(self.bounds), zeta_scaling=zeta_scaling)
        self.mean = None
        self.cov = None

    @property
    def d(self):
        return self.bounds.shape[0]

    def _parse_dim_spec(self, value, varname):
        return get_Xnumber(value, "d", self.d, dtype=int, varname=varname)

    def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                  force_resample=False):
        raise NotImplementedError

    def force_resample(self):
        """Invalidate any cached surrogate-MC state so the next
        acquisition call recomputes it from scratch.  No-op for engines
        that keep no such cache (e.g. BatchOptimizer); NORA overrides."""

    def log(self, msg, level=3):
        if self.verbose >= level:
            print(msg)
