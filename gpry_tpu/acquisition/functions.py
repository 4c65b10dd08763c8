"""
Acquisition functions.

Reference surface: gpry/acquisition_functions.py (1449 LoC).  This build
keeps each acquisition function as a *pure jittable function of (mu, sigma)*
plus a tiny host-side class carrying hyperparameters — so the same object
drives vmapped sweeps over thousands of nested-sampling candidates and
autodiff gradients for the optimizer.

The production function is ``LogExp`` (gpry/acquisition_functions.py:1015):

    log A(x) = 2 zeta (mu(x) - y_max) + log sqrt(clip(sigma^2 - sigma_n^2, 0))

with value -inf where sigma^2 <= sigma_n^2 or mu is not finite
(gpry/acquisition_functions.py:983-992), and the auto-scaled
``zeta = d**-zeta_scaling`` with default scaling 0.85
(gpry/acquisition_functions.py:906-934, gpry/run.py:378).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _params_token(acqf):
    """Recursive hashable snapshot of an acq function's live parameters.

    Read from live attributes (not the ``_params`` dict) so that direct
    attribute mutation (``acqf.zeta = x``) is picked up just like
    ``set_params`` and never serves a stale compilation."""
    parts = [type(acqf).__name__]
    parts += [f"{k}={getattr(acqf, k, acqf._params.get(k))!r}"
              for k in sorted(acqf._params)]
    for attr in ("f1", "f2", "f"):
        child = getattr(acqf, attr, None)
        if isinstance(child, AcquisitionFunction):
            parts.append(_params_token(child))
    return "|".join(parts)


@partial(jax.jit, static_argnames=("key",))
def _acq_values_impl(key, mu, std, y_max, noise_std):
    return key[0].values(mu, std, y_max, noise_std)


def acq_values_jit(acqf, mu, std, y_max, noise_std):
    """
    One-dispatch jitted evaluation of ``acqf.values``.  Eager values()
    issues ~8 tiny device ops per call, each a dispatch, and every new
    sweep length costs fresh per-op compiles.  The static jit key is
    (instance, live-params token), so each (function, params, shape)
    triple compiles once and ``set_params`` mutations never serve a stale
    compilation.
    """
    return _acq_values_impl((acqf, _params_token(acqf)), mu, std, y_max,
                            noise_std)


def builtin_names():
    """Names of all built-in acquisition functions (full subclass tree,
    private helpers excluded)."""
    def _walk(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from _walk(sub)
    return sorted({cls.__name__ for cls in _walk(AcquisitionFunction)
                   if not cls.__name__.startswith("_")})


def is_acquisition_function(obj):
    return isinstance(obj, AcquisitionFunction)


class AcquisitionFunction:
    """
    Base class.  Subclasses implement ``values(mu, std, y_max, noise_std)``
    as a pure jittable function; ``__call__`` evaluates it against a GPR
    (host API parity with the reference's callable protocol).

    Noise convention (single, everywhere): ``noise_std`` is the noise
    standard deviation sigma_n — the reference passes ``gp.noise_level``
    (mean over per-point arrays) and squares it inside ``f``
    (gpry/acquisition_functions.py:973-983, 1068-1074).  NORA and
    BatchOptimizer pass exactly the same quantity, so acquisition values
    agree bitwise across engines.
    """

    hasgradient = True

    def get_params(self):
        return dict(self._params)

    def set_params(self, **params):
        self._params.update(params)
        for k, v in params.items():
            setattr(self, k, v)
        return self

    # -- pure function surface ------------------------------------------------

    def values(self, mu, std, y_max, noise_std):
        """Jittable acquisition values from raw-space (mu, std)."""
        raise NotImplementedError

    # -- host API parity -------------------------------------------------------

    def __call__(self, X, gpr, eval_gradient=False):
        if eval_gradient:
            mu, std, gmu, gstd = gpr.predict(
                X, return_std=True, return_mean_grad=True,
                return_std_grad=True)
        else:
            mu, std = gpr.predict(X, return_std=True)
        noise_std = self._noise_std(gpr)
        vals = np.asarray(self.values(
            jnp.asarray(mu), jnp.asarray(std), gpr.y_max, noise_std))
        if not eval_gradient:
            return vals
        g = self._gradient(np.asarray(mu), np.asarray(std),
                           np.asarray(gmu), np.asarray(gstd),
                           gpr.y_max, noise_std)
        return vals, g

    @staticmethod
    def _noise_std(gpr):
        nl = gpr.noise_level
        return float(np.mean(nl)) if np.iterable(nl) else float(nl)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        raise NotImplementedError


class LogExp(AcquisitionFunction):
    """
    Linearized exponentiated log-error bar (the production acquisition,
    gpry/acquisition_functions.py:1015-1074).
    """

    def __init__(self, zeta=None, sigma_n=None, fixed=False, dimension=None,
                 zeta_scaling=0.85):
        if zeta is None:
            if dimension is None:
                raise ValueError(
                    "Need 'dimension' to auto-scale zeta, or pass zeta.")
            zeta = float(dimension) ** (-float(zeta_scaling))
        self.zeta = float(zeta)
        self.sigma_n = sigma_n
        self.fixed = fixed
        self.zeta_scaling = zeta_scaling
        self._params = {"zeta": self.zeta, "sigma_n": sigma_n}

    def values(self, mu, std, y_max, noise_std):
        var = std * std - noise_std * noise_std
        ok = (var > 0) & jnp.isfinite(mu)
        safe_var = jnp.where(ok, var, 1.0)
        vals = 2.0 * self.zeta * (mu - y_max) + 0.5 * jnp.log(safe_var)
        return jnp.where(ok, vals, -jnp.inf)

    def _noise_std(self, gpr):
        if self.sigma_n is not None:
            return float(self.sigma_n)
        return super()._noise_std(gpr)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        # Reference gradient form (gpry/acquisition_functions.py:993-1007),
        # reproduced bit-for-bit INCLUDING its known inconsistency: the
        # reference's values() is 2 zeta mu + 0.5 log(std^2 - sigma_n^2)
        # but its gradient is that of 2 zeta mu + log(std - sigma_n) — the
        # two differ by a factor (std + sigma_n)/std when sigma_n > 0.
        # Parity wins here: the default sigma_n is the (tiny) mean noise
        # level, where the difference is negligible.
        ok = (std**2 - noise_std**2 > 0) & np.isfinite(mu)
        g = np.where(ok[..., None],
                     gstd / np.where(ok, std - noise_std, 1.0)[..., None]
                     + 2 * self.zeta * gmu,
                     np.inf)
        return g

    def __repr__(self):
        return f"LogExp(zeta={self.zeta:.3f})"


class NonlinearLogExp(LogExp):
    """
    Nonlinear variant: exp(2 zeta (mu - y_max)) * (exp(std) - 1)
    (gpry/acquisition_functions.py:1079; marked unused upstream, provided
    for API parity).  Gradients not supported.
    """

    hasgradient = False

    def values(self, mu, std, y_max, noise_std):
        ok = (std > 0) & jnp.isfinite(mu)
        vals = 2.0 * self.zeta * (mu - y_max) + \
            jnp.log(jnp.expm1(jnp.where(ok, std, 1.0)))
        return jnp.where(ok, vals, -jnp.inf)


class ConstantAcqFunc(AcquisitionFunction):
    """Constant acquisition (gpry/acquisition_functions.py:406)."""

    def __init__(self, value=1.0, fixed=True):
        self.value = float(value)
        self.fixed = fixed
        self._params = {"value": self.value}

    def values(self, mu, std, y_max, noise_std):
        return jnp.where(jnp.isfinite(mu), self.value, -jnp.inf)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        return np.zeros_like(gmu)


class Mu(AcquisitionFunction):
    """Pure exploitation: the GP mean (gpry/acquisition_functions.py:475)."""

    def __init__(self, fixed=True):
        self.fixed = fixed
        self._params = {}

    def values(self, mu, std, y_max, noise_std):
        return mu

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        return gmu


class Std(AcquisitionFunction):
    """Pure exploration: the GP std (gpry/acquisition_functions.py:557)."""

    def __init__(self, fixed=True):
        self.fixed = fixed
        self._params = {}

    def values(self, mu, std, y_max, noise_std):
        return jnp.where(jnp.isfinite(mu), std, -jnp.inf)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        return gstd


class ExponentialMu(Mu):
    """exp(mu) (gpry/acquisition_functions.py:620; unused upstream)."""

    def values(self, mu, std, y_max, noise_std):
        return jnp.exp(mu)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        return np.exp(mu)[..., None] * gmu


class ExponentialStd(Std):
    """exp(std) - 1 (gpry/acquisition_functions.py:688; unused upstream)."""

    def values(self, mu, std, y_max, noise_std):
        return jnp.where(jnp.isfinite(mu), jnp.expm1(std), -jnp.inf)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        return np.exp(std)[..., None] * gstd


class ExpectedImprovement(AcquisitionFunction):
    """Classic EI (gpry/acquisition_functions.py:758; unused upstream)."""

    def __init__(self, xi=0.01, fixed=True):
        self.xi = float(xi)
        self.fixed = fixed
        self._params = {"xi": self.xi}

    def values(self, mu, std, y_max, noise_std):
        from jax.scipy.stats import norm
        ok = (std > 0) & jnp.isfinite(mu)
        s = jnp.where(ok, std, 1.0)
        z = (mu - y_max - self.xi) / s
        ei = (mu - y_max - self.xi) * norm.cdf(z) + s * norm.pdf(z)
        return jnp.where(ok, ei, 0.0)

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        # dEI/dmu = Phi(z), dEI/dsigma = phi(z)  (standard EI gradient)
        from scipy.stats import norm
        ok = (std > 0) & np.isfinite(mu)
        s = np.where(ok, std, 1.0)
        z = (mu - y_max - self.xi) / s
        g = norm.cdf(z)[..., None] * gmu + norm.pdf(z)[..., None] * gstd
        return np.where(ok[..., None], g, 0.0)


# -- operators (API parity with gpry/acquisition_functions.py:1287-1449) -----


class _BinaryOp(AcquisitionFunction):
    def __init__(self, f1, f2):
        self.f1, self.f2 = f1, f2
        self._params = {}

    @property
    def hasgradient(self):
        return self.f1.hasgradient and self.f2.hasgradient


class Sum(_BinaryOp):
    def values(self, mu, std, y_max, noise_std):
        return (self.f1.values(mu, std, y_max, noise_std)
                + self.f2.values(mu, std, y_max, noise_std))

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        return (self.f1._gradient(mu, std, gmu, gstd, y_max, noise_std)
                + self.f2._gradient(mu, std, gmu, gstd, y_max, noise_std))


class Product(_BinaryOp):
    def values(self, mu, std, y_max, noise_std):
        return (self.f1.values(mu, std, y_max, noise_std)
                * self.f2.values(mu, std, y_max, noise_std))

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        v1 = np.asarray(self.f1.values(jnp.asarray(mu), jnp.asarray(std),
                                       y_max, noise_std))
        v2 = np.asarray(self.f2.values(jnp.asarray(mu), jnp.asarray(std),
                                       y_max, noise_std))
        g1 = self.f1._gradient(mu, std, gmu, gstd, y_max, noise_std)
        g2 = self.f2._gradient(mu, std, gmu, gstd, y_max, noise_std)
        return v2[..., None] * g1 + v1[..., None] * g2


class Exponentiation(AcquisitionFunction):
    def __init__(self, f, exponent):
        self.f, self.exponent = f, float(exponent)
        self._params = {"exponent": self.exponent}

    @property
    def hasgradient(self):
        # delegates like _BinaryOp: no gradient if the base has none
        return self.f.hasgradient

    def values(self, mu, std, y_max, noise_std):
        return self.f.values(mu, std, y_max, noise_std) ** self.exponent

    def _gradient(self, mu, std, gmu, gstd, y_max, noise_std):
        v = np.asarray(self.f.values(jnp.asarray(mu), jnp.asarray(std),
                                     y_max, noise_std))
        gf = self.f._gradient(mu, std, gmu, gstd, y_max, noise_std)
        return (self.exponent * v ** (self.exponent - 1.0))[..., None] * gf
