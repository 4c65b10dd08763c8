"""
Covariance (kernel) functions as pure JAX functions.

Unlike the reference's class hierarchy over scikit-learn kernels
(gpry/kernels.py:213-709), this build keeps kernels as *pure functions of
a log-hyperparameter vector theta*, so that hyperparameter gradients (for the
log-marginal-likelihood fit) and input-space gradients (for gradient-based
acquisition optimization) both come from ``jax.grad`` instead of hand-coded
formulas, and the covariance construction is a single fused XLA
computation.

theta layout (log space, matching sklearn's ``kernel_.theta`` convention for
``ConstantKernel() * {RBF|Matern}(length_scale=[...]*d)``):

    theta[0]   = log(output_scale**2)     (constant kernel variance)
    theta[1:]  = log(length_scale_i), i = 1..d   (anisotropic)

Supported families: "rbf", "matern12", "matern32", "matern52"
(reference builds C()*RBF or C()*Matern, gpry/gpr.py:328-363).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

KERNEL_FAMILIES = ("rbf", "matern12", "matern32", "matern52")


def make_theta(output_scale, length_scales):
    """Build a theta vector from natural-space scales."""
    output_scale = jnp.asarray(output_scale)
    length_scales = jnp.atleast_1d(jnp.asarray(length_scales))
    return jnp.concatenate(
        [jnp.log(output_scale**2)[None], jnp.log(length_scales)]
    )


def _scaled_sqdist(X1, X2, length_scales):
    """
    Pairwise squared distances of X1 (n,d) vs X2 (m,d) in units of the
    length scales, via direct differences: exact in any dtype, unlike
    the ||a||^2+||b||^2-2ab matmul expansion whose cancellation error is
    catastrophic in float32.  At this workload's d (<= ~20) a matmul would
    have a contraction of d only; XLA fuses the elementwise form into the
    reduction.
    """
    A = X1 / length_scales
    B = X2 / length_scales
    # Statically unrolled over d with 2-D ops only (the same flops as one
    # (n, m, d) broadcast, without materializing it).
    d = X1.shape[-1]
    sq = None
    for k in range(d):
        dk = A[..., k][..., :, None] - B[..., k][..., None, :]
        sq = dk * dk if sq is None else sq + dk * dk
    return sq


def _safe_sqrt(s):
    """sqrt with a zero-safe gradient at s = 0 (Matern kernels)."""
    safe = jnp.where(s > 0.0, s, 1.0)
    return jnp.where(s > 0.0, jnp.sqrt(safe), 0.0)


@partial(jax.jit, static_argnames=("family",))
def cross_kernel(family, theta, X1, X2):
    """
    Covariance matrix K(X1, X2) of shape (n, m).

    ``family`` is static: either a fast-path string ("rbf", "matern12",
    "matern32", "matern52" — meaning C() * <family> with ARD length
    scales, theta as in the module docstring) or a hashable *kernel spec*
    tuple covering the reference's full kernel library
    (gpry/kernels.py:213-702) — see :func:`spec_cross`.
    """
    if isinstance(family, tuple):
        return spec_cross(family, theta, X1, X2)
    variance = jnp.exp(theta[0])
    ls = jnp.exp(theta[1:])
    sq = _scaled_sqdist(X1, X2, ls)
    if family == "rbf":
        k = jnp.exp(-0.5 * sq)
    elif family == "matern12":
        r = _safe_sqrt(sq)
        k = jnp.exp(-r)
    elif family == "matern32":
        r = _safe_sqrt(3.0 * sq)
        k = (1.0 + r) * jnp.exp(-r)
    elif family == "matern52":
        r = _safe_sqrt(5.0 * sq)
        k = (1.0 + r + r * r / 3.0) * jnp.exp(-r)
    else:
        raise ValueError(f"Unknown kernel family '{family}'.")
    return variance * k


def kernel_diag(family, theta, X):
    """
    diag K(X, X) — the *same-point* covariance, which for WhiteKernel
    members differs from ``diagonal(cross_kernel(X, X))`` (sklearn
    semantics: ``kernel(X, Y)`` carries no white term, ``kernel.diag(X)``
    does).  Constant ``exp(theta[0])`` for the fast-path families.
    """
    if isinstance(family, tuple):
        return spec_diag(family, theta, X)
    return jnp.full(X.shape[:-1], jnp.exp(theta[0]), dtype=X.dtype)


# ---------------------------------------------------------------------------
# Kernel specs: the full reference kernel library as hashable expression
# trees (gpry/kernels.py:213-702 — RBF/Matern/RationalQuadratic/
# ExpSineSquared/DotProduct/White/Constant + Sum/Product/Exponentiation).
# ---------------------------------------------------------------------------
# A spec is a nested tuple (static under jit):
#
#   ("rbf", d) / ("matern12", d) / ("matern32", d) / ("matern52", d)
#       ARD stationary kernel, d log-length-scale params, unit variance
#   ("rq",)          RationalQuadratic: params [log alpha, log length_scale]
#   ("expsine",)     ExpSineSquared: params [log length_scale, log period]
#   ("dotproduct",)  DotProduct: params [log sigma_0]
#   ("white",)       WhiteKernel: params [log noise_level]
#   ("constant",)    ConstantKernel: params [log constant_value]
#   ("sum", a, b) / ("product", a, b)   operators, params concatenated
#   ("pow", a, p)    Exponentiation by the static float p
#
# theta packs depth-first (matching sklearn's composite-kernel theta), so
# e.g. C() * RBF(d) == ("product", ("constant",), ("rbf", d)) has the same
# theta layout as the fast-path string families.

_LEAF_NPARAMS = {"rq": 2, "expsine": 2, "dotproduct": 1, "white": 1,
                 "constant": 1}


def spec_n_params(spec):
    """Number of theta entries a spec consumes (depth-first layout)."""
    kind = spec[0]
    if kind in ("rbf", "matern12", "matern32", "matern52"):
        return int(spec[1])
    if kind in _LEAF_NPARAMS:
        return _LEAF_NPARAMS[kind]
    if kind in ("sum", "product"):
        return spec_n_params(spec[1]) + spec_n_params(spec[2])
    if kind == "pow":
        return spec_n_params(spec[1])
    raise ValueError(f"Unknown kernel spec node {spec!r}")


def spec_cross(spec, theta, X1, X2):
    """K(X1, X2) for a kernel spec (WhiteKernel contributes zero here,
    matching sklearn's ``kernel(X, Y)``; use :func:`spec_diag` for the
    same-point variance)."""
    kind = spec[0]
    dt = X1.dtype
    shape = (X1.shape[0], X2.shape[0])
    if kind in ("rbf", "matern12", "matern32", "matern52"):
        ls = jnp.exp(theta)
        sq = _scaled_sqdist(X1, X2, ls)
        if kind == "rbf":
            return jnp.exp(-0.5 * sq)
        if kind == "matern12":
            r = _safe_sqrt(sq)
            return jnp.exp(-r)
        if kind == "matern32":
            r = _safe_sqrt(3.0 * sq)
            return (1.0 + r) * jnp.exp(-r)
        r = _safe_sqrt(5.0 * sq)
        return (1.0 + r + r * r / 3.0) * jnp.exp(-r)
    if kind == "rq":
        alpha = jnp.exp(theta[0])
        ls = jnp.exp(theta[1])
        sq = _scaled_sqdist(X1, X2, ls)     # already in units of ls
        return (1.0 + sq / (2.0 * alpha)) ** (-alpha)
    if kind == "expsine":
        ls = jnp.exp(theta[0])
        period = jnp.exp(theta[1])
        r = _safe_sqrt(_scaled_sqdist(X1, X2, jnp.ones((), dt)))
        s = jnp.sin(jnp.pi * r / period) / ls
        return jnp.exp(-2.0 * s * s)
    if kind == "dotproduct":
        s0 = jnp.exp(theta[0])
        return s0 * s0 + X1 @ X2.T
    if kind == "white":
        return jnp.zeros(shape, dt)
    if kind == "constant":
        return jnp.full(shape, jnp.exp(theta[0]), dt)
    if kind in ("sum", "product"):
        n1 = spec_n_params(spec[1])
        k1 = spec_cross(spec[1], theta[:n1], X1, X2)
        k2 = spec_cross(spec[2], theta[n1:], X1, X2)
        return k1 + k2 if kind == "sum" else k1 * k2
    if kind == "pow":
        return spec_cross(spec[1], theta, X1, X2) ** spec[2]
    raise ValueError(f"Unknown kernel spec node {spec!r}")


def spec_diag(spec, theta, X):
    """Same-point variance diag K(X, X) for a kernel spec (includes the
    WhiteKernel term, matching sklearn's ``kernel.diag``)."""
    kind = spec[0]
    dt = X.dtype
    n = X.shape[0]
    if kind in ("rbf", "matern12", "matern32", "matern52", "rq", "expsine"):
        return jnp.ones((n,), dt)
    if kind == "dotproduct":
        s0 = jnp.exp(theta[0])
        return s0 * s0 + jnp.sum(X * X, axis=-1)
    if kind == "white":
        return jnp.full((n,), jnp.exp(theta[0]), dt)
    if kind == "constant":
        return jnp.full((n,), jnp.exp(theta[0]), dt)
    if kind in ("sum", "product"):
        n1 = spec_n_params(spec[1])
        d1 = spec_diag(spec[1], theta[:n1], X)
        d2 = spec_diag(spec[2], theta[n1:], X)
        return d1 + d2 if kind == "sum" else d1 * d2
    if kind == "pow":
        return spec_diag(spec[1], theta, X) ** spec[2]
    raise ValueError(f"Unknown kernel spec node {spec!r}")


# -- spec construction DSL ---------------------------------------------------

_DEFAULT_BOUNDS = (1e-5, 1e5)


def _leaf(node, nparams, values, bounds_list):
    """Helper returning (spec_node, theta0 (log), bounds (log))."""
    theta0 = [float(np.log(v)) for v in values]
    bounds = [(float(np.log(lo)), float(np.log(hi)))
              for (lo, hi) in bounds_list]
    assert len(theta0) == nparams and len(bounds) == nparams
    return node, theta0, bounds


def build_kernel_spec(obj, d):
    """
    Build ``(spec, theta0, theta_bounds)`` from a declarative kernel
    description: a single-key dict ``{Name: {kwargs}}`` with sklearn-style
    names/arguments (RBF, Matern(nu), RationalQuadratic, ExpSineSquared,
    DotProduct, WhiteKernel, ConstantKernel) and operators
    ``{"Sum"|"Product": [k1, k2]}``, ``{"Exponentiation": {"kernel": k,
    "exponent": p}}``.  theta0 / bounds are in log space, depth-first,
    matching sklearn composite-kernel theta layout.
    """
    if isinstance(obj, str):
        obj = {obj: {}}
    if not (isinstance(obj, dict) and len(obj) == 1):
        raise ValueError(f"Cannot build a kernel spec from {obj!r}")
    name = list(obj)[0]
    kw = dict(obj[name] or {}) if isinstance(obj[name], dict) else obj[name]
    lname = name.lower()

    def get_val(key, default):
        return kw.get(key, default) if isinstance(kw, dict) else default

    def get_bounds(key):
        b = kw.get(key, _DEFAULT_BOUNDS) if isinstance(kw, dict) \
            else _DEFAULT_BOUNDS
        return tuple(b)

    if lname in ("rbf", "matern", "matern12", "matern32", "matern52"):
        if lname == "matern":
            nu = float(get_val("nu", 1.5))
            try:
                fam = {0.5: "matern12", 1.5: "matern32",
                       2.5: "matern52"}[nu]
            except KeyError as excpt:
                raise ValueError(
                    "Matern nu must be one of 0.5, 1.5, 2.5.") from excpt
        else:
            fam = lname
        ls = get_val("length_scale", 1.0)
        ls = [float(ls)] * d if np.isscalar(ls) else [float(v) for v in ls]
        if len(ls) != d:
            raise ValueError(f"length_scale needs {d} entries, got {len(ls)}")
        b = get_bounds("length_scale_bounds")
        return _leaf((fam, d), d, ls, [b] * d)
    if lname == "rationalquadratic":
        return _leaf(("rq",), 2,
                     [float(get_val("alpha", 1.0)),
                      float(get_val("length_scale", 1.0))],
                     [get_bounds("alpha_bounds"),
                      get_bounds("length_scale_bounds")])
    if lname == "expsinesquared":
        return _leaf(("expsine",), 2,
                     [float(get_val("length_scale", 1.0)),
                      float(get_val("periodicity", 1.0))],
                     [get_bounds("length_scale_bounds"),
                      get_bounds("periodicity_bounds")])
    if lname == "dotproduct":
        return _leaf(("dotproduct",), 1, [float(get_val("sigma_0", 1.0))],
                     [get_bounds("sigma_0_bounds")])
    if lname == "whitekernel":
        return _leaf(("white",), 1, [float(get_val("noise_level", 1.0))],
                     [get_bounds("noise_level_bounds")])
    if lname == "constantkernel":
        return _leaf(("constant",), 1,
                     [float(get_val("constant_value", 1.0))],
                     [get_bounds("constant_value_bounds")])
    if lname in ("sum", "product"):
        if not (isinstance(kw, (list, tuple)) and len(kw) == 2):
            raise ValueError(f"{name} takes a list of two kernels.")
        s1, t1, b1 = build_kernel_spec(kw[0], d)
        s2, t2, b2 = build_kernel_spec(kw[1], d)
        return (lname, s1, s2), t1 + t2, b1 + b2
    if lname == "exponentiation":
        s1, t1, b1 = build_kernel_spec(kw["kernel"], d)
        return ("pow", s1, float(kw["exponent"])), t1, b1
    raise ValueError(f"Unknown kernel '{name}'")


def theta_bounds_dynamic(theta, d, prior_widths=None, dynamic=False,
                         output_scale_prior=(1e-2, 1e3),
                         length_scale_prior=(1e-3, 1e1)):
    """
    Log-space optimization bounds for theta, matching the reference's bound
    policy (gpry/kernels.py:157-191, gpry/gpr.py:328-363):

    * the constant kernel keeps static bounds ``output_scale_prior**2``
      (it parametrizes the variance);
    * with ``dynamic=False`` (the reference's default auto-built kernel),
      each length scale gets the static ``length_scale_prior`` bounds (in
      preprocessed coordinates);
    * with ``dynamic=True``, each length scale gets
      ``[w * 1e-3, w * 100]`` where ``w`` is that dimension's prior width
      (``max_length``), or the current value if no width is known.

    Returns an array of shape (1 + d, 2) of *log-space* bounds.
    """
    theta = np.asarray(theta)
    bounds = [[np.log(output_scale_prior[0] ** 2),
               np.log(output_scale_prior[1] ** 2)]]
    for i in range(d):
        if dynamic:
            if prior_widths is not None:
                ref = float(prior_widths[i])
            else:
                ref = float(np.exp(theta[1 + i]))
            bounds.append([np.log(ref * 1e-3), np.log(ref * 100.0)])
        else:
            bounds.append([np.log(length_scale_prior[0]),
                           np.log(length_scale_prior[1])])
    return np.array(bounds)
