"""
Global numerical configuration for gpry_tpu.

Precision policy
----------------
GP surrogate modelling of log-posteriors is numerically delicate: the kernel
matrix can reach condition numbers ~1e6-1e8 even with the reference's default
diagonal noise (``noise_level=1e-2`` on standardized y, cf. reference
``gpry/gpr.py:265``).  float32 Cholesky loses most significant digits there,
so the fit, the factorization and every prediction sweep run in float64,
which CPUs and NVIDIA GPUs execute natively.

``gpry_tpu`` therefore enables ``jax_enable_x64`` at import time (disable by
setting the environment variable ``GPRY_TPU_X64=0`` *before* importing) and
exposes per-component dtype knobs.
"""

import os

import jax

_X64 = os.environ.get("GPRY_TPU_X64", "1") not in ("0", "false", "False")
if _X64:
    jax.config.update("jax_enable_x64", True)

# float32 matrix products at full float32 precision.  On NVIDIA GPUs XLA
# otherwise runs them in TF32 (10-bit mantissa), an error that the float32
# sweep bound (GaussianProcessRegressor.f32_sweep_error_estimate) does not
# account for.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# where it is unset, the cache goes to one fixed directory inside the
# checkout, so that every process of this checkout finds it again (the
# directory is part of the cache key).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_COMP_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMP_CACHE_DIR)


def comp_cache_dir():
    """Directory of the persistent compilation cache, or None when the
    cache is switched off."""
    if not jax.config.jax_enable_compilation_cache:
        return None
    return jax.config.jax_compilation_cache_dir


import jax.numpy as jnp  # noqa: E402  (after x64 flag)

#: dtype used for GP state, Cholesky factorization and LML optimization.
FIT_DTYPE = jnp.float64 if _X64 else jnp.float32

#: Dtype policy for large batched prediction sweeps (acquisition ranking,
#: NS, ranked-pool conditioning): "auto" (default) and "float64"/"fit" run
#: them in the fit dtype; "float32" must be asked for.  GP interpolants of
#: log-posteriors are intrinsically ill-conditioned: the float32 sweep error
#: is ~eps32 * k_max * sum|alpha| * y_scale raw nats (measured: 0.3-3.6
#: nats on representative problems — enough to break acquisition and
#: convergence).  Override via GPRY_TPU_SWEEP_DTYPE.
SWEEP_DTYPE = os.environ.get("GPRY_TPU_SWEEP_DTYPE", "auto")

#: Importance-corrected float32 NS proposals: the nested-sampling loop can
#: run float32 — it only *proposes* sample locations — with the final
#: sample re-scored by ONE batched float64 sweep and the density difference
#: folded into the weights (the same reweighting mechanism the engine
#: already uses to reuse samples across GP updates, reference
#: gpry/gp_acquisition.py:875-919).  "force": on; anything else (default
#: "0"): off, the NS runs in the sweep dtype.
NS_PROPOSAL_F32 = os.environ.get("GPRY_TPU_NS_PROPOSAL_F32", "0")
#: max estimated f32 sweep error (raw nats) for which the f32-proposal NS
#: is still used: beyond this the f32 surface is distorted enough that the
#: proposal misplaces its mass and the importance correction collapses the
#: effective sample size (measured: est ~3 nats -> biased moments even
#: after correction; est ~0.4 -> indistinguishable from f64).
NS_PROPOSAL_F32_TOL = float(os.environ.get("GPRY_TPU_NS_PROPOSAL_F32_TOL",
                                           "1.0"))


def x64_enabled():
    """Whether the package runs in float64 mode."""
    return _X64


# ---------------------------------------------------------------------------
# Padded-buffer bucketing
# ---------------------------------------------------------------------------
# The training set grows every iteration.  To keep every jitted function
# compiled once per *bucket* instead of once per size, padded buffer sizes
# are rounded up to the next bucket boundary.  Buckets are multiples of 64
# that grow geometrically (x1.5).

_MIN_BUCKET = 64


def bucket_size(n: int) -> int:
    """Smallest padded buffer size >= ``n`` from the bucket ladder."""
    b = _MIN_BUCKET
    while b < n:
        # grow by 1.5x, rounded up to a multiple of 64
        b = ((int(b * 1.5) + 63) // 64) * 64
    return b
