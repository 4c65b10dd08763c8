"""
gpry_tpu — accelerator-native active-learning Bayesian inference of
expensive likelihoods (a from-scratch JAX/XLA rebuild of the capabilities of
GPry, jonaselgammal/GPry v3.0.0).
"""

__version__ = "0.1.0"

# Importing config first sets the x64 flag before any jax.numpy use.
from gpry_tpu import config  # noqa: F401


def check_cobaya_installed():
    """Whether Cobaya can be imported (reference: gpry/__init__.py)."""
    try:
        import cobaya  # noqa: F401
    except ModuleNotFoundError:
        return False
    return True


def get_cobaya_class():
    """The Cobaya sampler wrapper class (reference: gpry/__init__.py)."""
    from gpry_tpu.cobaya import CobayaWrapper
    return CobayaWrapper


def __getattr__(name):
    # Lazy top-level exports (keep `import gpry_tpu` light).
    if name == "Runner":
        from gpry_tpu.run import Runner
        return Runner
    if name == "GaussianProcessRegressor":
        from gpry_tpu.models.gp import GaussianProcessRegressor
        return GaussianProcessRegressor
    if name == "Truth":
        from gpry_tpu.truth import Truth
        return Truth
    if name == "CobayaWrapper":
        from gpry_tpu.cobaya import CobayaWrapper
        return CobayaWrapper
    if name == "run_resilient":
        from gpry_tpu.run import run_resilient
        return run_resilient
    raise AttributeError(f"module 'gpry_tpu' has no attribute '{name}'")
