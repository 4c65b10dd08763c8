"""
The smoke checks of chip_smoke.py at small size, on an NVIDIA GPU.

Skipped without a GPU.  On a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_canonical_drive_on_gpu(gpu):
    """d=2 GP + nested MC: mean and logZ against the analytic truth."""
    import chip_smoke

    chip_smoke.phase_canonical()


def test_reference_comparison_on_gpu(gpu):
    """Fit, predict and LML against the NumPy/SciPy float64 reference, and
    one NORA batch, at d=8 and N=256."""
    import chip_smoke

    chip_smoke.phase_reference(d=8, n=256, n_query=1024)
