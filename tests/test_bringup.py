"""
Device and environment policy: float64 everywhere unless float32 is asked
for, the compile cache placed from outside, imports the main path needs,
no fallback that hides a failed build or a missing GPU, one process per
card, and device-memory budgets read from the device.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpry_tpu import config
from gpry_tpu.models import GaussianProcessRegressor
from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra=None, env_drop=()):
    """Run ``code`` in a fresh interpreter at the repo root; its stdout."""
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT},
               **(env_extra or {}))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip()


def _gpr(rng, n=30, d=2):
    bounds = np.array([[-1.0, 1.0]] * d)
    X = rng.uniform(-1, 1, size=(n, d))
    y = -np.sum((X / 0.4) ** 2, axis=1)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=4,
        random_state=0)
    gpr.append_to_data(X, y)
    return gpr


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

_CACHE_DIR = "import jax, gpry_tpu; print(jax.config.jax_compilation_cache_dir)"


def test_cache_dir_from_environment_is_left_alone(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it; the code sets none."""
    code = ("import jax\n"
            "calls = []\n"
            "orig = jax.config.update\n"
            "jax.config.update = lambda k, v: (calls.append(k), orig(k, v))\n"
            "import gpry_tpu\n"
            "print(jax.config.jax_compilation_cache_dir,"
            " 'jax_compilation_cache_dir' in calls)")
    out = _python(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out == f"{tmp_path} False"


def test_cache_dir_default_is_fixed_inside_the_checkout():
    """Unset: one fixed path inside the checkout, the same in every
    process (the directory is part of the cache key)."""
    first = _python(_CACHE_DIR, env_drop=("JAX_COMPILATION_CACHE_DIR",))
    second = _python(_CACHE_DIR, env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert first == second == os.path.join(ROOT, ".jax_cache")
    assert config.DEFAULT_COMP_CACHE_DIR == os.path.join(ROOT, ".jax_cache")


def test_import_spawns_no_subprocess():
    # third-party modules that probe the CPU with a subprocess at import
    # are imported first; what is left is this package's own
    code = ("import subprocess, numpy.testing, scipy.linalg, jax\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('subprocess at import')\n"
            "subprocess.Popen = refuse\n"
            "import gpry_tpu, gpry_tpu.run\n"
            "print('ok')")
    assert _python(code) == "ok"


def test_comp_cache_dir_reports_the_switch():
    """The test suite runs with the persistent cache off (conftest)."""
    assert config.comp_cache_dir() is None
    jax.config.update("jax_enable_compilation_cache", True)
    try:
        assert config.comp_cache_dir() == \
            jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_enable_compilation_cache", False)


# ---------------------------------------------------------------------------
# float64 on every device unless float32 is asked for
# ---------------------------------------------------------------------------

def test_matmul_precision_is_highest():
    """No float32 product runs in TF32 on a GPU."""
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.mark.parametrize("mode, expect", [
    ("auto", "fit"), ("float64", "fit"), ("fit", "fit"),
    ("float32", "float32")])
def test_sweep_dtype_modes(rng, monkeypatch, mode, expect):
    gpr = _gpr(rng)
    monkeypatch.setattr(config, "SWEEP_DTYPE", mode)
    want = gpr._dtype if expect == "fit" else jnp.float32
    assert gpr.sweep_dtype() == want
    assert gpr.sweep_params().X.dtype == want


@pytest.mark.parametrize("mode, corrected", [
    ("0", False), ("1", False), ("off", False), ("force", True)])
def test_ns_proposal_params_fit_dtype_unless_forced(rng, monkeypatch, mode,
                                                    corrected):
    from gpry_tpu.models.gp import ns_proposal_params

    gpr = _gpr(rng)
    monkeypatch.setattr(config, "NS_PROPOSAL_F32", mode)
    p_ns, corr = ns_proposal_params(gpr.surrogate_params(), err_est=0.0)
    assert corr is corrected
    assert p_ns.X.dtype == (jnp.float32 if corrected else gpr._dtype)


def test_fit_runs_one_rung_on_the_data_device(rng, monkeypatch):
    """The hyperparameter search is one call in the fit dtype, on the
    device that holds the training data: no float32 rung, no move to a
    second device."""
    from gpry_tpu.parallel import mesh as mesh_mod

    gpr = _gpr(rng)
    calls = []
    orig = mesh_mod.fit_theta_restarts_maybe_sharded

    def spy(family, X, y, n, noise_var, theta0s, lo, hi, **kw):
        calls.append(({d for a in (X, y, theta0s, lo, hi)
                       for d in a.devices()}, theta0s.dtype, kw))
        return orig(family, X, y, n, noise_var, theta0s, lo, hi, **kw)

    monkeypatch.setattr(mesh_mod, "fit_theta_restarts_maybe_sharded", spy)
    put = []
    monkeypatch.setattr(jax, "device_put",
                        lambda *a, **k: put.append(a) or a[0])
    gpr.fit_gpr_hyperparameters()
    assert len(calls) == 1
    devices, dtype, kw = calls[0]
    assert devices == set(gpr._dX.devices())
    assert dtype == gpr._dtype
    assert put == []


def test_fit_screen_in_fit_dtype(rng, monkeypatch):
    """The batched LML screen prices candidates in the fit dtype."""
    from gpry_tpu.models import gp as gp_mod

    gpr = _gpr(rng)
    seen = []
    orig = gp_mod._lml_batch

    def spy(family, X, y, n, noise_var, thetas):
        seen.append((X.dtype, thetas.dtype))
        return orig(family, X, y, n, noise_var, thetas)

    monkeypatch.setattr(gp_mod, "_lml_batch", spy)
    gpr.fit_gpr_hyperparameters()
    assert seen and all(s == (gpr._dtype, gpr._dtype) for s in seen)


# ---------------------------------------------------------------------------
# device-memory budget of the LML screen
# ---------------------------------------------------------------------------

class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class _FakeArray:
    def __init__(self, stats):
        self._dev = _FakeDevice(stats)

    def devices(self):
        return {self._dev}


@pytest.mark.parametrize("bytes_limit", [16 * 2**30, 60 * 2**30])
def test_lml_screen_budget_follows_bytes_limit(bytes_limit):
    from gpry_tpu.models.gp import lml_screen_budget_bytes

    x = _FakeArray({"bytes_limit": bytes_limit, "bytes_in_use": 0})
    assert lml_screen_budget_bytes(x) == bytes_limit / 4


def test_lml_screen_budget_fixed_without_memory_stats(monkeypatch):
    from gpry_tpu.models.gp import lml_screen_budget_bytes

    monkeypatch.delenv("GPRY_TPU_LML_SCREEN_MEM_GB", raising=False)
    assert lml_screen_budget_bytes(_FakeArray(None)) == 4 * 2**30
    cpu_array = jnp.zeros(3)
    assert lml_screen_budget_bytes(cpu_array) == 4 * 2**30


# ---------------------------------------------------------------------------
# imports of the main path
# ---------------------------------------------------------------------------

def test_main_path_imports_no_optional_packages():
    code = ("import sys, gpry_tpu.run\n"
            "print(sorted(m for m in ('pandas', 'dill', 'sklearn')"
            " if m in sys.modules))")
    assert _python(code) == "[]"


def test_main_path_imports_with_optional_packages_unimportable():
    code = ("import sys\n"
            "for m in ('pandas', 'dill', 'sklearn'):\n"
            "    sys.modules[m] = None\n"
            "import gpry_tpu.run\n"
            "from gpry_tpu.progress import Progress\n"
            "p = Progress(); p.add_iteration(); p.add_current_n_truth(3, 2)\n"
            "print(p.column('n_total')[0])")
    assert _python(code) == "3.0"


def test_checkpoint_pickles_without_dill_and_falls_back_for_lambdas(
        monkeypatch):
    import pickle

    from gpry_tpu import io as gio

    data = {"a": np.arange(3)}
    assert pickle.loads(gio._dumps(data))["a"].tolist() == [0, 1, 2]
    lam = pickle.loads(gio._dumps({"loglike": lambda x: 2 * x}))
    assert lam["loglike"](3) == 6
    monkeypatch.setitem(sys.modules, "dill", None)
    with pytest.raises(ImportError, match="dill"):
        gio._dumps(lambda x: x)
    assert pickle.loads(gio._dumps(data))["a"].tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# no fallback that hides a failure
# ---------------------------------------------------------------------------

def test_failed_native_build_raises_from_svm_fit(tmp_path, monkeypatch):
    from gpry_tpu import native
    from gpry_tpu.models.classifier import SVM

    bad = tmp_path / "svc_smo.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "libsvc_smo.so"))
    X = np.random.default_rng(0).uniform(size=(20, 2))
    y = np.where(X[:, 0] > 0.5, -np.inf, -np.sum(X ** 2, axis=1))
    with pytest.raises(native.NativeBuildError, match="command: g\\+\\+"):
        SVM().fit(X, y, diff_threshold=1.0)


def test_require_gpu_refuses_the_cpu():
    from gpry_tpu.utils.device import device_info, require_gpu

    with pytest.raises(RuntimeError, match="No GPU"):
        require_gpu()
    assert device_info()["platform"] == "cpu"


def test_chip_smoke_exits_nonzero_without_gpu():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ,
                                               JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# one process per card
# ---------------------------------------------------------------------------

def test_process_pool_spawns_cpu_only_workers(monkeypatch):
    from gpry_tpu.parallel.executor import TruthExecutor

    class _T:
        @staticmethod
        def logp(x):
            return float(np.sum(x))

    # a parent that would hand its accelerator platform down
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    ex = TruthExecutor(_T(), mode="processes", max_workers=1)
    try:
        assert ex._pool._mp_context.get_start_method() == "spawn"
        assert ex._pool.submit(os.getenv, "JAX_PLATFORMS").result(
            timeout=240) == "cpu"
    finally:
        ex.shutdown()


# ---------------------------------------------------------------------------
# the smoke script's plain reference
# ---------------------------------------------------------------------------

def test_chip_smoke_reference_matches_the_gp(rng):
    """chip_smoke's NumPy/SciPy reference reproduces the package's float64
    prediction and LML on a well-conditioned fit."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    # an oscillating target keeps the length-scales short and K
    # well-conditioned (a quadratic drives them to the polynomial regime)
    bounds = np.array([[-1.0, 1.0]] * 3)
    X = rng.uniform(-1, 1, size=(40, 3))
    y = np.sum(np.sin(4 * X), axis=1)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=4,
        random_state=0)
    gpr.append_to_data(X, y)
    Xq = rng.uniform(-1, 1, size=(64, 3))
    mean_r, var_r, prior_var, lml_r = chip_smoke.reference_prediction(
        gpr, Xq)
    mean, std = gpr.predict(Xq, return_std=True)
    np.testing.assert_allclose(mean, mean_r, rtol=0, atol=1e-8 * np.max(
        np.abs(gpr.y_train)))
    np.testing.assert_allclose(std ** 2, var_r, rtol=0, atol=1e-6 * prior_var)
    np.testing.assert_allclose(gpr.log_marginal_likelihood(), lml_r,
                               rtol=1e-8)
