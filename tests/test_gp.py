"""
GP surrogate tests: golden-value parity with scikit-learn / the reference
implementation on shared training sets, plus incremental-append consistency.
"""

import numpy as np
import pytest

from gpry_tpu.models.gp import GaussianProcessRegressor
from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y


def make_gpr(bounds, **kw):
    kw.setdefault("preprocessing_X", Normalize_bounds(bounds))
    kw.setdefault("preprocessing_y", Normalize_y())
    kw.setdefault("n_restarts_optimizer", 8)
    kw.setdefault("random_state", 7)
    return GaussianProcessRegressor(bounds=bounds, **kw)


def logp_gauss(X, mean, cov_inv):
    diff = np.atleast_2d(X) - mean
    return -0.5 * np.einsum("ij,jk,ik->i", diff, cov_inv, diff)


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_predict_matches_sklearn_fixed_theta(kernel, rng):
    """With fixed hyperparameters, predictions must equal sklearn's GPR."""
    d = 3
    bounds = np.array([[-1.0, 2.0]] * d)
    X = rng.uniform(-1, 2, size=(25, d))
    cov_inv = np.linalg.inv(np.diag([0.5, 1.0, 2.0]))
    y = logp_gauss(X, np.array([0.5, 0.5, 0.5]), cov_inv)

    gpr = make_gpr(bounds, kernel=kernel, account_for_inf=False,
                   clip_factor=None)
    gpr.append_to_data(X, y, fit_gpr=False)

    from sklearn.gaussian_process import GaussianProcessRegressor as SKGPR
    from sklearn.gaussian_process.kernels import RBF, ConstantKernel, Matern
    theta = gpr.kernel_theta
    out_var = np.exp(theta[0])
    ls = np.exp(theta[1:])
    k = ConstantKernel(out_var) * (
        RBF(ls) if kernel == "RBF" else Matern(ls, nu=1.5))
    X_ = gpr.preprocessing_X.transform(X)
    y_ = gpr.preprocessing_y.transform(y)
    sk = SKGPR(kernel=k, alpha=gpr._transformed_noise_var(),
               optimizer=None).fit(X_, y_)

    Xq = rng.uniform(-1, 2, size=(40, d))
    mean, std = gpr.predict(Xq, return_std=True)
    m_, s_ = sk.predict(gpr.preprocessing_X.transform(Xq), return_std=True)
    m_ref = gpr.preprocessing_y.inverse_transform(m_)
    s_ref = gpr.preprocessing_y.inverse_transform_scale(s_)
    assert np.allclose(mean, m_ref, atol=1e-8)
    assert np.allclose(std, s_ref, atol=1e-8)


def test_fit_improves_lml(rng):
    d = 2
    bounds = np.array([[-3.0, 3.0]] * d)
    X = rng.uniform(-3, 3, size=(30, d))
    y = logp_gauss(X, np.zeros(d), np.eye(d))
    gpr = make_gpr(bounds)
    gpr.append_to_data(X, y, fit_gpr=False)
    lml_before = gpr.log_marginal_likelihood()
    gpr.fit_gpr_hyperparameters(n_restarts=8)
    assert gpr.fitted
    assert gpr.log_marginal_likelihood_value_ >= lml_before - 1e-6


def test_fit_matches_sklearn_optimum(rng):
    """Our multistart LBFGS should find an LML >= sklearn's optimum."""
    d = 2
    bounds = np.array([[-3.0, 3.0]] * d)
    X = rng.uniform(-3, 3, size=(40, d))
    y = logp_gauss(X, np.zeros(d), np.eye(d)) + 0.01 * rng.normal(size=40)
    gpr = make_gpr(bounds, account_for_inf=False)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 10})

    from sklearn.gaussian_process import GaussianProcessRegressor as SKGPR
    from sklearn.gaussian_process.kernels import RBF, ConstantKernel
    X_ = gpr.preprocessing_X.transform(X)
    y_ = gpr.preprocessing_y.transform(y)
    k = ConstantKernel(1.0, (1e-4, 1e6)) * RBF([0.1] * d, (1e-3, 1e1))
    sk = SKGPR(kernel=k, alpha=gpr._transformed_noise_var(),
               n_restarts_optimizer=10).fit(X_, y_)
    lml_sk = sk.log_marginal_likelihood(sk.kernel_.theta)
    assert gpr.log_marginal_likelihood_value_ >= lml_sk - 0.1


def test_incremental_append_matches_refactorization(rng):
    d = 2
    bounds = np.array([[0.0, 1.0]] * d)
    X = rng.uniform(size=(20, d))
    y = logp_gauss(X, 0.5 * np.ones(d), 25 * np.eye(d))
    gpr = make_gpr(bounds)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 4})
    Xq = rng.uniform(size=(15, d))

    # Kriging-believer-style lie appends (no refits).
    X_new = rng.uniform(size=(3, d))
    y_new = gpr.predict(X_new)
    gpr.append_to_data(X_new, y_new, fit_gpr=False, fit_classifier=False)
    mean_fast, std_fast = gpr.predict(Xq, return_std=True)

    gpr2 = make_gpr(bounds)
    gpr2.append_to_data(np.vstack([X, X_new]), np.append(y, y_new),
                        fit_gpr=False)
    gpr2._theta = gpr._theta.copy()
    gpr2.preprocessing_y.mean_ = gpr.preprocessing_y.mean_
    gpr2.preprocessing_y.std_ = gpr.preprocessing_y.std_
    # refit transforms with shared preprocessor state
    gpr2.X_train = np.vstack([X, X_new])
    gpr2.y_train = np.append(y, y_new)
    gpr2._update_model()
    mean_full, std_full = gpr2.predict(Xq, return_std=True)
    assert np.allclose(mean_fast, mean_full, atol=1e-7)
    assert np.allclose(std_fast, std_full, atol=1e-7)


def test_svm_gates_infinities(rng):
    """Points below the threshold train the classifier, not the GP, and
    predictions there return -inf (reference: gpry/gpr.py:1136-1174)."""
    d = 2
    bounds = np.array([[-5.0, 5.0]] * d)
    X = rng.uniform(-5, 5, size=(60, d))
    y = logp_gauss(X, np.zeros(d), np.eye(d) * 4)
    y[np.linalg.norm(X, axis=1) > 3.0] = -np.inf
    gpr = make_gpr(bounds, account_for_inf="SVM", inf_threshold="20s")
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 4})
    assert gpr.n < len(y)
    assert gpr.n_total == len(y)
    # Far-out point should be classified infinite
    mean, std = gpr.predict(np.array([[4.9, 4.9]]), return_std=True)
    assert mean[0] == -np.inf and std[0] == 0.0
    # Near the mode: finite and accurate-ish
    mean = gpr.predict(np.array([[0.1, 0.0]]))
    assert np.isfinite(mean[0])


def test_y_max_and_clipping(rng):
    d = 1
    bounds = np.array([[0.0, 1.0]])
    X = np.linspace(0.1, 0.9, 12)[:, None]
    y = -10 * (X[:, 0] - 0.5) ** 2
    gpr = make_gpr(bounds, clip_factor=1.1)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 4})
    assert np.isclose(gpr.y_max, y.max())
    mean = gpr.predict(np.linspace(0, 1, 101)[:, None])
    clip = 1.1 * y.max() - 0.1 * y.min()
    assert np.all(mean <= clip + 1e-9)


def test_per_point_noise(rng):
    """Per-append noise arrays (reference: gpry/gpr.py:625-684): noisy
    points should pull the posterior mean less than exact ones."""
    d = 1
    bounds = np.array([[0.0, 1.0]])
    X = np.linspace(0.05, 0.95, 10)[:, None]
    y = np.sin(6 * X[:, 0])
    gpr = make_gpr(bounds, account_for_inf=False)
    gpr.append_to_data(X, y, fit_gpr=False)
    # one additional very noisy outlier at the center
    gpr_noisy = make_gpr(bounds, account_for_inf=False)
    gpr_noisy.append_to_data(X, y, fit_gpr=False)
    gpr_exact = make_gpr(bounds, account_for_inf=False)
    gpr_exact.append_to_data(X, y, fit_gpr=False)
    x_new, y_out = np.array([[0.5]]), np.array([5.0])
    gpr_noisy.append_to_data(x_new, y_out, noise_level=np.array([3.0]),
                             fit_gpr=False)
    gpr_exact.append_to_data(x_new, y_out, fit_gpr=False)
    m_noisy = gpr_noisy.predict(x_new)[0]
    m_exact = gpr_exact.predict(x_new)[0]
    base = gpr.predict(x_new)[0]
    # the exact append interpolates the outlier; the noisy one shrinks to it
    assert abs(m_exact - 5.0) < abs(m_noisy - 5.0)
    assert abs(m_noisy - base) < abs(m_exact - base) + 1.0
    # incremental append with vector noise == full refactorization
    from gpry_tpu.ops.linalg import factorize
    import jax.numpy as jnp
    nv = gpr_noisy._noise_var_
    assert np.ndim(nv) == 1
    Lf, af = factorize(gpr_noisy.family,
                       jnp.asarray(gpr_noisy._theta, gpr_noisy._dtype),
                       gpr_noisy._dX, gpr_noisy._dy, gpr_noisy.n,
                       jnp.asarray(nv, gpr_noisy._dtype))
    assert np.allclose(np.asarray(gpr_noisy._dalpha), np.asarray(af),
                       atol=1e-8)


def test_grad_predictions(rng):
    # Fixed moderate hyperparameters: with a fitted (very confident) GP,
    # sigma ~ 1e-3 and finite differences of sigma drown in the linear-solve
    # noise floor, so FD validation needs sigma = O(1).
    d = 2
    bounds = np.array([[0.0, 1.0]] * d)
    X = rng.uniform(size=(20, d))
    y = logp_gauss(X, 0.5 * np.ones(d), 25 * np.eye(d))
    gpr = make_gpr(bounds)
    gpr.append_to_data(X, y, fit_gpr=False)
    Xq = rng.uniform(0.2, 0.8, size=(5, d))
    mean, std, gmean, gstd = gpr.predict(
        Xq, return_std=True, return_mean_grad=True, return_std_grad=True)
    # central finite-difference check (the GP has short length scales, so
    # one-sided differences carry O(eps * f'') truncation error)
    eps = 1e-5
    for j in range(d):
        Xp, Xm = Xq.copy(), Xq.copy()
        Xp[:, j] += eps
        Xm[:, j] -= eps
        mp, sp = gpr.predict(Xp, return_std=True)
        mm, sm = gpr.predict(Xm, return_std=True)
        assert np.allclose((mp - mm) / (2 * eps), gmean[:, j],
                           rtol=1e-4, atol=1e-6)
        # sigma can be tiny where the GP is confident, making its FD noisy:
        # compare with a tolerance scaled to sigma's magnitude
        assert np.allclose((sp - sm) / (2 * eps), gstd[:, j],
                           rtol=5e-2, atol=1e-3 * max(1e-3, std.max()))


def test_predict_return_cov(rng):
    """predict(return_cov=True) matches sklearn's posterior covariance
    (reference: gpry/gpr.py:1022 return_cov)."""
    from sklearn.gaussian_process import GaussianProcessRegressor as SkGPR
    from sklearn.gaussian_process.kernels import RBF, ConstantKernel

    d, n = 2, 25
    bounds = np.array([[0.0, 1.0]] * d)
    X = rng.uniform(size=(n, d))
    y = np.sin(4 * X[:, 0]) + X[:, 1] ** 2
    sk = SkGPR(kernel=ConstantKernel(1.5) * RBF([0.3, 0.4]), alpha=1e-4,
               optimizer=None).fit(X, y)
    Xq = rng.uniform(size=(7, d))
    mu_sk, cov_sk = sk.predict(Xq, return_cov=True)

    gpr = GaussianProcessRegressor(kernel="RBF", bounds=bounds,
                                   noise_level=1e-2, account_for_inf=None,
                                   clip_factor=None)
    gpr._theta = np.log(np.array([1.5, 0.3, 0.4]))
    gpr.append_to_data(X, y, fit_gpr=False)
    mu, cov = gpr.predict(Xq, return_cov=True)
    np.testing.assert_allclose(mu, mu_sk, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(cov, cov_sk, rtol=1e-6, atol=1e-10)
    # exclusivity, as in sklearn
    with pytest.raises(ValueError):
        gpr.predict(Xq, return_std=True, return_cov=True)


def test_remove_from_data_and_api_conveniences(rng):
    """remove_from_data + predict_is_finite + training_set_as_df +
    set_random_state (reference: gpry/gpr.py:490-542,819)."""
    bounds = np.array([[0.0, 1.0]] * 2)
    X = rng.uniform(size=(20, 2))
    y = -0.5 * np.sum(((X - 0.5) / 0.2) ** 2, axis=1)
    y[0] = -np.inf
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=4,
        random_state=1)
    gpr.append_to_data(X, y)
    df = gpr.training_set_as_df
    assert len(df) == 20 and "is_finite" in df
    fin = gpr.predict_is_finite(X[1:4])
    assert fin.shape == (3,)
    assert np.isclose(
        gpr.compute_threshold_given_sigma(20, 2),
        gpr._diff_threshold)

    n_before = gpr.n_total
    # remove two points (incl. the -inf one), no refit
    gpr.remove_from_data([0, 5], fit=False)
    assert gpr.n_total == n_before - 2
    assert not np.isin(-np.inf, gpr.y_train_all)
    mu = gpr.predict(X[1:3])
    np.testing.assert_allclose(mu, y[1:3], atol=0.5)
    # with refit
    gpr.remove_from_data([0], fit=True)
    assert gpr.n_total == n_before - 3
    gpr.set_random_state(123)
    assert isinstance(gpr._rng, np.random.Generator)


def test_sweep_dtype_policy(rng):
    """Condition-aware sweep dtype: float32 sweeps carry whole-nat errors
    on ill-conditioned kernels (measured 0.3-3.6 nats), so 'auto' must
    keep the fit dtype unless the estimated error is tiny."""
    import jax.numpy as jnp
    from gpry_tpu import config

    bounds = np.array([[-10.0, 10.0]] * 2)
    X = rng.uniform(-10, 10, size=(24, 2))
    y = -0.5 * np.sum(((X - [3.0, 2.0]) / [0.5, 1.2]) ** 2, axis=1)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=10,
        random_state=0)
    gpr.append_to_data(X, y)
    est = gpr.f32_sweep_error_estimate()
    assert est > 0.0 and np.isfinite(est)
    # forced modes
    old = config.SWEEP_DTYPE
    try:
        config.SWEEP_DTYPE = "float32"
        assert gpr.sweep_dtype() == jnp.float32
        assert gpr.sweep_params().X.dtype == jnp.float32
        config.SWEEP_DTYPE = "float64"
        assert gpr.sweep_dtype() == jnp.float64
        # auto on CPU always keeps the fit dtype (f32 buys nothing there)
        config.SWEEP_DTYPE = "auto"
        assert gpr.sweep_dtype() == gpr._dtype
    finally:
        config.SWEEP_DTYPE = old


def test_f32_sweep_error_estimate_tracks_reality(rng):
    """The error estimate must upper-bound-ish the actual f32-vs-f64
    prediction discrepancy."""
    import jax.numpy as jnp
    from gpry_tpu.models.gp import cast_surrogate, surrogate_predict

    bounds = np.array([[-10.0, 10.0]] * 2)
    X = rng.uniform(-10, 10, size=(30, 2))
    y = -0.5 * np.sum(((X - [3.0, 2.0]) / [0.5, 1.2]) ** 2, axis=1)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=10,
        random_state=0)
    gpr.append_to_data(X, y)
    p64 = gpr.surrogate_params()
    p32 = cast_surrogate(p64, jnp.float32)
    Xq = rng.uniform(-10, 10, size=(500, 2))
    m64, _ = surrogate_predict(gpr.family, p64, jnp.asarray(Xq))
    m32, _ = surrogate_predict(gpr.family, p32,
                               jnp.asarray(Xq, jnp.float32))
    m64, m32 = np.asarray(m64), np.asarray(m32)
    fin = np.isfinite(m64) & np.isfinite(m32)
    med_err = float(np.median(np.abs(m64 - m32)[fin]))
    est = gpr.f32_sweep_error_estimate()
    # the estimate is an upper bound: it must never be far BELOW the
    # measured error (it may exceed it by orders of magnitude — it bounds
    # the worst-case cancellation), and on a kernel this ill-conditioned
    # both must scream "not f32-safe"
    assert est > med_err / 30, (est, med_err)
    assert est > 1.0  # far above any sane SWEEP_F32_TOL
    assert med_err > 0.05  # f32 genuinely unusable here


def test_lml_batch_chunked_matches_unchunked(rng, monkeypatch):
    """Memory-budgeted screen chunking (the d=16 device-memory fix) must return
    exactly the same LML values as one vmapped sweep, including the padded
    last chunk."""
    import jax.numpy as jnp
    from gpry_tpu.models.gp import (_lml_batch, _lml_batch_chunked,
                                    GaussianProcessRegressor)
    from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y

    bounds = np.array([[-1.0, 1.0]] * 2)
    X = rng.uniform(-1, 1, size=(20, 2))
    y = -np.sum((X / 0.4) ** 2, axis=1)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=4,
        random_state=0)
    gpr.append_to_data(X, y)
    lo, hi = np.asarray(gpr.theta_bounds).T
    thetas = jnp.asarray(rng.uniform(lo, hi, size=(37, len(lo))),
                         gpr._dX.dtype)
    ref = np.asarray(_lml_batch(gpr.family, gpr._dX, gpr._dy, gpr.n,
                                gpr._noise_var_, thetas))
    # force tiny chunks (pow2-rounded to >= 8) including a padded tail
    monkeypatch.setenv("GPRY_TPU_LML_SCREEN_MEM_GB", "1e-9")
    got = np.asarray(_lml_batch_chunked(gpr.family, gpr._dX, gpr._dy,
                                        gpr.n, gpr._noise_var_, thetas))
    np.testing.assert_array_equal(ref, got)
