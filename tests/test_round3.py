"""
Round-3 behavior tests: starvation-forced NS resample, checkpoint
update_truth, predict validation, the gradient-free acquisition optimizer,
NS-interface name checking, and jit-token staleness.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from model_generator import random_gaussian  # noqa: E402


# ---------------------------------------------------------------------------
# Starvation parity (reference: gpry/run.py:885-911)
# ---------------------------------------------------------------------------


def test_nora_force_resample_reruns_ns(rng):
    """force_resample must trigger a fresh NS run even mid mc_every
    cadence (reference: gpry/gp_acquisition.py:1023)."""
    from gpry_tpu.acquisition.nora import NORA
    from gpry_tpu.models.gp import GaussianProcessRegressor

    d = 2
    bounds = np.array([[-1.0, 1.0]] * d)
    gpr = GaussianProcessRegressor(bounds=bounds, random_state=rng)
    X = rng.uniform(-1, 1, size=(12, d))
    y = -np.sum(X**2, axis=1)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 2})

    nora = NORA(bounds, mc_every=10, rng=rng, verbose=0)
    calls = []
    orig = nora._run_ns
    nora._run_ns = lambda gpr: (calls.append(1), orig(gpr))[1]

    nora.multi_add(gpr, n_points=2)
    assert len(calls) == 1
    # within mc_every cadence: reuse, no new NS run
    nora.multi_add(gpr, n_points=2)
    assert len(calls) == 1
    # starved iteration: the Runner passes force_resample=True
    nora.multi_add(gpr, n_points=2, force_resample=True)
    assert len(calls) == 2


def test_nora_ess_collapse_forces_fresh_ns(rng):
    """If importance-reweighting collapses the reused sample's effective
    sample size below ``min_ess_reuse``, NORA must force a fresh NS run
    (guard beyond the reference, which reuses blindly and feeds garbage
    moments into the MC diagnosis at d>=16)."""
    from gpry_tpu.acquisition.nora import NORA
    from gpry_tpu.models.gp import GaussianProcessRegressor

    d = 2
    bounds = np.array([[-1.0, 1.0]] * d)
    gpr = GaussianProcessRegressor(bounds=bounds, random_state=rng)
    X = rng.uniform(-1, 1, size=(12, d))
    y = -np.sum(X**2, axis=1)
    gpr.append_to_data(X, y, fit_gpr={"n_restarts": 2})

    nora = NORA(bounds, mc_every=10, rng=rng, verbose=0)
    calls = []
    orig = nora._run_ns
    nora._run_ns = lambda gpr: (calls.append(1), orig(gpr))[1]

    nora.multi_add(gpr, n_points=2)
    assert len(calls) == 1
    # collapse the stored weights onto a single point: the reweighted ESS
    # is ~1 < min_ess_reuse = 2d = 4, so reuse must be abandoned
    nora.last_MC_logw = np.full_like(nora.last_MC_logw, -1e4)
    nora.last_MC_logw[0] = 0.0
    nora.multi_add(gpr, n_points=2)
    assert len(calls) == 2
    assert nora._reweight_ess() > nora.min_ess_reuse


def test_diagnosis_uses_acquisition_sample_and_mc_direction(rng):
    """The diagnosis KL must be KL(mc||acq) against the acquisition's OWN
    last sample (reference: gpry/run.py:1775-1784), and must be skipped
    for engines without one."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=17)
    runner = Runner(m.loglike, bounds=m.bounds, seed=3, verbose=0,
                    options={"max_total": 40, "max_initial": 20})
    runner.do_initial_training()
    runner.generate_mc_sample(sampler="mcmc",
                              add_options={"n_steps": 200, "n_chains": 8})

    class _AcqWithSample:
        def last_MC_sample(self):
            # a sample wildly different from the MC one -> KL >= d
            X = rng.normal(50.0, 0.01, size=(100, 2))
            return X, np.zeros(100), np.ones(100)

    class _AcqNoSample:
        pass

    runner.acquisition = _AcqWithSample()
    assert runner.diagnose_last_mc_sample() is False
    # engines without a sample (e.g. BatchOptimizer) skip the KL test;
    # the verdict is the training-alignment test alone
    runner.acquisition = _AcqNoSample()
    align_only = runner.diagnose_last_mc_sample()
    assert isinstance(align_only, bool)


def test_budget_exhaustion_resamples_stale_vetoed_mc(rng):
    """If every declared convergence is vetoed and the budget then runs
    out, the final MC must be re-drawn from the CURRENT surrogate — not
    the stale sample left by an earlier vetoed convergence."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=19)
    runner = Runner(m.loglike, bounds=m.bounds, seed=7, verbose=0,
                    options={"max_total": 14, "max_initial": 12,
                             "n_points_per_acq": 2},
                    convergence_criterion="CorrectCounter")
    # every convergence gets vetoed
    runner.diagnose_last_mc_sample = lambda: False
    mc_at = []
    orig_mc = runner.generate_mc_sample

    def traced_mc(*args, **kwargs):
        out = orig_mc(*args, **kwargs)
        mc_at.append(int(runner.gpr.n_total))
        return out

    runner.generate_mc_sample = traced_mc
    # make convergence trivially reachable so the veto path actually runs
    for cc in runner.convergence_criterion:
        cc.ncorrect = -1  # n_pred > -1 always: converge every iteration
    runner.run()
    assert not runner.has_converged
    # the last MC was drawn at the FINAL n_total (fresh surrogate)
    assert mc_at[-1] == runner.gpr.n_total
    assert runner._mc_at_n_total == runner.gpr.n_total


def test_runner_starvation_skips_eval_and_gives_up(rng):
    """A starved acquisition must not evaluate the truth on the sub-minimal
    batch, must re-try with force_resample, and must give up after
    n_resamples_before_giveup retries (reference: gpry/run.py:885-911)."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=11)
    truth_calls = []

    def loglike(x):
        truth_calls.append(np.copy(x))
        return m.loglike(x)

    runner = Runner(loglike, bounds=m.bounds, seed=2, verbose=0,
                    options={"max_total": 40, "max_initial": 20,
                             "n_points_per_acq": 4,
                             "n_resamples_before_giveup": 2,
                             # reference give-up semantics (no Sobol
                             # exploration fallback)
                             "max_starved_explore": 0},
                    convergence_criterion="DontConverge")

    force_flags = []

    class _StarvedAcq:
        mean = None
        cov = None

        def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                      force_resample=False):
            force_flags.append(force_resample)
            # always return a single point: < max(1, 4 // 2) = starvation
            return (np.zeros((1, 2)), np.array([0.0]), np.array([0.0]))

    runner.do_initial_training()
    n_truth_after_init = len(truth_calls)
    runner.acquisition = _StarvedAcq()
    runner._resumed = True  # skip re-running initial training
    runner._run_main_loop()
    # 1 first try + n_resamples_before_giveup retries, then give up
    assert force_flags == [False, True, True]
    # the starved 1-point batches were never truth-evaluated
    assert len(truth_calls) == n_truth_after_init


def test_starved_exploration_batch_unit(rng):
    """The Sobol exploration fallback must stay in bounds, extend one
    persistent net across batches and resume, honor the budget, and be
    disabled by max_starved_explore=0."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=23)
    runner = Runner(m.loglike, bounds=m.bounds, seed=4, verbose=0,
                    options={"max_total": 100, "max_initial": 20,
                             "max_starved_explore": 10})
    runner.do_initial_training()
    X1 = runner._starved_exploration_batch(4)
    assert X1.shape == (4, 2)
    assert np.all(X1 >= m.bounds[:, 0]) and np.all(X1 <= m.bounds[:, 1])
    X2 = runner._starved_exploration_batch(4)
    # net extension: no repeats between successive batches
    assert not np.any(np.all(np.isclose(X1[:, None], X2[None]), axis=-1))
    # budget: 8 of 10 spent -> next batch is clipped to 2, then None
    X3 = runner._starved_exploration_batch(4)
    assert X3.shape == (2, 2)
    assert runner._starved_exploration_batch(4) is None
    # the persisted (seed, index) reproduce the same continuation
    seed, idx = runner._explore_seed, 8
    from scipy.stats import qmc
    eng = qmc.Sobol(2, scramble=True, seed=seed)
    eng.fast_forward(idx)
    lo, hi = m.bounds[:, 0], m.bounds[:, 1]
    assert np.allclose(lo + eng.random(2) * (hi - lo), X3)
    # disabled -> None immediately
    runner2 = Runner(m.loglike, bounds=m.bounds, seed=4, verbose=0,
                     options={"max_initial": 20, "max_starved_explore": 0})
    runner2.do_initial_training()
    assert runner2._starved_exploration_batch(4) is None


def test_runner_starved_explores_then_gives_up(rng):
    """Once starvation retries are exhausted, the Runner must spend the
    Sobol exploration budget (truth-evaluating the exploration batches,
    convergence checks skipped) and only then give up."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=11)
    truth_calls = []

    def loglike(x):
        truth_calls.append(np.copy(x))
        return m.loglike(x)

    runner = Runner(loglike, bounds=m.bounds, seed=2, verbose=0,
                    options={"max_total": 60, "max_initial": 20,
                             "n_points_per_acq": 4,
                             "n_resamples_before_giveup": 2,
                             "max_starved_explore": 8},
                    convergence_criterion="DontConverge")

    force_flags = []

    class _StarvedAcq:
        mean = None
        cov = None

        def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                      force_resample=False):
            force_flags.append(force_resample)
            return (np.zeros((1, 2)), np.array([0.0]), np.array([0.0]))

    conv_calls = []
    orig_check = runner._check_convergence
    runner._check_convergence = \
        lambda *a, **k: (conv_calls.append(1), orig_check(*a, **k))[1]

    runner.do_initial_training()
    n_init = runner.gpr.n_total
    n_truth_after_init = len(truth_calls)
    runner.acquisition = _StarvedAcq()
    runner._resumed = True
    runner._run_main_loop()
    # 2 retries, then 2 exploration batches of 4 (budget 8: starvation
    # persists so each further starve explores immediately), then give up
    assert force_flags == [False, True, True, True, True]
    assert len(truth_calls) == n_truth_after_init + 8
    assert runner.gpr.n_total == n_init + 8
    assert runner._n_explored == 8
    # convergence was never checked on exploration batches
    assert conv_calls == []
    assert not runner.has_converged


def test_flat_convergence_vetoed_until_explore_budget_spent():
    """Convergence declared on a FLAT surrogate (training span <
    flat_span) must be vetoed and the Sobol exploration budget spent
    first; once the budget is exhausted a (genuinely) flat posterior is
    allowed to converge."""
    from gpry_tpu.run import Runner

    bounds = np.array([[-1.0, 1.0]] * 2)
    explored_before_accept = []

    # a GENTLY sloped target (span 0.02 << flat_span): the surrogate is
    # flat but the (stubbed) acquisition keeps proposing full batches,
    # so only the flat veto stands between declaration and acceptance
    runner = Runner(lambda x: 0.01 * float(np.atleast_1d(x)[0]),
                    bounds=bounds, seed=6, verbose=0,
                    options={"max_total": 60, "max_initial": 20,
                             "n_initial": 4, "n_points_per_acq": 2,
                             "max_starved_explore": 6},
                    convergence_criterion="DontConverge")

    class _FullBatchAcq:
        mean = None
        cov = None
        _i = 0

        def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                      force_resample=False):
            X = 1e-4 * (np.arange(n_points)[:, None] + 1) \
                * np.ones((1, 2)) + 1e-3 * type(self)._i
            type(self)._i += 1
            return X, np.zeros(n_points), np.zeros(n_points)

    runner._check_convergence = lambda *a, **k: (True, 0.0)
    orig_mc = runner.generate_mc_sample
    runner.generate_mc_sample = lambda *a, **k: (
        explored_before_accept.append(runner._n_explored), orig_mc(*a, **k))[1]
    runner.do_initial_training()
    runner.acquisition = _FullBatchAcq()
    runner._resumed = True
    runner._run_main_loop()
    assert runner.has_converged
    # the exploration budget was fully spent BEFORE the MC/acceptance
    assert runner._n_explored == 6
    assert explored_before_accept[0] == 6


def test_spike_found_by_exploration():
    """The spike fixture (narrow spike on a broad base): every initial
    point sees only the base, the acquisition is flat and starves, and
    the reference gives up (it actually crashes in sklearn's SVC first).
    The Sobol exploration fallback must locate the spike."""
    from model_generator import flat_base_spike

    from gpry_tpu.run import Runner

    m = flat_base_spike()
    base = np.log(1e-4)
    runner = Runner(m.loglike, bounds=m.bounds, seed=10, verbose=0,
                    options={"max_total": 100, "max_initial": 10,
                             # 64 Sobol points over [-1,1]: net spacing
                             # ~0.03 < the spike's ~0.09 signal width
                             "n_initial": 3, "max_starved_explore": 64},
                    convergence_criterion="DontConverge",
                    gp_acquisition={"NORA": {"nlive_max": "25d",
                                             "num_repeats": "2d"}})
    runner.run()
    # the spike (loglike >> base) is in the training set
    assert float(np.max(runner.gpr.y_train)) > base + 1.0


def test_runner_tail_batch_not_starved():
    """A full return of a small TAIL batch (budget < n_points_per_acq)
    must NOT be classified as starvation: the points are truth-evaluated
    and no forced resample happens."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=13)
    truth_calls = []

    def loglike(x):
        truth_calls.append(np.copy(x))
        return m.loglike(x)

    runner = Runner(loglike, bounds=m.bounds, seed=5, verbose=0,
                    options={"max_total": 40, "max_initial": 10,
                             "n_points_per_acq": 4,
                             "n_resamples_before_giveup": 2},
                    convergence_criterion="DontConverge")

    force_flags = []

    class _TailAcq:
        mean = None
        cov = None

        def multi_add(self, gpr, n_points=1, bounds=None, rng=None,
                      force_resample=False):
            force_flags.append(force_resample)
            # returns ALL requested points (a full batch of DISTINCT rows)
            return (0.1234 + 0.01 * np.arange(n_points)[:, None]
                    * np.ones((1, 2)),
                    np.zeros(n_points), np.zeros(n_points))

    runner.do_initial_training()
    # shrink the budget so exactly 1 point remains: the loop requests
    # n_points = min(4, 1) = 1
    runner.max_total = runner.gpr.n_total + 1
    n_truth_after_init = len(truth_calls)
    runner.acquisition = _TailAcq()
    runner._resumed = True
    runner._run_main_loop()
    # the single-point tail batch was requested once, in full, and
    # evaluated — no starvation retry
    assert force_flags == [False]
    assert len(truth_calls) == n_truth_after_init + 1


def test_overwrite_removes_stale_checkpoint(tmp_path):
    """load_checkpoint='overwrite' must clear pre-existing checkpoint
    files up front: saves skip tru.pkl when present, so a stale truth
    from a previous run at the same path would otherwise survive and a
    later resume would silently evaluate the WRONG likelihood."""
    from gpry_tpu import io as gio
    from gpry_tpu.run import Runner

    m_a = random_gaussian(d=2, rng=21)
    m_b = random_gaussian(d=2, rng=22)
    ckpt = str(tmp_path / "ckpt")

    runner_a = Runner(m_a.loglike, bounds=m_a.bounds, seed=1, verbose=0,
                      options={"max_total": 12, "max_initial": 10},
                      convergence_criterion="DontConverge",
                      checkpoint=ckpt, load_checkpoint="overwrite")
    runner_a.save_checkpoint()
    assert os.path.exists(os.path.join(ckpt, "tru.pkl"))

    runner_b = Runner(m_b.loglike, bounds=m_b.bounds, seed=2, verbose=0,
                      options={"max_total": 12, "max_initial": 10},
                      convergence_criterion="DontConverge",
                      checkpoint=ckpt, load_checkpoint="overwrite")
    # stale files were cleared at construction
    assert not os.path.exists(os.path.join(ckpt, "tru.pkl"))
    runner_b.save_checkpoint()

    truth, *_ = gio.read_checkpoint(ckpt)
    x = np.array([0.3, -0.4])
    np.testing.assert_allclose(truth.loglike(x), m_b.loglike(x))


# ---------------------------------------------------------------------------
# Checkpoint update_truth (reference: gpry/run.py:742-745)
# ---------------------------------------------------------------------------


def test_save_checkpoint_update_truth(tmp_path, rng):
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=7)
    ckpt = str(tmp_path / "ckpt")
    runner = Runner(m.loglike, bounds=m.bounds, seed=3, verbose=0,
                    options={"max_total": 12, "max_initial": 10},
                    convergence_criterion="DontConverge",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.save_checkpoint()
    tru = os.path.join(ckpt, "tru.pkl")
    mtime0 = os.path.getmtime(tru)
    os.utime(tru, (mtime0 - 100, mtime0 - 100))
    mtime0 = os.path.getmtime(tru)
    runner.save_checkpoint(update_truth=False)
    assert os.path.getmtime(tru) == mtime0  # not re-pickled
    runner.save_checkpoint(update_truth=True)
    assert os.path.getmtime(tru) > mtime0


# ---------------------------------------------------------------------------
# predict() input validation (reference inherits sklearn validate_data)
# ---------------------------------------------------------------------------


def test_predict_validate(rng):
    from gpry_tpu.models.gp import GaussianProcessRegressor

    bounds = np.array([[-1.0, 1.0]] * 2)
    gpr = GaussianProcessRegressor(bounds=bounds, random_state=rng)
    X = rng.uniform(-1, 1, size=(8, 2))
    gpr.append_to_data(X, -np.sum(X**2, axis=1),
                       fit_gpr={"n_restarts": 1})
    with pytest.raises(ValueError, match="must be"):
        gpr.predict(np.zeros((3, 5)))
    with pytest.raises(ValueError, match="NaN"):
        gpr.predict(np.array([[0.0, np.nan]]))
    # inf must be rejected too (sklearn validate_data checks all-finite)
    with pytest.raises(ValueError, match="inf"):
        gpr.predict(np.array([[np.inf, 0.0]]))
    # validate=False skips the checks (hot path)
    out = gpr.predict(np.zeros((2, 2)), validate=False)
    assert out.shape == (2,)


# ---------------------------------------------------------------------------
# Gradient-free ("sampling" / Powell) acquisition optimizer
# (reference: gpry/gp_acquisition.py:502-523)
# ---------------------------------------------------------------------------


def test_batch_optimizer_sampling_powell(rng):
    from gpry_tpu.acquisition.batch_optimizer import BatchOptimizer
    from gpry_tpu.models.gp import GaussianProcessRegressor

    d = 2
    bounds = np.array([[-1.0, 1.0]] * d)
    gpr = GaussianProcessRegressor(bounds=bounds, random_state=rng)
    X = rng.uniform(-1, 1, size=(14, d))
    gpr.append_to_data(X, -8 * np.sum(X**2, axis=1),
                       fit_gpr={"n_restarts": 2})
    acq = BatchOptimizer(bounds, acq_optimizer="sampling",
                         n_restarts_optimizer=4, verbose=0)
    X_out, y_lies, acq_vals = acq.multi_add(gpr, n_points=2, rng=rng)
    assert X_out.shape == (2, d)
    assert np.all(np.isfinite(acq_vals))
    assert np.all((X_out >= -1) & (X_out <= 1))


def test_batch_optimizer_callable_optimizer(rng):
    from gpry_tpu.acquisition.batch_optimizer import BatchOptimizer
    from gpry_tpu.models.gp import GaussianProcessRegressor

    d = 2
    bounds = np.array([[-1.0, 1.0]] * d)
    gpr = GaussianProcessRegressor(bounds=bounds, random_state=rng)
    X = rng.uniform(-1, 1, size=(10, d))
    gpr.append_to_data(X, -5 * np.sum(X**2, axis=1),
                       fit_gpr={"n_restarts": 2})

    def my_opt(obj, x0, bounds=None):
        return x0, obj(x0)  # no-op "optimizer"

    acq = BatchOptimizer(bounds, acq_optimizer=my_opt,
                         n_restarts_optimizer=4, verbose=0)
    X_out, _, acq_vals = acq.multi_add(gpr, n_points=1, rng=rng)
    assert X_out.shape == (1, d)
    assert np.all(np.isfinite(acq_vals))


# ---------------------------------------------------------------------------
# NS interface registry strictness
# ---------------------------------------------------------------------------


def test_init_nested_sampler_unknown_name_raises():
    from gpry_tpu.mc.interfaces import init_nested_sampler

    with pytest.raises(ValueError, match="Unknown nested sampler"):
        init_nested_sampler("polychrod")  # typo must not fall through


def test_init_nested_sampler_fallback_warns():
    from gpry_tpu.mc import interfaces as ifc

    class _Unimportable(ifc.InterfaceDevice):
        def __init__(self, **kw):
            raise ImportError("not installed")

    orig = ifc._ns_interfaces
    ifc._ns_interfaces = dict(orig, polychord=_Unimportable,
                              ultranest=_Unimportable)
    try:
        with pytest.warns(UserWarning, match="falling back to 'device'"):
            iface = ifc.init_nested_sampler("polychord")
        assert isinstance(iface, ifc.InterfaceDevice)
    finally:
        ifc._ns_interfaces = orig


# ---------------------------------------------------------------------------
# jit-token freshness under direct attribute mutation
# ---------------------------------------------------------------------------


def test_acq_jit_token_tracks_attribute_mutation():
    import jax.numpy as jnp

    from gpry_tpu.acquisition.functions import LogExp, acq_values_jit

    acqf = LogExp(zeta=1.0)
    mu = jnp.asarray([0.0, -1.0])
    std = jnp.asarray([0.5, 0.5])
    v1 = np.asarray(acq_values_jit(acqf, mu, std, 0.0, 0.0))
    acqf.zeta = 3.0  # direct mutation, no set_params
    v2 = np.asarray(acq_values_jit(acqf, mu, std, 0.0, 0.0))
    expect = 2.0 * 3.0 * np.asarray(mu) + 0.5 * np.log(0.25)
    np.testing.assert_allclose(v2, expect, rtol=1e-6)
    assert not np.allclose(v1, v2)


# ---------------------------------------------------------------------------
# TruthCobaya checkpoint round-trip (reference: gpry/truth.py:165-237)
# ---------------------------------------------------------------------------


def test_truth_cobaya_checkpoint_roundtrip(tmp_path):
    import importlib

    if importlib.util.find_spec("cobaya") is None:
        import minicobaya
        minicobaya.install()
        cleanup = minicobaya.uninstall
    else:
        cleanup = lambda: None
    try:
        from cobaya.model import get_model

        from gpry_tpu import io as gio
        from gpry_tpu.truth import TruthCobaya

        def loglike(x, y):
            return -0.5 * (x**2 + y**2) / 0.04

        info = {
            "likelihood": {"gauss": {
                "external": loglike, "input_params": ["x", "y"]}},
            "params": {
                "x": {"prior": {"min": -2, "max": 2}},
                "y": {"prior": {"min": -2, "max": 2}},
            },
        }
        truth = TruthCobaya(get_model(info))
        from gpry_tpu.progress import Progress
        gio.save_checkpoint(str(tmp_path), truth, _DummyGPR(), None, None,
                            {}, Progress())
        tru2, *_ = gio.read_checkpoint(str(tmp_path))
        assert isinstance(tru2, TruthCobaya)
        assert tru2.params == ["x", "y"]
        x = np.array([0.1, -0.2])
        assert np.isclose(tru2.logp(x), truth.logp(x))
    finally:
        cleanup()


class _DummyGPR:
    pass


# ---------------------------------------------------------------------------
# Crash-resilient driver (checkpoint resume after a runtime failure)
# ---------------------------------------------------------------------------


def test_run_resilient_recovers_from_worker_crash(tmp_path, monkeypatch):
    """A retryable accelerator-runtime failure mid-loop is recovered by
    rebuilding the Runner from the per-iteration checkpoint."""
    from gpry_tpu import run as run_mod

    m = random_gaussian(d=2, rng=13)
    calls = {"n": 0}
    orig = run_mod.Runner._fit_gpr

    def crashing_fit(self, X, y):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError(
                "UNAVAILABLE: device runtime lost its state")
        return orig(self, X, y)

    monkeypatch.setattr(run_mod.Runner, "_fit_gpr", crashing_fit)
    runner = run_mod.run_resilient(
        m.loglike, bounds=m.bounds, seed=13, verbose=1,
        checkpoint=str(tmp_path / "ck"), retry_wait_s=0)
    assert calls["n"] > 2                      # crashed and kept going
    assert runner.has_converged
    assert runner.last_mc_result is not None


def test_run_resilient_mc_crash_skips_reacquisition(tmp_path, monkeypatch):
    """A crash during the final MC resumes with has_converged restored:
    the loop is skipped and only the MC is re-run (no extra truth
    evaluations)."""
    from gpry_tpu import run as run_mod

    m = random_gaussian(d=2, rng=14)
    calls = {"mc": 0}
    state = {}
    orig_mc = run_mod.Runner.generate_mc_sample

    def crashing_mc(self, *a, **k):
        calls["mc"] += 1
        if calls["mc"] == 1:
            state["n_total_at_crash"] = self.gpr.n_total
            raise RuntimeError("UNAVAILABLE: worker restarted")
        return orig_mc(self, *a, **k)

    monkeypatch.setattr(run_mod.Runner, "generate_mc_sample", crashing_mc)
    runner = run_mod.run_resilient(
        m.loglike, bounds=m.bounds, seed=14, verbose=1,
        checkpoint=str(tmp_path / "ck2"), retry_wait_s=0)
    assert calls["mc"] == 2
    assert runner.has_converged
    assert runner.last_mc_result is not None
    # the resume skipped the acquisition loop entirely
    assert runner.gpr.n_total == state["n_total_at_crash"]


def test_run_resilient_nonretryable_raises(tmp_path, monkeypatch):
    """User-code bugs propagate immediately (no retry)."""
    from gpry_tpu import run as run_mod

    def broken_loglike(x):
        raise ValueError("user bug")

    with pytest.raises(ValueError, match="user bug"):
        run_mod.run_resilient(
            broken_loglike, bounds=np.array([[-1.0, 1.0]] * 2), seed=1,
            verbose=1, checkpoint=str(tmp_path / "ck3"), retry_wait_s=0)


def test_is_retryable_device_error():
    from gpry_tpu.run import is_retryable_device_error

    assert is_retryable_device_error(
        RuntimeError("UNAVAILABLE: device runtime lost its state"))
    assert is_retryable_device_error(
        RuntimeError("DEADLINE_EXCEEDED while fetching"))
    assert not is_retryable_device_error(ValueError("bad input"))
    # a machine without its accelerator fails at once
    assert not is_retryable_device_error(RuntimeError(
        "Unable to initialize backend 'cuda': no supported devices"))
    assert not is_retryable_device_error(RuntimeError("socket closed"))


def test_check_candidates_empty_batch():
    """Empty candidate batches (starved acquisition) must not crash
    (regression: spike fixture, d=1)."""
    from gpry_tpu.utils.tools import check_candidates

    dup = check_candidates(np.zeros((5, 2)), np.empty((0, 2)))
    assert dup.shape == (0,)


def test_runner_flat_target_explores_and_finds_spike(rng):
    """A spike-on-flat-base target (no acquisition signal from the initial
    points): the reference crashes on this fixture; with the Sobol
    exploration fallback + flat-convergence veto the run must FIND the
    spike (top ~9 log units above the base) and produce a final MC
    sample.  Convergence itself is NOT asserted: resolving a sigma=0.01
    spike to the criteria's tolerance inside the default 70-eval budget
    is not guaranteed, and an honest budget-exhausted finish with the
    spike mapped is the correct behavior (a premature "converged" on the
    unmapped base was the failure mode this guards against)."""
    from gpry_tpu.run import Runner

    def loglike(x):
        x_ = np.atleast_1d(x)[0]
        return float(np.log(1e-4 + np.exp(-0.5 * (x_ / 0.01) ** 2)))

    runner = Runner(loglike, bounds=np.array([[-1.0, 1.0]]), seed=100,
                    verbose=1, gp_acquisition={"NORA": {}})
    runner.run()
    # logpost includes the uniform prior constant -log(2); the spike top
    # sits ~9.2 log units above the base
    base = np.log(1e-4) - np.log(2.0)
    assert float(np.max(runner.gpr.y_train)) > base + 5.0
    assert runner.last_mc_result is not None


def test_retryable_crash_keeps_mpi_workers_serving(tmp_path, monkeypatch):
    """Under truth_executor="mpi", a RETRYABLE accelerator crash on rank 0
    must NOT stop the worker ranks: run_resilient rebuilds a Runner whose
    first truth broadcast expects them still in serve() (stopping them
    would deadlock the retry's first collective).  Non-retryable errors
    must release the workers (run.py:_run_mpi_guarded)."""
    from gpry_tpu import mpi
    from gpry_tpu import run as run_mod

    m = random_gaussian(d=2, rng=21)
    runner = run_mod.Runner(m.loglike, bounds=m.bounds, seed=21, verbose=0,
                            options={"max_total": 8})

    stopped = []
    synced = []
    runner.executor.mode = "mpi"
    monkeypatch.setattr(runner.executor, "stop_workers",
                        lambda: stopped.append(1))
    monkeypatch.setattr(mpi, "multiple_processes", True)
    monkeypatch.setattr(mpi, "is_main_process", True)
    monkeypatch.setattr(mpi, "sync_processes", lambda: synced.append(1))

    def crash_retryable(self):
        raise RuntimeError("UNAVAILABLE: device runtime lost its state")

    monkeypatch.setattr(run_mod.Runner, "_run_main_loop", crash_retryable)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        runner._run_mpi_guarded()
    assert stopped == []          # workers left serving for the retry

    def crash_bug(self):
        raise ValueError("user-code bug")

    monkeypatch.setattr(run_mod.Runner, "_run_main_loop", crash_bug)
    with pytest.raises(ValueError):
        runner._run_mpi_guarded()
    assert stopped == [1]         # released: no retry is coming
    assert synced == [1]


# ---------------------------------------------------------------------------
# Phase-boundary liveness heartbeats (external watchdog contract)
# ---------------------------------------------------------------------------

def test_liveness_heartbeat_touched_and_picklable(tmp_path):
    """A checkpointed run must leave ``liveness.heartbeat`` behind (phase
    boundaries touch it), the GPR's liveness callback must survive the
    checkpoint pickle (it is a partial over a module-level function, not a
    bound Runner method), and a resumed Runner must re-point the callback
    at its own checkpoint dir."""
    import pickle

    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=31)
    ckpt = str(tmp_path / "ckpt_hb")
    runner = Runner(m.loglike, bounds=m.bounds, seed=31, verbose=0,
                    options={"max_total": 10, "max_initial": 8},
                    convergence_criterion="DontConverge",
                    checkpoint=ckpt, load_checkpoint="overwrite")
    runner.run()
    hb = os.path.join(ckpt, "liveness.heartbeat")
    assert os.path.exists(hb)

    # the pickled GPR (as written by save_checkpoint) must round-trip with
    # the callback attached and the callback must still be invokable
    blob = pickle.dumps(runner.gpr)
    gpr2 = pickle.loads(blob)
    os.remove(hb)
    gpr2.liveness_callback()
    assert os.path.exists(hb)

    # resume re-attaches a callback pointing at the resumed checkpoint
    runner2 = Runner(m.loglike, bounds=m.bounds, seed=31, verbose=0,
                     checkpoint=ckpt, load_checkpoint="resume")
    os.remove(hb)
    runner2.gpr.liveness_callback()
    assert os.path.exists(hb)


def test_liveness_heartbeat_none_without_checkpoint(rng):
    """No checkpoint dir -> the callback is a no-op that never raises."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=32)
    runner = Runner(m.loglike, bounds=m.bounds, seed=32, verbose=0,
                    options={"max_total": 8})
    # must not raise even though there is nowhere to write
    runner._touch_liveness()
    runner.gpr.liveness_callback()


# ---------------------------------------------------------------------------
# Sweep-cast cache must invalidate on a classifier refit without refactorize
# ---------------------------------------------------------------------------

def test_sweep_cast_cache_invalidated_by_svm_refit(rng, monkeypatch):
    """An all-infinite append refits the SVM and early-returns WITHOUT
    touching the GP factorization (models/gp.py append_to_data); the
    memoized cast-sweep pytree must still pick up the new classifier, or
    f32 sweeps keep gating on the stale SVM and re-propose the dead
    region forever."""
    import jax.numpy as jnp
    from gpry_tpu import config
    from gpry_tpu.models import GaussianProcessRegressor
    from gpry_tpu.models.preprocessing import Normalize_bounds, Normalize_y

    monkeypatch.setattr(config, "SWEEP_DTYPE", "float32")

    bounds = np.array([[-2.0, 2.0]] * 2)
    X = rng.uniform(-1, 1, size=(20, 2))
    y = -0.5 * np.sum((X / 0.5) ** 2, axis=1)
    # one -inf so the classifier is non-trivially fitted from the start
    X = np.vstack([X, [[1.9, 1.9]]])
    y = np.append(y, -np.inf)
    gpr = GaussianProcessRegressor(
        bounds=bounds, preprocessing_X=Normalize_bounds(bounds),
        preprocessing_y=Normalize_y(), n_restarts_optimizer=6,
        account_for_inf="SVM", random_state=0)
    gpr.append_to_data(X, y)

    p1 = gpr.sweep_params()
    assert p1.X.dtype == jnp.float32
    assert gpr.sweep_params() is p1          # memoized within a generation
    stamp1 = gpr.infinities_classifier.fit_stamp

    # all-infinite batch: SVM refits, GP factorization untouched
    X_inf = np.array([[-1.9, 1.9], [1.9, -1.9], [-1.9, -1.9]])
    gpr.append_to_data(X_inf, np.full(3, -np.inf))
    assert gpr.infinities_classifier.fit_stamp > stamp1

    p2 = gpr.sweep_params()
    assert p2 is not p1                      # cache invalidated
    # the refreshed pytree's SVM must gate the newly learned dead corners
    from gpry_tpu.models.gp import surrogate_predict
    mu2, _ = surrogate_predict(gpr.family, p2,
                               jnp.asarray(X_inf, jnp.float32))
    assert np.all(np.asarray(mu2) == -np.inf), np.asarray(mu2)


def test_overwrite_clear_is_main_process_only(tmp_path, monkeypatch):
    """Under mpirun every rank constructs a Runner; a slow non-root rank
    reaching load_checkpoint='overwrite' must NOT delete checkpoint files
    rank 0 may already have written."""
    from gpry_tpu import io as gio
    from gpry_tpu import mpi
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=41)
    ck = tmp_path / "mpi_guard"
    ck.mkdir()
    sentinel = ck / "gpr.pkl"
    sentinel.write_bytes(b"live state from rank 0")

    monkeypatch.setattr(mpi, "multiple_processes", True)
    monkeypatch.setattr(mpi, "is_main_process", False)
    Runner(m.loglike, bounds=m.bounds, seed=41, verbose=0,
           options={"max_total": 8},
           checkpoint=str(ck), load_checkpoint="overwrite")
    assert sentinel.exists()          # non-root rank left it alone

    monkeypatch.setattr(mpi, "is_main_process", True)
    Runner(m.loglike, bounds=m.bounds, seed=41, verbose=0,
           options={"max_total": 8},
           checkpoint=str(ck), load_checkpoint="overwrite")
    assert not sentinel.exists()      # root rank wipes stale files
    del gio


def test_exploration_dedup_does_not_charge_budget(rng, monkeypatch):
    """Points skipped as duplicates advance the Sobol net position but do
    NOT spend exploration budget, and an all-duplicate draw redraws
    further into the net instead of returning an empty (exhausted-looking)
    batch."""
    import gpry_tpu.run as run_mod
    from gpry_tpu.run import Runner

    m = random_gaussian(d=2, rng=23)
    runner = Runner(m.loglike, bounds=m.bounds, seed=4, verbose=0,
                    options={"max_total": 100, "max_initial": 20,
                             "max_starved_explore": 10})
    runner.do_initial_training()

    calls = []
    real = run_mod.check_candidates

    def fake_check(seen, cand, tol=1e-8):
        calls.append(len(cand))
        if len(calls) == 1:
            # first draw: everything is a "duplicate"
            return np.ones(len(cand), dtype=bool)
        return real(seen, cand, tol)

    monkeypatch.setattr(run_mod, "check_candidates", fake_check)
    X = runner._starved_exploration_batch(4)
    # the all-duplicate first draw forced a redraw; the batch is full
    assert X.shape == (4, 2)
    assert len(calls) >= 2
    # budget charged only for returned points; net advanced past the dups
    assert runner._n_explored == 4
    assert runner._explore_net_i == 8


def test_load_options_backfills_max_starved_explore():
    """Resuming a checkpoint written before the exploration fallback
    existed must backfill the live default ('32d'), not silently disable
    the starvation/flat-veto guards."""
    from gpry_tpu.run import Runner

    m = random_gaussian(d=3, rng=7)
    runner = Runner(m.loglike, bounds=m.bounds, seed=1, verbose=0)
    old_options = dict(runner.options)
    old_options.pop("max_starved_explore")
    runner._load_options(old_options)
    assert runner.max_starved_explore == 32 * 3


def test_progress_accumulate_keeps_finite_evals():
    """accumulate=True with a NaN evals count must not erase a previously
    recorded finite count (and vice versa)."""
    from gpry_tpu.progress import Progress

    class _T:
        time = 1.0
        evals = np.nan

    class _TC(_T):
        evals = 12

    p = Progress()
    p.add_iteration()
    p.add_fit(_TC())
    p.add_fit(_T(), accumulate=True)
    assert p.data.iloc[-1]["evals_fit"] == 12
    assert p.data.iloc[-1]["time_fit"] == 2.0
    # NaN first, finite second: finite wins
    p.add_iteration()
    p.add_fit(_T())
    p.add_fit(_TC(), accumulate=True)
    assert p.data.iloc[-1]["evals_fit"] == 12
