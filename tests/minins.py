"""
Minimal API-compatible test doubles for the slices of pypolychord,
ultranest and nessai that gpry_tpu's host NS adapters touch — NOT the real
packages, and never pretending to be outside the test suite.

None of the three samplers is installed in the test image, but the host
adapter code (gpry_tpu/mc/interfaces.py InterfacePolyChord /
InterfaceUltraNest / InterfaceNessai) must actually execute in tests.
Tests inject these modules via ``install_polychord()`` /
``install_ultranest()`` / ``install_nessai()`` so those code paths run
live against implementations of the same surfaces:

* ``pypolychord.run_polychord(likelihood, nDims, nDerived, settings,
  prior)`` with ``pypolychord.settings.PolyChordSettings``; the output
  object carries ``.root`` / ``.logZ`` / ``.make_paramnames_files`` and a
  getdist-layout ``<root>.txt`` chain ([weight, -2 logp, params...], as
  real PolyChord writes and the reference reads,
  gpry/ns_interfaces.py:233-238);
* ``ultranest.ReactiveNestedSampler(names, loglike, transform=...,
  vectorized=True).run(min_num_live_points=..., frac_remain=...)`` ->
  ``{"weighted_samples": {"points","weights","logl"}, "logz", "ncall"}``;
* ``nessai.model.Model`` (names/bounds/in_bounds) +
  ``nessai.flowsampler.FlowSampler`` with ``.run()``,
  ``.posterior_samples`` (structured array with param fields + logL),
  ``.log_evidence``.

All three share one tiny host nested sampler (_simple_ns): shrinking live
set with constrained-MH replacement — enough to recover a 2-d Gaussian to
test tolerance.
"""

import os
import sys
import types
from types import SimpleNamespace

import numpy as np

__version__ = "0.0-minins"


def _simple_ns(logp_vec, lo, hi, nlive=60, frac_remain=0.01, rng=None,
               n_mh=25, max_iter=20000):
    """Plain host NS. ``logp_vec``: (n, d) -> (n,). Returns
    (X, logl, logw, logZ, n_calls) over dead + final live points."""
    lo = np.asarray(lo, dtype=float)
    hi = np.asarray(hi, dtype=float)
    d = len(lo)
    nlive = int(nlive)
    rng = np.random.default_rng(rng)
    X = rng.uniform(lo, hi, size=(nlive, d))
    L = np.array(logp_vec(X), dtype=float)  # copy: input may be read-only
    n_calls = nlive
    dead_X, dead_L, dead_logw = [], [], []
    logZ = -np.inf
    log_shell = np.log1p(-np.exp(-1.0 / nlive))  # log(1 - t), t = e^{-1/n}
    for i in range(1, max_iter + 1):
        k = int(np.argmin(L))
        Lmin = float(L[k])
        logw = Lmin - (i - 1) / nlive + log_shell
        dead_X.append(X[k].copy())
        dead_L.append(Lmin)
        dead_logw.append(logw)
        logZ = np.logaddexp(logZ, logw)
        # stop when the live points' evidence share drops below frac_remain
        logZ_live = float(np.max(L)) - i / nlive
        if np.exp(logZ_live - np.logaddexp(logZ, logZ_live)) < frac_remain:
            break
        # replacement: constrained MH seeded from another live point
        j = int(rng.integers(nlive - 1))
        j = j if j < k else j + 1
        x, lx = X[j].copy(), float(L[j])
        scale = np.maximum(np.std(X, axis=0), 1e-10)
        for _ in range(n_mh):
            prop = x + rng.normal(size=d) * scale
            if np.any(prop < lo) or np.any(prop > hi):
                continue
            lp = float(logp_vec(prop[None])[0])
            n_calls += 1
            if lp > Lmin:
                x, lx = prop, lp
        X[k] = x
        L[k] = lx
    # surviving live points share the final volume equally
    logX_final = -len(dead_L) / nlive
    for j in range(nlive):
        dead_X.append(X[j].copy())
        dead_L.append(float(L[j]))
        dead_logw.append(float(L[j]) + logX_final - np.log(nlive))
        logZ = np.logaddexp(logZ, dead_logw[-1])
    return (np.asarray(dead_X), np.asarray(dead_L), np.asarray(dead_logw),
            float(logZ), n_calls)


# --------------------------------------------------------------- pypolychord

class PolyChordSettings:
    def __init__(self, nDims, nDerived, **kwargs):
        self.nDims = nDims
        self.nDerived = nDerived
        self.nlive = 25 * nDims
        self.num_repeats = 5 * nDims
        self.nprior = None
        self.precision_criterion = 0.001
        self.base_dir = "chains"
        self.file_root = "test"
        self.read_resume = True
        self.seed = -1
        for key, val in kwargs.items():
            setattr(self, key, val)


class _PolyChordOutput:
    def __init__(self, base_dir, file_root, logZ):
        self.base_dir = base_dir
        self.file_root = file_root
        self.root = os.path.join(base_dir, file_root)
        self.logZ = logZ

    def make_paramnames_files(self, paramnames):
        with open(self.root + ".paramnames", "w", encoding="utf-8") as fh:
            for name, label in paramnames:
                fh.write(f"{name}  {label}\n")


def run_polychord(likelihood, nDims, nDerived, settings, prior=None):
    rng = None if settings.seed in (None, -1) else int(settings.seed)
    if prior is None:
        prior = lambda cube: np.asarray(cube)

    def logp_vec(U):
        return np.array([likelihood(prior(u))[0] for u in np.atleast_2d(U)])

    X_u, logl, logw, logZ, _ = _simple_ns(
        logp_vec, np.zeros(nDims), np.ones(nDims),
        nlive=settings.nlive, frac_remain=settings.precision_criterion,
        rng=rng)
    X_phys = np.array([prior(u) for u in X_u])
    os.makedirs(settings.base_dir, exist_ok=True)
    out = _PolyChordOutput(settings.base_dir, settings.file_root, logZ)
    w = np.exp(logw - np.max(logw))
    chain = np.column_stack([w, -2.0 * logl, X_phys])
    np.savetxt(out.root + ".txt", chain)
    return out


def install_polychord():
    mod = types.ModuleType("pypolychord")
    mod.run_polychord = run_polychord
    settings_mod = types.ModuleType("pypolychord.settings")
    settings_mod.PolyChordSettings = PolyChordSettings
    mod.settings = settings_mod
    sys.modules["pypolychord"] = mod
    sys.modules["pypolychord.settings"] = settings_mod
    return mod


# ----------------------------------------------------------------- ultranest

class ReactiveNestedSampler:
    def __init__(self, param_names, loglike, transform=None, log_dir=None,
                 resume="overwrite", vectorized=False, **kwargs):
        self.param_names = list(param_names)
        self._loglike = loglike
        self._transform = transform
        self._vectorized = vectorized
        self.log_dir = log_dir

    def run(self, min_num_live_points=100, frac_remain=0.01, dlogz=None,
            max_ncalls=None, viz_callback=None, show_status=False,
            **kwargs):
        d = len(self.param_names)

        def logp_vec(U):
            U = np.atleast_2d(U)
            X = self._transform(U) if self._transform is not None else U
            if self._vectorized:
                return np.asarray(self._loglike(X), dtype=float)
            return np.array([float(self._loglike(x)) for x in X])

        X_u, logl, logw, logZ, ncall = _simple_ns(
            logp_vec, np.zeros(d), np.ones(d),
            nlive=min_num_live_points, frac_remain=frac_remain)
        X = self._transform(X_u) if self._transform is not None else X_u
        w = np.exp(logw - np.max(logw))
        w /= np.sum(w)
        return {
            "weighted_samples": {"points": np.asarray(X), "weights": w,
                                 "logl": logl},
            "logz": logZ,
            "ncall": ncall,
        }


def install_ultranest():
    mod = types.ModuleType("ultranest")
    mod.ReactiveNestedSampler = ReactiveNestedSampler
    sys.modules["ultranest"] = mod
    return mod


# -------------------------------------------------------------------- nessai

class NessaiModel:
    """Field-parity subset of nessai.model.Model: names, bounds dict,
    in_bounds over structured arrays."""

    names = []
    bounds = {}

    def in_bounds(self, x):
        x = np.atleast_1d(x)
        ok = np.ones(x.shape, dtype=bool)
        for name in self.names:
            ok &= (x[name] >= self.bounds[name][0]) \
                & (x[name] <= self.bounds[name][1])
        return ok

    def log_prior(self, x):  # pragma: no cover - overridden by adapters
        raise NotImplementedError

    def log_likelihood(self, x):  # pragma: no cover - overridden
        raise NotImplementedError


class FlowSampler:
    def __init__(self, model, output=None, nlive=500, stopping=0.1,
                 seed=None, resume=False, plot=False, checkpointing=False,
                 log_on_iteration=False, **kwargs):
        self.model = model
        self.output = output
        self.nlive = int(nlive)
        self.stopping = float(stopping)
        self.seed = seed
        self.posterior_samples = None
        self.log_evidence = None
        self.ns = SimpleNamespace(
            get_result_dictionary=lambda: {"log_evidence": self.log_evidence})

    def run(self, plot=False, save=False, **kwargs):
        names = list(self.model.names)
        lo = np.array([self.model.bounds[n][0] for n in names])
        hi = np.array([self.model.bounds[n][1] for n in names])
        dtype = [(n, float) for n in names]

        def logp_vec(X):
            X = np.atleast_2d(X)
            rec = np.zeros(len(X), dtype=dtype)
            for i, n in enumerate(names):
                rec[n] = X[:, i]
            return np.asarray(self.model.log_likelihood(rec), dtype=float)

        X, logl, logw, logZ, _ = _simple_ns(
            logp_vec, lo, hi, nlive=self.nlive,
            frac_remain=min(self.stopping, 0.05), rng=self.seed)
        # nessai exposes equal-weight posterior samples: resample by weight
        rng = np.random.default_rng(self.seed)
        w = np.exp(logw - np.max(logw))
        w /= np.sum(w)
        idx = rng.choice(len(X), size=min(len(X), 4 * self.nlive), p=w)
        post = np.zeros(len(idx),
                        dtype=dtype + [("logL", float), ("logP", float),
                                       ("it", float)])
        for i, n in enumerate(names):
            post[n] = X[idx, i]
        post["logL"] = logl[idx]
        post["logP"] = 0.0
        if self.output:
            os.makedirs(self.output, exist_ok=True)
        self.posterior_samples = post
        self.log_evidence = logZ
        return post


def install_nessai():
    mod = types.ModuleType("nessai")
    model_mod = types.ModuleType("nessai.model")
    model_mod.Model = NessaiModel
    flow_mod = types.ModuleType("nessai.flowsampler")
    flow_mod.FlowSampler = FlowSampler
    mod.model = model_mod
    mod.flowsampler = flow_mod
    sys.modules["nessai"] = mod
    sys.modules["nessai.model"] = model_mod
    sys.modules["nessai.flowsampler"] = flow_mod
    return mod


def uninstall():
    for name in ("pypolychord", "pypolychord.settings", "ultranest",
                 "nessai", "nessai.model", "nessai.flowsampler"):
        sys.modules.pop(name, None)
