"""
Adapters over nested samplers, uniform across engines.

Reference surface: gpry/ns_interfaces.py (543 LoC) — an ABC with
``set_prior / set_precision / run / delete_output`` implemented for
PolyChord, UltraNest and nessai.  Here the same contract covers:

* ``InterfaceDevice`` — the on-device vectorized NS (mc.nested), the
  default and the device path;
* ``InterfacePolyChord`` / ``InterfaceUltraNest`` / ``InterfaceNessai`` —
  host-side engines, available when their packages are installed (they are
  optional and absent in this image; importing raises a clear error).
"""

import os
import shutil

import numpy as np

from gpry_tpu.utils.tools import check_and_return_bounds


class NSInterface:
    """Uniform nested-sampler adapter (reference: gpry/ns_interfaces.py:36)."""

    def __init__(self, verbose=1):
        self.verbose = verbose
        self.bounds = None
        self.nlive = None
        self.num_repeats = None
        self.precision_criterion = None
        self.nprior = None
        self.out_dir = None

    def set_prior(self, bounds, params=None):
        self.bounds = check_and_return_bounds(bounds)
        self.params = params

    def set_precision(self, nlive=None, num_repeats=None,
                      precision_criterion=None, nprior=None, seed=None):
        if nlive is not None:
            self.nlive = int(nlive)
        if num_repeats is not None:
            self.num_repeats = int(num_repeats)
        if precision_criterion is not None:
            self.precision_criterion = float(precision_criterion)
        if nprior is not None:
            self.nprior = int(nprior)
        self.seed = seed

    def run(self, logp):
        """Run NS on ``logp(X) -> (n,)``; returns a samples dict
        {"X", "logpost", "weights", "logZ"}."""
        raise NotImplementedError

    def delete_output(self):
        if self.out_dir and os.path.isdir(self.out_dir):
            shutil.rmtree(self.out_dir, ignore_errors=True)


class InterfaceDevice(NSInterface):
    """On-device vectorized NS (the default)."""

    def __init__(self, verbose=1, rng=None):
        super().__init__(verbose=verbose)
        self.rng = rng if isinstance(rng, np.random.Generator) \
            else np.random.default_rng(rng)

    def run(self, logp_fn_and_params):
        """
        ``logp_fn_and_params``: either a (fn, params) pair with fn a
        stable-identity jittable ``f(params, X)``, or a plain callable
        (wrapped via host callback — slower, for API parity).
        """
        import jax
        import jax.numpy as jnp
        from gpry_tpu import config
        from gpry_tpu.mc.nested import run_nested_device
        dt = config.FIT_DTYPE
        lo = jnp.asarray(self.bounds[:, 0], dt)
        hi = jnp.asarray(self.bounds[:, 1], dt)
        if isinstance(logp_fn_and_params, tuple):
            fn, params = logp_fn_and_params
            from gpry_tpu.parallel.mesh import available_mesh
            mesh = available_mesh(platform=None)
        else:
            # plain callable (the generic NSInterface.run contract): wrap
            # through a host callback — every batched likelihood request
            # from the device loop round-trips to the host.  Slower, for
            # API parity; unmeshed (callbacks inside shard_map are not
            # portable).
            host_fn = logp_fn_and_params

            def fn(params, X):
                del params
                return jax.pure_callback(
                    lambda Xh: np.asarray(
                        host_fn(np.asarray(Xh)),
                        dtype=dt).reshape(np.shape(Xh)[0]),
                    jax.ShapeDtypeStruct((X.shape[0],), dt),
                    X, vmap_method="sequential")

            params = ()
            mesh = None
        d = self.bounds.shape[0]
        key = jax.random.PRNGKey(int(self.rng.integers(2**31)))
        res = run_nested_device(
            fn, params, key, lo, hi, nlive=self.nlive or 25 * d,
            num_repeats=self.num_repeats or 5 * d,
            precision_criterion=self.precision_criterion or 0.01,
            max_dead=int((self.nlive or 25 * d) * max(10, 3 * d)),
            n_prior=self.nprior, mesh=mesh)
        logw = np.asarray(res.logw)
        keep = np.isfinite(logw)
        return {
            "X": np.asarray(res.X)[keep],
            "logpost": np.asarray(res.logl)[keep],
            "weights": np.exp(logw[keep] - logw[keep].max()),
            "logZ": float(res.logZ),
            "n_calls": int(res.n_calls),
        }


class InterfacePolyChord(NSInterface):
    """Host PolyChord adapter (reference: gpry/ns_interfaces.py:102-270).
    Requires pypolychord."""

    def __init__(self, verbose=1, out_dir=None):
        super().__init__(verbose=verbose)
        try:
            import pypolychord  # noqa: F401
        except ImportError as excpt:
            raise ImportError(
                "pypolychord is not installed; use InterfaceDevice (the "
                "on-device sampler) or install PolyChord.") from excpt
        self.out_dir = out_dir or "./polychord_out"

    def run(self, logp):
        import pypolychord
        from pypolychord.settings import PolyChordSettings
        d = self.bounds.shape[0]
        settings = PolyChordSettings(d, 0)
        if self.nlive:
            settings.nlive = self.nlive
        if self.num_repeats:
            settings.num_repeats = self.num_repeats
        if self.precision_criterion:
            settings.precision_criterion = self.precision_criterion
        if self.nprior:
            settings.nprior = self.nprior
        if getattr(self, "seed", None) is not None:
            settings.seed = int(self.seed)
        settings.base_dir = self.out_dir
        settings.file_root = "gpry_tpu"
        settings.read_resume = False
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]

        def prior(cube):
            return lo + np.asarray(cube) * (hi - lo)

        def likelihood(x):
            return float(np.atleast_1d(logp(np.asarray(x)[None]))[0]), []

        out = pypolychord.run_polychord(
            likelihood, d, 0, settings, prior)
        names = self.params or [f"x_{i}" for i in range(d)]
        out.make_paramnames_files([(p, p) for p in names])
        # Read the weighted posterior chain <root>.txt, getdist layout
        # [weight, chi2 = -2 logp, params...] (the reference does the same,
        # gpry/ns_interfaces.py:233-238; PolyChord stores chi2, not -logp).
        samples = np.atleast_2d(np.loadtxt(out.root + ".txt"))
        return {"X": samples[:, 2:2 + d], "logpost": -0.5 * samples[:, 1],
                "weights": samples[:, 0], "logZ": float(out.logZ)}


class InterfaceUltraNest(NSInterface):
    """Host UltraNest adapter (reference: gpry/ns_interfaces.py:422-537).
    Requires ultranest; uses its vectorized-likelihood mode."""

    def __init__(self, verbose=1, out_dir=None):
        super().__init__(verbose=verbose)
        try:
            import ultranest  # noqa: F401
        except ImportError as excpt:
            raise ImportError(
                "ultranest is not installed; use InterfaceDevice (the "
                "on-device sampler) or install ultranest.") from excpt
        self.out_dir = out_dir

    def run(self, logp):
        import ultranest
        d = self.bounds.shape[0]
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]

        def transform(cube):
            return lo + cube * (hi - lo)

        sampler = ultranest.ReactiveNestedSampler(
            self.params or [f"x_{i}" for i in range(d)],
            lambda X: np.asarray(logp(X)),
            transform=transform, vectorized=True,
            log_dir=self.out_dir, resume="overwrite")
        # precision_criterion maps to frac_remain, as in the reference
        # (gpry/ns_interfaces.py:483); ultranest itself cannot be seeded
        # (gpry/gp_acquisition.py:803-808).
        result = sampler.run(
            min_num_live_points=self.nlive or 25 * d,
            frac_remain=self.precision_criterion or 0.01,
            viz_callback=None, show_status=False)
        ws = result["weighted_samples"]
        w = np.asarray(ws["weights"], dtype=float)
        keep = w > 0  # reference: tools.remove_0_weight_samples
        return {"X": np.asarray(ws["points"])[keep],
                "logpost": np.asarray(ws["logl"])[keep],
                "weights": w[keep],
                "logZ": float(result["logz"])}


class InterfaceNessai(NSInterface):
    """Host nessai (flow-accelerated NS) adapter (reference:
    gpry/ns_interfaces.py:272-419).  Requires nessai."""

    def __init__(self, verbose=1, out_dir=None):
        super().__init__(verbose=verbose)
        try:
            import nessai  # noqa: F401
        except ImportError as excpt:
            raise ImportError(
                "nessai is not installed; use InterfaceDevice (the "
                "on-device sampler) or install nessai.") from excpt
        self.out_dir = out_dir or "./nessai_out"

    def run(self, logp):
        from nessai.flowsampler import FlowSampler
        from nessai.model import Model as NessaiModel

        d = self.bounds.shape[0]
        names = self.params or [f"x{i}" for i in range(d)]
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        log_volume = float(np.sum(np.log(hi - lo)))

        class _SurrogateModel(NessaiModel):
            """The surrogate log-posterior as a nessai Model: flat prior on
            the bounds box; ``logp`` plays the likelihood."""

            def __init__(inner):
                inner.names = list(names)
                inner.bounds = {n: [float(lo[i]), float(hi[i])]
                                for i, n in enumerate(names)}

            def log_prior(inner, x):
                with np.errstate(divide="ignore"):
                    return np.log(inner.in_bounds(x).astype(float)) \
                        - log_volume

            def log_likelihood(inner, x):
                arr = np.stack([np.atleast_1d(x[n]) for n in inner.names],
                               axis=-1)
                return np.asarray(logp(np.atleast_2d(arr)))

        sampler = FlowSampler(
            _SurrogateModel(), output=self.out_dir,
            nlive=self.nlive or 25 * d,
            stopping=self.precision_criterion or 0.1,
            seed=self.seed, resume=False, plot=False)
        sampler.run(plot=False, save=False)
        post = sampler.posterior_samples
        X = np.stack([post[n] for n in names], axis=-1)
        # nessai's logL is our logp (flat-prior likelihood); posterior
        # samples come equal-weighted
        return {"X": X, "logpost": np.asarray(post["logL"], dtype=float),
                "weights": np.ones(len(X)),
                "logZ": float(sampler.log_evidence)}


_ns_interfaces = {
    "device": InterfaceDevice,
    "polychord": InterfacePolyChord,
    "ultranest": InterfaceUltraNest,
    "nessai": InterfaceNessai,
}


def init_nested_sampler(name="device", **kwargs):
    """
    Build an NS interface by name, with the reference's fallback chain
    (polychord -> ultranest, gpry/gp_acquisition.py:650-682) extended by the
    always-available on-device sampler.
    """
    if name not in _ns_interfaces:
        raise ValueError(
            f"Unknown nested sampler {name!r}; "
            f"available: {sorted(_ns_interfaces)}")
    try:
        return _ns_interfaces[name](**kwargs)
    except ImportError:
        pass
    import warnings
    for fallback in ("polychord", "ultranest", "device"):
        if fallback == name:
            continue
        try:
            iface = _ns_interfaces[fallback](**kwargs)
        except ImportError:
            continue
        warnings.warn(
            f"Nested sampler {name!r} is not importable; "
            f"falling back to {fallback!r}.")
        return iface
    raise RuntimeError("No nested sampler available.")
