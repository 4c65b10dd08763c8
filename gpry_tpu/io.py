"""
Checkpointing.

Reference format: 6 pickles per checkpoint dir — ``tru.pkl`` (Truth
re-init dict), ``gpr.pkl``, ``acq.pkl``, ``con.pkl``, ``opt.pkl``,
``pro.pkl`` (reference: gpry/io.py:12-156).  Objects are written with the
standard library's ``pickle``; those it cannot serialize (a lambda or
closure log-likelihood, for example) are written with ``dill``, which is
imported only then.  The same layout is kept so
that checkpoint dirs are recognizable, but device arrays inside the GPR are
converted to host numpy on save and restored on load (the "light"
checkpoint format the reference's FUTURE.md:33-35 wishes for: arrays +
hyperparameters, refactorized on load).
"""

import os
import pickle

import numpy as np

_CHECKPOINT_FILES = ("tru.pkl", "gpr.pkl", "acq.pkl", "con.pkl", "opt.pkl",
                     "pro.pkl")


def create_path(path, verbose=True):
    """Create the checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    return path


def clear_checkpoint(path):
    """
    Delete any of the 6 checkpoint files present at ``path``.  Used by
    ``load_checkpoint="overwrite"``: saves write ``tru.pkl`` only when
    absent (it never changes during a run), so a stale truth from a
    previous run at the same path must be removed up front or a later
    resume would silently reconstruct the wrong likelihood.
    """
    if path is None:
        return
    for fname in _CHECKPOINT_FILES:
        for suffix in ("", ".tmp"):
            try:
                os.remove(os.path.join(path, fname + suffix))
            except FileNotFoundError:
                pass


def check_checkpoint(path=None):
    """
    Boolean array: which of the 6 checkpoint files exist at ``path``
    (reference: gpry/io.py:41-59).
    """
    if path is None:
        return np.full(len(_CHECKPOINT_FILES), False)
    return np.array([os.path.exists(os.path.join(path, f))
                     for f in _CHECKPOINT_FILES])


def _dumps(obj):
    """Serialize with pickle, falling back to dill for what pickle cannot
    handle (lambdas, closures, locally defined classes)."""
    try:
        return pickle.dumps(obj)
    except (pickle.PicklingError, AttributeError, TypeError):
        pass
    try:
        import dill
    except ImportError as excpt:
        raise ImportError(
            "Checkpointing needs the 'dill' package: the checkpoint holds "
            "objects that the standard pickle cannot handle, such as a "
            "lambda or closure log-likelihood.  Install dill or pass a "
            "module-level function.") from excpt
    return dill.dumps(obj)


def _device_to_host(obj):
    """Recursively convert jax arrays in an object's __dict__ to numpy."""
    import jax
    state = getattr(obj, "__dict__", None)
    if state is None:
        return obj
    # per-factorization memo of cast device pytrees: rebuilt on demand,
    # never checkpointed (models/gp.py:sweep_params)
    state.pop("_sweep_cast_cache", None)
    for k, v in state.items():
        if isinstance(v, jax.Array):
            state[k] = ("__jax_array__", np.asarray(v))
    return obj


def _host_to_device(obj):
    import jax.numpy as jnp
    state = getattr(obj, "__dict__", None)
    if state is None:
        return obj
    for k, v in state.items():
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "__jax_array__":
            state[k] = jnp.asarray(v[1])
    return obj


def save_checkpoint(path, truth, gpr, acquisition, convergence, options,
                    progress, update_truth=True):
    """
    Save the six checkpoint objects (reference: gpry/io.py:110-156).
    With ``update_truth=False``, ``tru.pkl`` is written only if absent
    (the truth never changes during a run; reference: gpry/run.py:742-745).
    """
    if path is None:
        return
    create_path(path)
    objs = {
        "gpr.pkl": _device_to_host(gpr),
        "acq.pkl": acquisition,
        "con.pkl": convergence,
        "opt.pkl": options,
        "pro.pkl": progress,
    }
    if update_truth or not os.path.exists(os.path.join(path, "tru.pkl")):
        objs["tru.pkl"] = truth.as_dict() if hasattr(truth, "as_dict") \
            else truth
    # The GPR is mutated in place (device arrays -> host tuples) while
    # dumping; restore it even when a dump raises (e.g. an unpicklable user
    # loglike), or the live Runner would keep running with a corrupted GPR.
    #
    # Two-phase commit: every object is dumped to a ``*.tmp`` sibling
    # first, then all tmp files are renamed into place with os.replace
    # (atomic on POSIX).  A crash mid-dump (SIGKILL, OOM, disk full)
    # therefore NEVER leaves a truncated pickle behind — the crash-resume
    # machinery (run.Runner resume, run_resilient)
    # would otherwise retry an UnpicklingError forever.  The rename loop
    # narrows the mixed-generation window from seconds of pickling to
    # microseconds of metadata ops; a crash inside it can still mix two
    # adjacent generations, which resumes as a valid (seeded, coherent-
    # per-file) state one iteration apart — acceptable for an
    # active-learning loop, unlike truncation.
    tmp_written = []
    try:
        for fname, obj in objs.items():
            tmp = os.path.join(path, fname + ".tmp")
            with open(tmp, "wb") as f:
                f.write(_dumps(obj))
            tmp_written.append((tmp, os.path.join(path, fname)))
    except BaseException:
        for fname in objs:        # includes the partially-dumped one
            try:
                os.remove(os.path.join(path, fname + ".tmp"))
            except OSError:
                pass
        raise
    finally:
        # restore device arrays in the live object
        _host_to_device(gpr)
    for tmp, final in tmp_written:
        os.replace(tmp, final)


def read_checkpoint(path, truth=None):
    """
    Load the six checkpoint objects; returns
    (truth, gpr, acquisition, convergence, options, progress)
    (reference: gpry/io.py:62-107).
    """
    loaded = []
    for fname in _CHECKPOINT_FILES:
        full = os.path.join(path, fname)
        with open(full, "rb") as f:
            # a pickle written by dill imports dill while loading
            loaded.append(pickle.load(f))
    truth_dict, gpr, acq, con, opt, pro = loaded
    _host_to_device(gpr)
    if truth is None and isinstance(truth_dict, dict) and \
            "loglike" in truth_dict:
        from gpry_tpu.truth import Truth
        truth = Truth(**truth_dict)
    elif truth is None and isinstance(truth_dict, dict) and \
            truth_dict.get("model") is not None:
        # TruthCobaya round-trip: rebuild the Cobaya Model from its info
        # dict (reference: gpry/truth.py:165-237 + gpry/run.py:723)
        from cobaya.model import get_model
        from gpry_tpu.truth import TruthCobaya
        truth = TruthCobaya(get_model(truth_dict["model"]))
    elif truth is None:
        truth = truth_dict
    return truth, gpr, acq, con, opt, pro


def ensure_gpr(gpr):
    """
    Accept a GPR instance or a checkpoint path and return the GPR
    (reference: gpry/io.py:159-202).
    """
    if isinstance(gpr, str):
        path = gpr
        full = os.path.join(path, "gpr.pkl")
        if not os.path.exists(full):
            raise ValueError(f"No GPR checkpoint found at {path}.")
        with open(full, "rb") as f:
            out = pickle.load(f)
        return _host_to_device(out)
    return gpr
