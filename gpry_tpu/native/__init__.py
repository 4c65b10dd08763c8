"""
Native (C++) host components, loaded via ctypes.

Currently: the SMO C-SVC trainer (svc_smo.cpp), replacing the reference's
libsvm dependency for the infinities-classifier fit.  Compiled lazily with
g++ on first use and cached next to the source.
"""

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "svc_smo.cpp")
_LIB = os.path.join(_DIR, "libsvc_smo.so")
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or \
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        cmd = ["g++", "-O3", "-fPIC", "-shared", _SRC, "-o", _LIB + ".tmp"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(_LIB + ".tmp", _LIB)
        except (subprocess.CalledProcessError, OSError) as excpt:
            stderr = getattr(excpt, "stderr", None) or ""
            raise NativeBuildError(
                f"Building {os.path.basename(_SRC)} failed: {excpt}\n"
                f"command: {' '.join(cmd)}\n{stderr}".rstrip()
            ) from excpt
    lib = ctypes.CDLL(_LIB)
    lib.svc_train_rbf.restype = ctypes.c_int
    lib.svc_train_rbf.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return lib


def available():
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def train_rbf_svc(X, y_bool, C=1e7, gamma=None, tol=1e-3, max_iter=0):
    """
    Train a binary RBF C-SVC; returns (support_vectors, signed dual coefs,
    intercept, gamma).  ``y_bool`` True = positive class ("finite").
    ``gamma=None`` uses sklearn's "scale": 1 / (d * X.var()).
    """
    lib = _load()
    X = np.ascontiguousarray(X, dtype=np.float64)
    n, d = X.shape
    y = np.ascontiguousarray(y_bool, dtype=np.int32)
    if gamma is None:
        var = float(X.var())
        gamma = 1.0 / (d * var) if var > 0 else 1.0
    alpha = np.zeros(n, dtype=np.float64)
    b = ctypes.c_double(0.0)
    iters = lib.svc_train_rbf(
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, d, float(C), float(gamma), float(tol), int(max_iter),
        alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(b))
    if iters < 0:
        raise RuntimeError("svc_train_rbf failed (invalid arguments).")
    sv = np.abs(alpha) > 1e-12
    return X[sv], alpha[sv], float(b.value), float(gamma)
