"""ctypes bindings to the native C++ DTW / DBA engine (``native/dtw.cpp``).

A framework-free host engine: squared DTW, pairwise costs and medoid-init
DBA on float64 numpy arrays, OpenMP-parallel over models in
:func:`dba_batch`.  It serves as an independent oracle for the DTW paths;
nothing on the port's device path calls it or falls back to it.

The shared library is built with g++ at first use into ``build/native/``
at the repository root (named by the source's hash, so an edited source is
rebuilt and a stale build never loads), atomically: a temporary file then
``os.replace``.  Without a compiler every entry point reports unavailable
(:func:`available` is False) and raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import typing as tp

import numpy as np

__all__ = ["available", "squared_dtw", "dtw_pairwise", "dba", "dba_batch"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dtw.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build",
                         "native")

_lib: tp.Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library of the current source is (or will be) built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libbetdtw_{digest}.so")


def _build(out: str) -> bool:
    """Compile dtw.cpp to ``out`` atomically (a temporary file, then
    ``os.replace``): a killed build or a concurrent reader never sees a
    truncated library at ``out``."""
    if not os.path.exists(_SRC):
        return False
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.build{os.getpid()}"
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd[:2] + ["-fopenmp"] + cmd[2:], check=True, capture_output=True,
                           timeout=120)
        except subprocess.SubprocessError:
            # a toolchain without libgomp still gets the serial build
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.bet_squared_dtw.restype = ctypes.c_double
    lib.bet_squared_dtw.argtypes = [dptr, dptr, ctypes.c_int]
    lib.bet_dtw_pairwise.restype = None
    lib.bet_dtw_pairwise.argtypes = [dptr, ctypes.c_int, ctypes.c_int, dptr]
    lib.bet_dba.restype = None
    lib.bet_dba.argtypes = [dptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, dptr]
    lib.bet_dba_batch.restype = None
    lib.bet_dba_batch.argtypes = [dptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  dptr]
    return lib


def _load() -> tp.Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        _lib = _bind(ctypes.CDLL(path))
    except (OSError, AttributeError):
        # A library at the path that does not load (not one this module
        # built): rebuild once under a unique name, since dlopen hands back
        # an already-mapped object by pathname, and move it into place.
        fresh = f"{path}.r{os.getpid()}"
        _lib = None
        if _build(fresh):
            try:
                _lib = _bind(ctypes.CDLL(fresh))
                os.replace(fresh, path)
            except (OSError, AttributeError):
                _lib = None
        if _lib is None and os.path.exists(fresh):
            os.remove(fresh)
    return _lib


def available() -> bool:
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native DTW library unavailable (no g++ to build native/dtw.cpp?)")
    return lib


def _as_c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


_DP = ctypes.POINTER(ctypes.c_double)


def squared_dtw(a: np.ndarray, b: np.ndarray) -> float:
    """Squared-DTW cost of two equal-length 1-D series."""
    lib = _library()
    a, b = _as_c(a), _as_c(b)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("equal-length 1-D series required")
    return float(lib.bet_squared_dtw(a.ctypes.data_as(_DP), b.ctypes.data_as(_DP), len(a)))


def dtw_pairwise(series: np.ndarray) -> np.ndarray:
    """``(R, R)`` squared-DTW costs between the rows of ``series (R, T)``."""
    lib = _library()
    s = _as_c(series)
    r, t = s.shape
    out = np.empty((r, r), dtype=np.float64)
    lib.bet_dtw_pairwise(s.ctypes.data_as(_DP), r, t, out.ctypes.data_as(_DP))
    return out


def dba(series: np.ndarray, n_iterations: int = 10) -> np.ndarray:
    """DBA barycentre of ``series (R, T)`` from the medoid."""
    lib = _library()
    s = _as_c(series)
    r, t = s.shape
    out = np.empty((t,), dtype=np.float64)
    lib.bet_dba(s.ctypes.data_as(_DP), r, t, n_iterations, out.ctypes.data_as(_DP))
    return out


def dba_batch(series: np.ndarray, n_iterations: int = 10) -> np.ndarray:
    """DBA for a whole ``(B, R, T)`` stack of models, OpenMP-parallel over B
    (medoid init, as :func:`dba`)."""
    lib = _library()
    s = _as_c(series)
    b, r, t = s.shape
    out = np.empty((b, t), dtype=np.float64)
    lib.bet_dba_batch(s.ctypes.data_as(_DP), b, r, t, n_iterations, out.ctypes.data_as(_DP))
    return out
