"""ctypes bindings for the native C++ runtime (native/altro_native.cpp).

The native kernel is the latency-critical single-solve host path — the
JAX framework's counterpart to the reference's embedded deployment
target. The shared library is built on demand with g++ (no pybind11 in
this image; plain C ABI + ctypes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "altro_native.cpp")
_SRC2 = os.path.join(_HERE, "..", "..", "native", "altro_solver_native.cpp")
_SO = os.path.join(_HERE, "..", "..", "native", "build", "libaltro_native.so")

_lib: Optional[ctypes.CDLL] = None
SUCCESS = -1


def _build() -> str:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
        _SRC, _SRC2, "-o", _SO,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so = _SO
    if not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(_SRC), os.path.getmtime(_SRC2)
    ):
        so = _build()
    lib = ctypes.CDLL(so)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.altro_tvlqr_work_size.restype = ctypes.c_size_t
    lib.altro_tvlqr_work_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.altro_tvlqr_backward.restype = ctypes.c_int
    lib.altro_tvlqr_backward.argtypes = (
        [ctypes.c_int] * 3 + [dp] * 8 + [ctypes.c_double] + [dp] * 6
    )
    lib.altro_tvlqr_forward.restype = ctypes.c_int
    lib.altro_tvlqr_forward.argtypes = [ctypes.c_int] * 3 + [dp] * 11
    lib.altro_cubic_fit.restype = ctypes.c_int
    lib.altro_cubic_fit.argtypes = [ctypes.c_double] * 6 + [dp]
    lib.altro_cubic_argmin.restype = ctypes.c_int
    lib.altro_cubic_argmin.argtypes = [dp, dp]
    _lib = lib
    return lib


def is_available() -> bool:
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def tvlqr_backward(A, B, f, lxx, luu, lux, lx, lu, reg=0.0):
    """Native Riccati backward pass (f64, zero allocation inside the kernel).

    Same stacked layout as altro_tpu.tvlqr.tvlqr_backward. Returns
    (K, d, P, p, dV, ok, fail_index).
    """
    lib = load()
    A = np.ascontiguousarray(A, np.float64)
    B = np.ascontiguousarray(B, np.float64)
    f = np.ascontiguousarray(f, np.float64)
    lxx = np.ascontiguousarray(lxx, np.float64)
    luu = np.ascontiguousarray(luu, np.float64)
    lux = np.ascontiguousarray(lux, np.float64)
    lx = np.ascontiguousarray(lx, np.float64)
    lu = np.ascontiguousarray(lu, np.float64)
    N, n, m = A.shape[0], A.shape[1], B.shape[2]
    K = np.zeros((N, m, n))
    d = np.zeros((N, m))
    P = np.zeros((N + 1, n, n))
    p = np.zeros((N + 1, n))
    dV = np.zeros(2)
    work = np.zeros(lib.altro_tvlqr_work_size(n, m) // 8)
    res = lib.altro_tvlqr_backward(
        n, m, N, _p(A), _p(B), _p(f), _p(lxx), _p(luu), _p(lux), _p(lx), _p(lu),
        ctypes.c_double(reg), _p(K), _p(d), _p(P), _p(p), _p(dV), _p(work),
    )
    ok = res == SUCCESS
    return K, d, P, p, dV, ok, (N if ok else res)


def tvlqr_forward(A, B, f, K, d, P, p, x0):
    lib = load()
    A = np.ascontiguousarray(A, np.float64)
    B = np.ascontiguousarray(B, np.float64)
    f = np.ascontiguousarray(f, np.float64)
    K = np.ascontiguousarray(K, np.float64)
    d = np.ascontiguousarray(d, np.float64)
    P = np.ascontiguousarray(P, np.float64)
    p = np.ascontiguousarray(p, np.float64)
    x0 = np.ascontiguousarray(x0, np.float64)
    N, n, m = A.shape[0], A.shape[1], B.shape[2]
    x = np.zeros((N + 1, n))
    u = np.zeros((N, m))
    y = np.zeros((N + 1, n))
    lib.altro_tvlqr_forward(
        n, m, N, _p(A), _p(B), _p(f), _p(K), _p(d), _p(P), _p(p), _p(x0),
        _p(x), _p(u), _p(y),
    )
    return x, u, y


def cubic_argmin(x1, y1, d1, x2, y2, d2):
    """Fit + argmin; returns (x_min, found)."""
    lib = load()
    coeffs = np.zeros(5)
    if lib.altro_cubic_fit(x1, y1, d1, x2, y2, d2, _p(coeffs)) != 0:
        return float("nan"), False
    out = np.zeros(1)
    ok = lib.altro_cubic_argmin(_p(coeffs), _p(out)) == 0
    return float(out[0]), ok
