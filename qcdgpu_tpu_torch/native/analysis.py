"""ctypes binding for the native time-series statistics library
(analysis/analysis.cpp, a copy of qcdgpu_tpu/native/analysis/analysis.cpp)
— port of qcdgpu_tpu/native/analysis.py, built into the checkout's build/
(build.py).

utils/stats.analyze_series takes its mean, variance, naive error and
binning plateau from here whenever the library builds, as the reference
does, so both packages report the same bits; a failed build makes
``available()`` false and analyze_series sums in numpy.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from .build import load_lib

_c_dp = ctypes.POINTER(ctypes.c_double)
_c_i64p = ctypes.POINTER(ctypes.c_int64)


@lru_cache(maxsize=1)
def _lib():
    lib = load_lib("analysis", ["analysis/analysis.cpp"])
    if lib is None:
        return None
    lib.series_moments.argtypes = [_c_dp, ctypes.c_int64, _c_dp, _c_dp, _c_dp]
    lib.binned_error.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_int64]
    lib.binned_error.restype = ctypes.c_double
    lib.plateau_error.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_int64, _c_i64p]
    lib.plateau_error.restype = ctypes.c_double
    lib.jackknife_mean.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_int64, _c_dp, _c_dp]
    lib.autocorr.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_int64, _c_dp]
    return lib


def available() -> bool:
    return _lib() is not None


def _require_lib():
    lib = _lib()
    if lib is None:
        raise RuntimeError(
            "native analysis library unavailable (g++ build failed); use "
            "the numpy estimators in qcdgpu_tpu_torch.utils.stats instead"
        )
    return lib


def _as_c(x):
    x = np.ascontiguousarray(x, np.float64)
    return x, x.ctypes.data_as(_c_dp), x.size


def series_moments(x):
    """(mean, population variance, naive error of the mean)."""
    lib = _require_lib()
    x, p, n = _as_c(x)
    m = ctypes.c_double()
    v = ctypes.c_double()
    e = ctypes.c_double()
    lib.series_moments(p, n, ctypes.byref(m), ctypes.byref(v), ctypes.byref(e))
    return m.value, v.value, e.value


def binned_error(x, bin_size: int) -> float:
    lib = _require_lib()
    if bin_size < 1:
        # the C code integer-divides by bin_size; a 0 would SIGFPE the
        # whole process, not raise
        raise ValueError(f"bin_size must be >= 1, got {bin_size}")
    x, p, n = _as_c(x)
    return lib.binned_error(p, n, bin_size)


def plateau_error(x, min_bins: int = 8):
    """(err, plateau_bin_size)."""
    lib = _require_lib()
    if min_bins < 1:
        # n / bs >= 0 would never terminate the doubling loop in C
        raise ValueError(f"min_bins must be >= 1, got {min_bins}")
    x, p, n = _as_c(x)
    bs = ctypes.c_int64()
    e = lib.plateau_error(p, n, min_bins, ctypes.byref(bs))
    return e, bs.value


def jackknife_mean(x, bin_size: int = 1):
    """(estimate, error) of the mean by a delete-one-bin jackknife."""
    lib = _require_lib()
    if bin_size < 1:
        raise ValueError(f"bin_size must be >= 1, got {bin_size}")
    x, p, n = _as_c(x)
    est = ctypes.c_double()
    err = ctypes.c_double()
    lib.jackknife_mean(p, n, bin_size, ctypes.byref(est), ctypes.byref(err))
    return est.value, err.value


def autocorr(x, maxlag: int):
    """Normalized autocorrelation rho[0..maxlag]."""
    lib = _require_lib()
    if maxlag < 0:
        raise ValueError(f"maxlag must be >= 0, got {maxlag}")
    x, p, n = _as_c(x)
    rho = np.empty(maxlag + 1, np.float64)
    lib.autocorr(p, n, maxlag, rho.ctypes.data_as(_c_dp))
    return rho
