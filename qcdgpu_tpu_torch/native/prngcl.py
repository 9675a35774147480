"""ctypes binding for the native reference-RNG suite (prngcl/prngcl.cpp, a
copy of qcdgpu_tpu/native/prngcl/prngcl.cpp) — port of
qcdgpu_tpu/native/prngcl.py, built into the checkout's build/ (build.py).

Generator registry mirrors the PRNGCL family: ranlux0..ranlux4 (ranlux3 is
the reference default), ranmar, xor128, xor7, mrg32k3a, parkmiller,
constant.  `fill(name, seed, n)` returns n float64 uniforms in [0, 1);
`threefry2x32` is the native threefry that ops/rng.py is checked against.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from .build import load_lib

GENERATORS = (
    "ranlux0", "ranlux1", "ranlux2", "ranlux3", "ranlux4",
    "ranmar", "xor128", "xor7", "mrg32k3a", "parkmiller", "constant",
)

_c_dp = ctypes.POINTER(ctypes.c_double)
_c_u32p = ctypes.POINTER(ctypes.c_uint32)


@lru_cache(maxsize=1)
def _lib():
    lib = load_lib("prngcl", ["prngcl/prngcl.cpp"])
    if lib is None:
        return None
    lib.ranlux_fill.argtypes = [ctypes.c_uint64, ctypes.c_int, _c_dp, ctypes.c_int64]
    for f in ("ranmar_fill", "xor128_fill", "xor7_fill", "mrg32k3a_fill",
              "parkmiller_fill"):
        getattr(lib, f).argtypes = [ctypes.c_uint64, _c_dp, ctypes.c_int64]
    lib.constant_fill.argtypes = [ctypes.c_double, _c_dp, ctypes.c_int64]
    lib.threefry2x32.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, _c_u32p, _c_u32p, _c_u32p, _c_u32p,
        ctypes.c_int64,
    ]
    return lib


def available() -> bool:
    return _lib() is not None


def fill(name: str, seed: int, n: int, constant_value: float = 0.5) -> np.ndarray:
    """n uniforms from the named generator (float64, [0, 1))."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native prngcl library unavailable (g++ build failed)")
    if name not in GENERATORS:
        raise ValueError(f"unknown generator {name!r}; have {GENERATORS}")
    out = np.empty(n, np.float64)
    p = out.ctypes.data_as(_c_dp)
    if name.startswith("ranlux"):
        lib.ranlux_fill(seed, int(name[-1]), p, n)
    elif name == "constant":
        lib.constant_fill(constant_value, p, n)
    else:
        getattr(lib, f"{name}_fill")(seed, p, n)
    return out


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Native threefry — for bitwise cross-checks against ops/rng.py."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native prngcl library unavailable")
    x0 = np.ascontiguousarray(x0, np.uint32)
    x1 = np.ascontiguousarray(x1, np.uint32)
    if x0.size != x1.size:
        # n is taken from x0; a shorter x1 would be read out of bounds in C
        raise ValueError(f"counter arrays differ in size: {x0.size} vs {x1.size}")
    n = x0.size
    y0 = np.empty(n, np.uint32)
    y1 = np.empty(n, np.uint32)
    lib.threefry2x32(
        k0, k1,
        x0.ctypes.data_as(_c_u32p), x1.ctypes.data_as(_c_u32p),
        y0.ctypes.data_as(_c_u32p), y1.ctypes.data_as(_c_u32p), n,
    )
    return y0, y1
