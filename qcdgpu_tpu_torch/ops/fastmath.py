"""Polynomial transcendentals for the Kennedy–Pendleton sampler.

Port of qcdgpu_tpu/ops/fastmath.py: the same coefficients, rounded to f32
as the reference rounds them, and the same operation order, so that the
plain PyTorch stage, the CUDA stage kernel (csrc/common.cuh, built with
``-fmad=false``) and the reference draw the same samples.

- ``log_u01``: ln(x) for a uniform x in (0, 1) — cephes mantissa/exponent
  split, no special cases.
- ``cos2_2pi`` / ``sincos_2pi``: cos(2 pi r)**2 and (sin, cos)(2 pi r) for
  r in [0, 1) — one-round range reduction shared by sin and cos.

``torch.round`` rounds half to even, as ``jnp.round`` does (the kernel uses
``rintf``).  Bit views go through ``Tensor.view(torch.int32)``.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(c) -> float:
    """A Python float holding exactly the f32 rounding of c.

    Every f32 op with such a scalar gives the f32 op's result whether torch
    evaluates it in f32 or in f64 and rounds (f64 has more than 2*24+2
    mantissa bits)."""
    return float(np.float32(c))


_LOG_COEF = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
# Taylor coefficients of cos(2*pi*f) in s = f**2 (|f| <= 1/4)
_COS_COEF = tuple(f32(c) for c in (
    -26.426256783374378, 60.24464137187666, -85.45681720669372,
    64.93939402266829, -19.739208802178716, 1.0,
))
# sin(2*pi*f) / f in s = f**2
_SIN_COEF = tuple(f32(c) for c in (
    3.8199525848482803, -15.094642576822984, 42.058693944897634,
    -76.70585975306136, 81.60524927607504, -41.341702240399755,
    6.283185307179586,
))
_SQRT2 = f32(1.41421356)
_LN2_LO = f32(-2.12194440e-4)
_LN2_HI = f32(0.693359375)


def log_u01(x):
    """ln(x) for x a positive normal f32 in (0, 1]."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, 0.5 * m, m)
    e = torch.where(big, e + 1, e).to(torch.float32)
    t = m - 1.0
    z = t * t
    p = torch.full_like(t, _LOG_COEF[0])
    for c in _LOG_COEF[1:]:
        p = p * t + c
    y = t * z * p - 0.5 * z + e * _LN2_LO
    return t + y + e * _LN2_HI


def _poly_s(coef, s):
    p = torch.full_like(s, coef[0])
    for c in coef[1:]:
        p = p * s + c
    return p


def cos2_2pi(r):
    """cos(2*pi*r)**2 for r in [0, 1) (the KP trial uses only the square,
    so the quadrant sign is skipped)."""
    k = torch.round(2.0 * r)
    f = r - 0.5 * k
    p = _poly_s(_COS_COEF, f * f)
    return p * p


def sincos_2pi(r):
    """(sin(2*pi*r), cos(2*pi*r)) for r in [0, 1), sharing the fold."""
    k = torch.round(2.0 * r)
    f = r - 0.5 * k
    # (-1)^k without int conversion: k is exactly 0, 1, or 2 here
    sign = 1.0 - 2.0 * (k - 2.0 * torch.floor(k * 0.5))
    s = f * f
    return sign * f * _poly_s(_SIN_COEF, s), sign * _poly_s(_COS_COEF, s)
