"""Staple sums of the Wilson one-plaquette action on the dense field.

Port of qcdgpu_tpu/ops/staples.py.  For the link U_mu(x) the 2*(d-1) = 6
staples are

  forward (nu != mu):  V  = U_nu(x+mu) U_mu(x+nu)^+ U_nu(x)^+
  backward:            V' = U_nu(x+mu-nu)^+ U_mu(x-nu)^+ U_nu(x-nu)

so that every plaquette containing U_mu(x) appears once in Re tr(U_mu(x) A)
with A the sum of the staples.  The packed engine's stage kernels gather
their staples in-kernel; this dense form serves APE smearing (ops/smear.py).
"""

from __future__ import annotations

from .lattice import NDIM, shift, shift2
from .sun import dagger, mul


def staple_sum(u, mu):
    """Sum of the 6 staples of direction ``mu``.

    u: [4, N, N, X, Y, Z, T] link field.  Returns [N, N, X, Y, Z, T]."""
    umu = u[mu]
    acc = None
    for nu in range(NDIM):
        if nu == mu:
            continue
        unu = u[nu]
        fwd = mul(shift(unu, mu, +1), dagger(mul(unu, shift(umu, nu, +1))))
        # U_nu(x+mu-nu)^+ U_mu(x-nu)^+ U_nu(x-nu)
        #   = [U_mu(x-nu) U_nu(x+mu-nu)]^+ U_nu(x-nu)
        bwd = mul(
            dagger(mul(shift(umu, nu, -1), shift2(unu, mu, +1, nu, -1))),
            shift(unu, nu, -1),
        )
        term = fwd + bwd
        acc = term if acc is None else acc + term
    return acc
