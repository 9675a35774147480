"""APE link smearing (and its alpha -> 1 "cooling" limit).

Port of qcdgpu_tpu/ops/smear.py.  Smearing suppresses ultraviolet
fluctuations so that the clover topological charge (ops/measure.py
topological_charge) approaches near-integer values on Monte Carlo
configurations.  One APE step replaces every link at once by the SU(N)
projection of a convex mix of itself and its six staple paths:

    U_mu(x) -> Proj_SU(N)[ (1 - alpha) U_mu(x) + (alpha / 6) S_mu(x) ]

with S_mu(x) = dagger(staples.staple_sum(u, mu)).  The projection is the
polar one, W = X (X^+ X)^(-1/2) divided by the principal det(W)^(1/N)
phase, which is exactly gauge covariant, Proj(g X h) = g Proj(X) h; for
SU(2) the quaternion normalisation is that projection.  Cold starts and
abelian constant-flux backgrounds are fixed points.
"""

from __future__ import annotations

import torch

from .lattice import NDIM
from .staples import staple_sum
from .sun import dagger, det, mat_to_quat, quat_to_mat


# Matrices per torch.linalg.eigh call: on the H100 (torch 2.11, CUDA 12.8)
# cuSOLVER's batched solver takes 16384 3x3 matrices a call and refuses
# 32768 or more with CUSOLVER_STATUS_INVALID_VALUE.  While it runs, a call
# holds a workspace of 518 KiB a matrix, 8.3 GiB at 16384 whatever the
# lattice; smaller chunks hold less and take longer (an APE step at SU(3)
# 32^4: 182 ms at 16384, 266 at 4096, 375 at 2048;
# tools/port_eigh_probe.py).  Each matrix is solved on its own, so the
# chunks change no bit.
EIGH_CHUNK = 1 << 14


def _eigh(h):
    """torch.linalg.eigh over the leading batch, EIGH_CHUNK at a time."""
    flat = h.reshape((-1,) + tuple(h.shape[-2:]))
    parts = [torch.linalg.eigh(c) for c in torch.split(flat, EIGH_CHUNK)]
    ev = torch.cat([p[0] for p in parts])
    v = torch.cat([p[1] for p in parts])
    return (ev.reshape(h.shape[:-1]), v.reshape(h.shape))


def project_sun_polar(x):
    """Gauge-covariant SU(N) polar projection of [N, N, *site_dims].

    SU(2): quaternion normalisation.  SU(3): W = X (X^+ X)^(-1/2) through
    the batched 3x3 Hermitian eigendecomposition (eigenvalues clamped at
    1e-30), then the principal det^(1/3) phase divided out."""
    n = x.shape[0]
    if n == 2:
        q = mat_to_quat(x)
        q = q / torch.sqrt(torch.sum(q * q, dim=0))
        return quat_to_mat(q, x.dtype)
    xm = torch.movedim(x, (0, 1), (-2, -1))  # [*sites, N, N]
    h = xm.mH @ xm
    ev, v = _eigh(h)
    ev = torch.clamp(ev, min=1e-30)
    inv_sqrt = (v * (1.0 / torch.sqrt(ev))[..., None, :]) @ v.mH
    wm = xm @ inv_sqrt
    # the determinant by cofactors (elementwise), where the reference's
    # jnp.linalg.det factors each matrix
    d = det(torch.movedim(wm, (-2, -1), (0, 1)))
    wm = wm / (d ** (1.0 / 3.0))[..., None, None]
    return torch.movedim(wm, (-2, -1), (0, 1)).to(x.dtype)


def ape_smear_step(u, alpha):
    """One simultaneous APE step on a [4, N, N, *site_dims] link field."""
    new = []
    for mu in range(NDIM):
        s = dagger(staple_sum(u, mu))
        x = (1.0 - alpha) * u[mu] + (alpha / 6.0) * s
        new.append(project_sun_polar(x))
    return torch.stack(new)


def ape_smear(u, alpha=0.5, n_iter=1):
    """n_iter APE steps (alpha = 1 with several iterations is projection
    cooling)."""
    for _ in range(n_iter):
        u = ape_smear_step(u, alpha)
    return u
