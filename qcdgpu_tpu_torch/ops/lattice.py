"""4D lattice geometry on the dense site grid [X, Y, Z, T].

Port of qcdgpu_tpu/ops/lattice.py: periodic shifts of a per-direction
field ``[N, N, X, Y, Z, T]``, parity masks and global site indices.  The
lattice axes are the LAST four of a field (axis mu at -4 + mu), so a field
with batch axes before them, such as the dense engine's chain axis of a
beta scan ``[N, N, C, X, Y, Z, T]``, shifts every chain at once.
"""

from __future__ import annotations

import torch

NDIM = 4
SITE_AXIS0 = -4  # first lattice axis of a field, counted from the end


def shift(f, mu, d):
    """f'(x) = f(x + d * mu_hat) for a [N, N, *dims] field (periodic)."""
    return torch.roll(f, -d, dims=SITE_AXIS0 + mu)


def shift2(f, mu, dmu, nu, dnu):
    """Two-axis shift: f'(x) = f(x + dmu*mu_hat + dnu*nu_hat)."""
    return torch.roll(f, (-dmu, -dnu), dims=(SITE_AXIS0 + mu, SITE_AXIS0 + nu))


def _coords(dims, device):
    return torch.meshgrid(
        *[torch.arange(d, dtype=torch.int64, device=device) for d in dims],
        indexing="ij",
    )


def parity_mask(dims, parity, device):
    """Boolean [X, Y, Z, T] mask of sites with (x+y+z+t) % 2 == parity."""
    return (sum(_coords(dims, device)) % 2) == parity


def site_index(dims, device):
    """int64 [X, Y, Z, T] global linear site index (row-major over dims)."""
    x, y, z, t = _coords(dims, device)
    return ((x * dims[1] + y) * dims[2] + z) * dims[3] + t
