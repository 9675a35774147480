"""Building blocks shared by the plain PyTorch versions of the kernels.

Port of qcdgpu_tpu/ops/pallas/core.py.  The CUDA kernels carry the same
helpers as device functions in csrc/common.cuh; keep the two in step.

Packed state (the reference's layout): one f32 array per (direction mu,
parity p), ``us[2*mu + p]`` of shape ``[2, N, 2, X, Y, Z*T/2]`` — stored
matrix row (two rows: all of SU(2); SU(3) row 2 = conj(row0 x row1) is
rebuilt on load),
column, re/im, then the sites.  The array of parity p holds the links whose
base site (x, y, z, t) has (x+y+z+t) % 2 == p, at

    slot = ((x*Y + y)*Z + z)*(T/2) + t//2,    t = 2k + (p + x + y + z) % 2.

Neighbours are addressed DIRECTLY: decode a slot to (x, y, z, t), step the
coordinate with periodic wrap, re-encode into the array of the other parity.
This replaces the reference's roll-and-mask shifts (``shift_comp_packed`` /
``_tau_mask``), which exist because a TPU kernel sees whole [Y, Z*T/2]
slabs.  The plain versions use the formula as gather-index tensors, built
once per (dims, parity, shifts, device); the CUDA kernels compute it inline.

Inside the plain versions a complex number is a ``(re, im)`` pair of f32
tensors over the sites and a matrix is an N x N nested tuple of them, with
the reference's operation order (``cmul`` etc.), so that the plain version,
the CUDA kernel (built with ``-fmad=false``) and the reference round alike.
"""

from __future__ import annotations

from functools import lru_cache

import torch

# ---------------------------------------------------------------------------
# complex scalars as (re, im) pairs
# ---------------------------------------------------------------------------


def cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cmul_conj(a, b):
    """a * conj(b)."""
    return (a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1])


def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def conj(a):
    return (a[0], -a[1])


# ---------------------------------------------------------------------------
# matrices as N x N nested tuples of complex pairs
# ---------------------------------------------------------------------------


def mmul(a, b):
    """Matrix product of two nested-tuple matrices."""
    n, kk, m = len(a), len(b), len(b[0])
    out = []
    for i in range(n):
        row = []
        for k in range(m):
            acc = cmul(a[i][0], b[0][k])
            for j in range(1, kk):
                acc = cadd(acc, cmul(a[i][j], b[j][k]))
            row.append(acc)
        out.append(tuple(row))
    return tuple(out)


def mmul_bdag(a, b):
    """a @ b^dagger without materializing the dagger."""
    n, kk, m = len(a), len(a[0]), len(b)
    out = []
    for i in range(n):
        row = []
        for k in range(m):
            acc = cmul_conj(a[i][0], b[k][0])
            for j in range(1, kk):
                acc = cadd(acc, cmul_conj(a[i][j], b[k][j]))
            row.append(acc)
        out.append(tuple(row))
    return tuple(out)


def mdag(a):
    n = len(a)
    return tuple(tuple(conj(a[j][i]) for j in range(n)) for i in range(n))


def madd(a, b):
    return tuple(
        tuple(cadd(a[i][j], b[i][j]) for j in range(len(a[0])))
        for i in range(len(a))
    )


def _codec_rows(rows, n):
    """Two stored rows -> full N x N matrix: SU(2) stores the whole matrix;
    SU(3) rebuilds row2 = conj(r0 x r1)."""
    if n == 2:
        return (tuple(rows[0]), tuple(rows[1]))
    if n != 3:
        raise ValueError(f"packed links are SU(2) or SU(3), got N={n}")
    r0, r1 = rows

    def r2k(k):
        a = cmul(r0[(k + 1) % 3], r1[(k + 2) % 3])
        b = cmul(r0[(k + 2) % 3], r1[(k + 1) % 3])
        return conj((a[0] - b[0], a[1] - b[1]))

    return (r0, r1, tuple(r2k(k) for k in range(3)))


# ---------------------------------------------------------------------------
# packed addressing
# ---------------------------------------------------------------------------


def packed_coords(parity, dims, device):
    """(x, y, z, t) int64 tensors [X*Y*Z*T/2] of the packed slots of one
    parity, in slot order."""
    x_dim, y_dim, z_dim, t_dim = dims
    t2 = t_dim // 2
    s = torch.arange(x_dim * y_dim * z_dim * t2, dtype=torch.int64,
                     device=device)
    k = s % t2
    z = (s // t2) % z_dim
    y = (s // (t2 * z_dim)) % y_dim
    x = s // (t2 * z_dim * y_dim)
    t = 2 * k + (parity + x + y + z) % 2
    return x, y, z, t


def packed_slot(x, y, z, t, dims):
    """Slot of site (x, y, z, t) in the array of its own parity."""
    _, y_dim, z_dim, t_dim = dims
    return ((x * y_dim + y) * z_dim + z) * (t_dim // 2) + t // 2


@lru_cache(maxsize=None)
def neighbor_slots(parity, dims, shifts, device):
    """int64 [X*Y*Z*T/2]: for each slot of parity ``parity``, the slot of
    the site displaced by ``shifts`` ((axis, +-1), ...) — in the array of
    parity (parity + len(shifts)) % 2.  Cached; callers must not mutate."""
    c = list(packed_coords(parity, dims, device))
    for ax, d in shifts:
        c[ax] = (c[ax] + d) % dims[ax]
    return packed_slot(*c, dims)


def site_index_packed(parity, dims, device):
    """int64 [X, Y, Z*T/2] of global DENSE site indices of the packed slots
    (the threefry counter; equal to ops.lattice.site_index on the dense
    lattice, so both layouts draw the same numbers per physical site)."""
    x_dim, y_dim, z_dim, t_dim = dims
    x, y, z, t = packed_coords(parity, dims, device)
    idx = ((x * y_dim + y) * z_dim + z) * t_dim + t
    return idx.reshape(x_dim, y_dim, z_dim * (t_dim // 2))


def load_mat(arr, n, idx=None):
    """Packed array [2, N, 2, X, Y, ZT2] -> N x N matrix tuple over the
    slots ``idx`` (all slots in order when None)."""
    comps = arr.reshape(2, n, 2, -1)
    if idx is not None:
        comps = comps.index_select(3, idx)
    rows = [tuple((comps[r, j, 0], comps[r, j, 1]) for j in range(n))
            for r in range(2)]
    return _codec_rows(rows, n)


class LinkLoader:
    """Loads U_d at (base site of parity p) + shifts from the packed
    8-tuple, through cached neighbour-slot gathers (each (d, shifts)
    gathered once per loader)."""

    def __init__(self, us, parity, dims, n):
        self.us, self.p, self.dims, self.n = us, parity, tuple(dims), n
        self.device = us[0].device
        self._cache = {}

    def U(self, d, shifts=()):
        key = (d, shifts)
        if key not in self._cache:
            par = (self.p + len(shifts)) % 2
            idx = (neighbor_slots(self.p, self.dims, shifts, self.device)
                   if shifts else None)
            self._cache[key] = load_mat(self.us[2 * d + par], self.n, idx)
        return self._cache[key]


def store_rows(arr, m, n):
    """Write the first two rows of matrix tuple m into packed array arr."""
    out = torch.stack([
        torch.stack([torch.stack([m[r][j][0], m[r][j][1]]) for j in range(n)])
        for r in range(2)
    ])
    arr.copy_(out.reshape(arr.shape))


def check_packed(arr, n, dims, name="links"):
    """Raise unless arr is a contiguous f32 packed array for (n, dims)."""
    shape = (2, n, 2, dims[0], dims[1], dims[2] * (dims[3] // 2))
    if arr.dtype != torch.float32 or tuple(arr.shape) != shape:
        raise ValueError(
            f"{name}: expected float32 {shape}, got {arr.dtype} "
            f"{tuple(arr.shape)}"
        )
    if not arr.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_device(*tensors):
    """'cpu' or 'cuda' for tensors that all lie on one such device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type
