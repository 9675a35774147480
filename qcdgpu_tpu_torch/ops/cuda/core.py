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
from typing import NamedTuple

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


class Shard(NamedTuple):
    """One shard of an X/Y-decomposed lattice (csrc/common.cuh ShardDims).

    Its packed arrays are ``[2, N, 2, lx + 2*hx, ly + 2*hy, Z*T/2]``: the
    interior is the plain X/Y slice ``[x0:x0+lx, y0:y0+ly]`` of the global
    packed array, and an axis that is split over the mesh (hx / hy = 1)
    carries one halo slab on each side holding the neighbouring shards'
    boundary slabs (the reference's ``local_x`` / ``local_y`` > 0 contract,
    ops/pallas/update.py:602-616).  An axis that is not split wraps
    periodically inside the shard.  Sites are addressed in interior
    coordinates (-1 and lx / ly reach the halos); parity and the threefry
    counter use the global ones."""

    dims: tuple    # the global lattice (X, Y, Z, T)
    local: tuple   # interior extents (lx, ly)
    offset: tuple  # global (x0, y0) of the first interior slab and row
    halo: tuple    # (hx, hy): 1 where the axis is split

    @property
    def interior(self):
        return (self.local[0], self.local[1]) + tuple(self.dims[2:])

    @property
    def padded(self):
        return ((self.local[0] + 2 * self.halo[0],
                 self.local[1] + 2 * self.halo[1]) + tuple(self.dims[2:]))

    def kernel_args(self):
        """The geometry as the C entry points take it: lx, ly, Z, T, hx,
        hy, x0, y0, global Y."""
        return tuple(int(v) for v in (*self.interior, *self.halo,
                                      *self.offset, self.dims[1]))


def whole(dims) -> Shard:
    """The unsharded lattice as a Shard: no halo, no offset."""
    dims = tuple(int(d) for d in dims)
    return Shard(dims, dims[:2], (0, 0), (0, 0))


def padded_or_none(shard):
    """``shard``, or None when it has no halo: an axis is padded exactly
    when it is split, so a Shard without halo is the whole lattice, which
    the unsharded kernels run (on arrays the callers check to be the
    whole lattice's)."""
    return None if shard is None or shard.halo == (0, 0) else shard


def packed_coords(parity, dims, device, offset=(0, 0)):
    """(x, y, z, t) int64 tensors [X*Y*Z*T/2] of the packed slots of one
    parity, in slot order; with ``offset`` (a shard's (x0, y0)), dims are
    its interior extents and t follows the global parity rule."""
    x_dim, y_dim, z_dim, t_dim = dims
    t2 = t_dim // 2
    s = torch.arange(x_dim * y_dim * z_dim * t2, dtype=torch.int64,
                     device=device)
    k = s % t2
    z = (s // t2) % z_dim
    y = (s // (t2 * z_dim)) % y_dim
    x = s // (t2 * z_dim * y_dim)
    t = 2 * k + (parity + x + offset[0] + y + offset[1] + z) % 2
    return x, y, z, t


def packed_slot(x, y, z, t, dims, halo=(0, 0)):
    """Slot of site (x, y, z, t) in the array of its own parity; with
    ``halo``, dims are a shard's interior extents, the array is padded and
    x, y may reach the halos (-1, lx / ly)."""
    _, y_dim, z_dim, t_dim = dims
    rows = y_dim + 2 * halo[1]
    return ((((x + halo[0]) * rows + y + halo[1]) * z_dim + z)
            * (t_dim // 2) + t // 2)


@lru_cache(maxsize=None)
def neighbor_slots(parity, dims, shifts, device, shard=None):
    """int64 [X*Y*Z*T/2]: for each slot of parity ``parity``, the slot of
    the site displaced by ``shifts`` ((axis, +-1), ...) — in the array of
    parity (parity + len(shifts)) % 2.  With ``shard`` (a Shard), over its
    interior sites, stepping into the halo on a split axis.  Cached;
    callers must not mutate."""
    g = shard or whole(dims)
    ext = g.interior
    c = list(packed_coords(parity, ext, device, g.offset))
    for ax, d in shifts:
        split = ax < 2 and g.halo[ax]
        c[ax] = c[ax] + d if split else (c[ax] + d) % ext[ax]
    return packed_slot(*c, ext, g.halo)


@lru_cache(maxsize=None)
def interior_slots(shard, device):
    """int64 slots of a shard's interior sites in its padded arrays, in
    site order (either parity: the slot does not depend on it), or None
    when the shard has no halo (the slots are then 0, 1, ...)."""
    if shard is None or shard.halo == (0, 0):
        return None
    return packed_slot(*packed_coords(0, shard.interior, device),
                       shard.interior, shard.halo)


def site_index_packed(parity, dims, device, shard=None):
    """int64 [X, Y, Z*T/2] of global DENSE site indices of the packed slots
    (the threefry counter; equal to ops.lattice.site_index on the dense
    lattice, so both layouts draw the same numbers per physical site).
    With ``shard``: [lx, ly, Z*T/2] over its interior, still global."""
    g = shard or whole(dims)
    x_dim, y_dim, z_dim, t_dim = g.interior
    x, y, z, t = packed_coords(parity, g.interior, device, g.offset)
    gy = g.dims[1]
    idx = (((x + g.offset[0]) * gy + y + g.offset[1]) * z_dim + z) * t_dim + t
    return idx.reshape(x_dim, y_dim, z_dim * (t_dim // 2))


def site_index_padded(parity, shard, device):
    """int64 [lx + 2hx, ly + 2hy, Z*T/2]: the global dense site index of
    every slot of a shard's padded array, halo slots included (wrapped
    round the lattice): the sites whose links those slots hold."""
    x_dim, y_dim = shard.dims[:2]
    off = (shard.offset[0] - shard.halo[0], shard.offset[1] - shard.halo[1])
    px, py, z_dim, t_dim = shard.padded
    x, y, z, t = packed_coords(parity, shard.padded, device, off)
    idx = ((((x + off[0]) % x_dim) * y_dim + (y + off[1]) % y_dim) * z_dim
           + z) * t_dim + t
    return idx.reshape(px, py, z_dim * (t_dim // 2))


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
    gathered once per loader); with ``shard``, over its interior sites in
    its padded arrays."""

    def __init__(self, us, parity, dims, n, shard=None):
        self.us, self.p, self.dims, self.n = us, parity, tuple(dims), n
        self.shard = shard
        self.device = us[0].device
        self._cache = {}

    def U(self, d, shifts=()):
        key = (d, shifts)
        if key not in self._cache:
            par = (self.p + len(shifts)) % 2
            idx = (neighbor_slots(self.p, self.dims, shifts, self.device,
                                  self.shard)
                   if shifts else interior_slots(self.shard, self.device))
            self._cache[key] = load_mat(self.us[2 * d + par], self.n, idx)
        return self._cache[key]


def store_rows(arr, m, n, idx=None):
    """Write the first two rows of matrix tuple m into packed array arr, at
    the slots ``idx`` (all slots in order when None)."""
    out = torch.stack([
        torch.stack([torch.stack([m[r][j][0], m[r][j][1]]) for j in range(n)])
        for r in range(2)
    ])
    if idx is None:
        arr.copy_(out.reshape(arr.shape))
    else:
        arr.view(2, n, 2, -1).index_copy_(3, idx, out.reshape(2, n, 2, -1))


# The kernels address a component as ``c * v2 + slot`` in int: an array
# must hold fewer than 2^31 floats (SU(3) 64^4 unsharded: 1.0e8).
MAX_ARRAY_FLOATS = 2 ** 31 - 1


def check_packed(arr, n, dims, name="links"):
    """Raise unless arr is a contiguous f32 packed array for (n, dims)
    (dims: the array's own extents, a shard's padded ones included) that
    the kernels' int slot arithmetic can address."""
    shape = (2, n, 2, dims[0], dims[1], dims[2] * (dims[3] // 2))
    if arr.dtype != torch.float32 or tuple(arr.shape) != shape:
        raise ValueError(
            f"{name}: expected float32 {shape}, got {arr.dtype} "
            f"{tuple(arr.shape)}"
        )
    if not arr.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if arr.numel() > MAX_ARRAY_FLOATS:
        raise ValueError(f"{name}: {arr.numel()} floats exceed the kernels' "
                         "int32 addressing")


def check_chains(arrays, dims, n_arrays=8, shard=None):
    """(C, N, device type) of n_arrays chain-stacked packed arrays ``[C, 2,
    N, 2, X, Y, Z*T/2]`` (a beta scan's, K1c-K4c): one chain count, 1 <= C
    <= 65535 (the kernels' grid Y extent), each chain's array ``a[c]`` a
    packed array of dims, all contiguous on one device.  With ``shard`` (a
    Shard of the lattice dims: K1ac, K5ac, K5bc) each chain's array is that
    shard's padded one."""
    if shard is not None:
        if tuple(shard.dims) != tuple(dims):
            raise ValueError(f"shard of {shard.dims}, lattice {tuple(dims)}")
        dims = shard.padded
    if len(arrays) != n_arrays:
        raise ValueError(f"expected {n_arrays} chain-stacked arrays, got "
                         f"{len(arrays)}")
    c = arrays[0].shape[0] if arrays[0].dim() == 7 else 0
    if not 1 <= c <= 65535:
        raise ValueError("chain-stacked arrays are [C, 2, N, 2, X, Y, "
                         f"Z*T/2] with 1 <= C <= 65535, got "
                         f"{tuple(arrays[0].shape)}")
    n = arrays[0].shape[2]
    if n not in (2, 3):
        raise ValueError(f"packed links are SU(2) or SU(3), got N={n}")
    for i, a in enumerate(arrays):
        if a.dim() != 7 or a.shape[0] != c or not a.is_contiguous():
            raise ValueError(f"array {i}: {tuple(a.shape)}, expected "
                             f"{c} contiguous chains")
        check_packed(a[0], n, dims, f"array {i}, chain 0")
    return c, n, check_device(*arrays)


def check_device(*tensors):
    """'cpu' or 'cuda' for tensors that all lie on one such device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type
