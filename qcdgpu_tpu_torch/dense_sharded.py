"""The dense engine on a 4D mesh: halo-padded shards of the dense field,
the halo refresh, and the standard observables measured shard by shard.

The dense counterpart of ops/cuda/sharded.py.  Where the reference places
its field on a ``jax.sharding.Mesh`` over (X, Y, Z, T) and lets XLA's SPMD
partitioner turn the ``jnp.roll`` neighbour gathers into halo exchanges
(qcdgpu_tpu/parallel/mesh.py:1-14), the port keeps an explicit grid
(parallel/mesh.py ``DenseGrid``): shard k holds the block of the lattice
its ``DenseShard`` names, PERSISTENTLY padded by one site on each side of
every split axis, as a tensor whose last four axes are the padded lattice
(``[4, N, N, px, py, pz, pt]``, or with a scan's chain axis ``[4, N, N, C,
px, py, pz, pt]``).  An axis the mesh does not split wraps inside the
shard, so the stock rolls of ops/staples.py give every interior site its
neighbours once the halos are fresh.

A stage of direction mu writes only ``u[mu]``, at interior sites, so only
that direction's halos are refreshed after it (``refresh``): one phase per
split axis, X, Y, Z, T in turn, each copying the boundary slabs of the
neighbours into the halo slabs over the FULL padded extent of the axes
refreshed before it (and the interior extent of those after it).  The
corners that the backward staple U_nu(x + mu - nu) reads thus arrive
transitively, through the halo of a neighbour that an earlier phase
filled: ops/cuda/sharded.py's order for X/Y, extended to four axes.  The
copies are torch copies, peer copies between cards.

Randomness stays the unsharded chain's: threefry is keyed by each site's
GLOBAL dense index (``site_geometry``), and the dense stream words are cut
to each shard's interior (``scatter_streams``), the lag generators'
scalars (ranlux ``nb``, ranmar ``c``) replicated, since they advance with
the draw count alone.  Every update is per site, so the sharded chain is
the unsharded one bit for bit in the links and the stream state.

The standard observables are measured without gathering the field: each
shard's plane sums over its interior in f64, and its ordered product of
the temporal links over its interior T, composed across the T-shards in T
order (``measure_standard``).  The extended ones gather the field first
(``make_measure``), as the packed mesh does (ops/cuda/engine.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.measure import (TIME_AXIS, has_extended, make_measure_fn,
                          measure_extended, pairmul, plane_sums,
                          polyakov_product)

NDIM = 4


# ---------------------------------------------------------------------------
# global tensors <-> shards
# ---------------------------------------------------------------------------


def scatter(a, grid, padded=True):
    """A global tensor whose last four axes are the lattice -> one tensor
    per shard of ``grid`` on the shard's device: its padded window (the
    interior and, on a split axis, the wrapped neighbouring slabs), or
    with ``padded=False`` its interior.  A grid of one shard returns ``a``
    itself where it already lies contiguous on the shard's device."""
    out = []
    for g, dev in zip(grid.shards, grid.devices):
        part = a
        for ax in range(NDIM):
            if g.local[ax] != g.dims[ax]:
                part = part.index_select(
                    ax - NDIM, g.coords(ax, padded, a.device))
        out.append(part.to(dev).contiguous())
    return tuple(out)


def gather(parts, grid, padded=True, copy=False):
    """Inverse of scatter: the shards' interiors joined into the global
    tensor on the first shard's device.  A grid of one shard returns the
    shard itself (the live tensor), or a copy with ``copy``."""
    if len(grid) == 1:
        return parts[0].clone() if copy else parts[0]
    first = parts[0]
    out = torch.empty(tuple(first.shape[:-NDIM]) + grid.dims,
                      dtype=first.dtype, device=grid.devices[0])
    for g, p in zip(grid.shards, parts):
        dst = out
        for ax in range(NDIM):
            dst = dst.narrow(ax - NDIM, g.offset[ax], g.local[ax])
        dst.copy_(g.interior(p) if padded else p)
    return out


def scatter_streams(rst, grid):
    """A global dense stream state -> the sharded one: each word array
    split into per-shard interiors (a tuple), the scalars replicated."""
    return {k: scatter(v, grid, padded=False)
            if isinstance(v, torch.Tensor) else v for k, v in rst.items()}


def gather_streams(rst, grid):
    """Inverse of scatter_streams (with one shard, its live words)."""
    return {k: gather(v, grid, padded=False) if isinstance(v, tuple) else v
            for k, v in rst.items()}


def shard_streams(rst, k):
    """Shard k's dense stream state out of a sharded one."""
    return {n: v[k] if isinstance(v, tuple) else v for n, v in rst.items()}


# ---------------------------------------------------------------------------
# geometry and the halo refresh
# ---------------------------------------------------------------------------


def site_geometry(g, device):
    """(global dense site index int64, [parity-0 mask, parity-1 mask]) over
    the interior of shard ``g``: ops/lattice.py's site_index and
    parity_mask at the shard's global coordinates."""
    c = [g.coords(ax, device=device).reshape(
        [-1 if b == ax else 1 for b in range(NDIM)]) for ax in range(NDIM)]
    x, y, z, t = c
    dims = g.dims
    shape = g.local
    sidx = (((x * dims[1] + y) * dims[2] + z) * dims[3] + t).expand(shape)
    par = (x + y + z + t) % 2
    return sidx.contiguous(), [(par == p).expand(shape).contiguous()
                               for p in (0, 1)]


def halo_plan(shards, grid):
    """The halo refresh of each direction mu as copies between views of the
    shards: ``plan[mu]`` lists one phase per split axis, in order X, Y, Z,
    T, each a (destinations, sources) pair of lists.  Phase ``ax`` copies,
    for every shard, the neighbours' boundary slabs into its two halo
    slabs along ``ax``, over the padded extent of the split axes before
    ``ax`` and the interior extent of those after it.  Within a phase no
    copy reads what another writes (halos written, interiors read)."""
    split = [ax for ax in range(NDIM) if grid.halo[ax]]

    def later(t, ax):
        for b in split:
            if b > ax:
                t = t.narrow(b - NDIM, grid.halo[b], grid.local[b])
        return t

    plan = []
    for mu in range(NDIM):
        phases = []
        for ax in split:
            n = grid.local[ax]
            dsts, srcs = [], []
            for s in range(len(grid)):
                own = later(shards[s][mu], ax)
                lo = later(shards[grid.neighbour(s, ax, -1)][mu], ax)
                hi = later(shards[grid.neighbour(s, ax, 1)][mu], ax)
                dsts += [own.narrow(ax - NDIM, 0, 1),
                         own.narrow(ax - NDIM, n + 1, 1)]
                srcs += [lo.narrow(ax - NDIM, n, 1),
                         hi.narrow(ax - NDIM, 1, 1)]
            phases.append((dsts, srcs))
        plan.append(phases)
    return plan


def halo_copies_per_stage(grid) -> int:
    """The slab copies of one direction's refresh: two per shard and split
    axis."""
    return 2 * len(grid) * sum(grid.halo)


def refresh(plan, mu):
    """Refresh direction mu's halos (halo_plan's phases in order)."""
    for dsts, srcs in plan[mu]:
        torch._foreach_copy_(dsts, srcs)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def measure_standard(shards, grid):
    """The standard six (ops.measure.OBS_NAMES), f32 [6] on the first
    shard's device, of the field the shards hold: each shard's plane sums
    over its interior in f64 added in shard order; each column's ordered
    temporal product over its shard's interior T, composed across the
    T-shards in T order in the field's dtype, its trace summed in
    complex128."""
    dev = grid.devices[0]
    n = shards[0].shape[1]
    vol = int(np.prod(grid.dims))
    sums = None
    for g, u in zip(grid.shards, shards):
        s = plane_sums(u, g.interior).to(dev)
        sums = s if sums is None else sums + s
    mt = grid.mesh[TIME_AXIS]
    loops = None
    for first in range(0, len(grid), mt):
        prod = None
        for k in range(first, first + mt):
            ut = grid.shards[k].interior(shards[k][TIME_AXIS])
            p = [[c.to(dev) for c in row] for row in polyakov_product(ut)]
            prod = p if prod is None else pairmul(prod, p)
        tr = prod[0][0]
        for i in range(1, n):
            tr = tr + prod[i][i]
        s = torch.sum(tr.to(torch.complex128))
        loops = s if loops is None else loops + s
    s = sums / (n * vol)
    plq_s = (s[0] + s[1] + s[3]) / 3.0
    plq_t = (s[2] + s[4] + s[5]) / 3.0
    plq = (plq_s + plq_t) / 2.0
    pl = loops / (n * (vol // grid.dims[TIME_AXIS]))
    return torch.stack([plq, plq_s, plq_t, 1.0 - plq, pl.real, pl.imag]
                       ).to(torch.float32)


def make_measure(cfg, grid):
    """shards -> the observable vector of measure_obs_names(cfg), f32 on the
    first shard's device.  One shard (no mesh): ops.measure.make_measure_fn
    on the field itself.  On a mesh: measure_standard, then cfg's extended
    columns on the gathered field (bit for bit the unsharded ones); with
    meas_dtype "double" the shards are widened to complex128 first."""
    whole = make_measure_fn(cfg)
    if len(grid) == 1:
        return lambda shards: whole(shards[0])
    double = cfg.meas_dtype == "double"

    def fn(shards):
        if double:
            shards = tuple(s.to(torch.complex128) for s in shards)
        base = measure_standard(shards, grid)
        if not has_extended(cfg):
            return base
        return torch.cat([base, measure_extended(gather(shards, grid),
                                                 cfg).to(base.device)])

    return fn
