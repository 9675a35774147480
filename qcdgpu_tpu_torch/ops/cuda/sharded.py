"""The X/Y domain decomposition's state: halo-padded shards and the halo
refresh.

Port of the layout half of qcdgpu_tpu/ops/pallas/sharded.py; the sweep,
measurement and runner over the shards are engine.py's, which runs the
unsharded lattice as one shard without halo.  The lattice is split along X
and/or Y over an (mx, my, 1, 1) mesh (parallel/mesh.py ShardGrid); each
shard keeps its 8 arrays PERSISTENTLY halo-padded (``core.Shard``): an
axis split over the mesh gets one halo slab on each side, an axis that is
not split wraps inside the shard.  The reference re-pads all 8 arrays with
ppermute + concatenate before every stage (sharded.py:42-56, 108-113);
here the kernels update in place, and since stage (mu, p) writes only
``us[2mu+p]``, and only at interior slots, only that array's halos are
refreshed after the stage (``refresh_halos``): Y rows first, then the X
slabs of the Y-padded array, so that the corner (x+-1, y-+1), which the
backward staple U_nu(x+mu-nu) reads at mu = X, nu = Y, arrives through the
Y rows of the X neighbour (the reference's order).  The copies are torch
copies; between shards on different cards they are peer copies.

Randomness: threefry is keyed by the GLOBAL dense site index and the stage
key, so the sharded chain runs the unsharded chain's per-site arithmetic
and is bit-identical to it.  Stream words are shard-local and unpadded,
``[W, lx, ly, Z*T/2]``; the lag generators' scalars are replicated.

The links of a scan on a mesh are chain-stacked, ``[C, 2, N, 2, X, Y,
Z*T/2]`` per array (a block of chains shares one shard grid): the functions
on links index X and Y from the end (dims -3, -2), so they serve both
layouts, and one halo copy per slab covers every chain of the block.
"""

from __future__ import annotations

import torch

NDIM = 4


# ---------------------------------------------------------------------------
# global state <-> shards
# ---------------------------------------------------------------------------


def _window(lo, count, extent, device):
    return torch.arange(lo, lo + count, device=device) % extent


def shard_links(us, grid):
    """Global packed 8-tuple (or chain-stacked) -> one halo-padded 8-tuple
    per shard, on the shard's device: the interior slice plus, on a split
    axis, the wrapped neighbouring slabs (what ``refresh_halos`` keeps
    them)."""
    x_dim, y_dim = grid.dims[:2]
    out = []
    for g, dev in zip(grid.shards, grid.devices):
        src = us[0].device
        xs = _window(g.offset[0] - g.halo[0], g.padded[0], x_dim, src)
        ys = _window(g.offset[1] - g.halo[1], g.padded[1], y_dim, src)
        out.append(tuple(a.index_select(-3, xs).index_select(-2, ys)
                         .to(dev).contiguous() for a in us))
    return tuple(out)


def interior(a, g, axis):
    """The interior of a shard tensor whose X/Y axes are axis, axis + 1
    (axis -3 for links, chain-stacked or not)."""
    (lx, ly), (hx, hy) = g.local, g.halo
    return a.narrow(axis, hx, lx).narrow(axis + 1, hy, ly)


def _join(parts, grid, axis):
    """Per-shard interiors -> the global tensor on the first shard's
    device (X over shard rows i, Y over shard columns j); a lone shard's
    interior is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    dev = grid.devices[0]
    my = grid.mesh[1]
    rows = [torch.cat([parts[i * my + j].to(dev) for j in range(my)],
                      dim=axis + 1)
            for i in range(grid.mesh[0])]
    return torch.cat(rows, dim=axis).contiguous()


def gather_links(shards, grid):
    """Per-shard padded 8-tuples (or chain-stacked) -> the global packed
    8-tuple (chain-stacked)."""
    return tuple(
        _join([interior(us[k], g, -3) for g, us in zip(grid.shards, shards)],
              grid, -3)
        for k in range(2 * NDIM))


def shard_streams(rst, grid):
    """Global stream state -> sharded: each parity's words split into
    per-shard unpadded interiors [W, lx, ly, Z*T/2]; the scalars
    replicated."""
    out = {}
    for k, v in rst.items():
        if isinstance(v, torch.Tensor):
            v = tuple(v.narrow(1, g.offset[0], g.local[0])
                      .narrow(2, g.offset[1], g.local[1]).to(dev).contiguous()
                      for g, dev in zip(grid.shards, grid.devices))
        out[k] = v
    return out


def shard_state(st, grid):
    """Global engine state (us, rst) -> sharded state (shard_links,
    shard_streams)."""
    return shard_links(st[0], grid), shard_streams(st[1], grid)


def gather_state(st, grid):
    """Sharded state -> global engine state: new tensors, or with one
    shard (the whole lattice) views of its own."""
    shards, rst = st
    return gather_links(shards, grid), {
        k: _join(v, grid, 1) if isinstance(v, tuple) else v
        for k, v in rst.items()}


def halo_copies(shards, grid):
    """The halo refresh as copies between views of the shards: for each
    array us[k], its phases in order, each a (destinations, sources) pair
    of lists: the Y rows (over the interior X slabs), then the X slabs of
    the Y-padded arrays, so that corners arrive from the diagonal
    neighbours transitively.  Within a phase no copy reads what another
    writes (halos are written, interiors read).  X and Y are dims -3 and
    -2, so a chain-stacked array's copies carry all its chains."""
    (lx, ly), (hx, hy) = grid.shards[0].local, grid.shards[0].halo
    plan = []
    for k in range(2 * NDIM):
        phases = []
        if hy:
            dsts, srcs = [], []
            for s in range(len(grid)):
                lo = shards[grid.neighbour(s, 1, -1)][k].narrow(-3, hx, lx)
                hi = shards[grid.neighbour(s, 1, 1)][k].narrow(-3, hx, lx)
                dst = shards[s][k].narrow(-3, hx, lx)
                dsts += [dst[..., 0, :], dst[..., ly + 1, :]]
                srcs += [lo[..., ly, :], hi[..., 1, :]]
            phases.append((dsts, srcs))
        if hx:
            dsts, srcs = [], []
            for s in range(len(grid)):
                lo = shards[grid.neighbour(s, 0, -1)][k]
                hi = shards[grid.neighbour(s, 0, 1)][k]
                dsts += [shards[s][k][..., 0, :, :],
                         shards[s][k][..., lx + 1, :, :]]
                srcs += [lo[..., lx, :, :], hi[..., 1, :, :]]
            phases.append((dsts, srcs))
        plan.append(phases)
    return plan


def refresh_halos(shards, grid, arrays=range(2 * NDIM), plan=None):
    """Copy the shards' boundary slabs into their neighbours' halos, for
    the arrays us[k] listed (``halo_copies``; pass its ``plan`` for these
    shards to skip building the views again)."""
    plan = plan or halo_copies(shards, grid)
    for k in arrays:
        for dsts, srcs in plan[k]:
            torch._foreach_copy_(dsts, srcs)
