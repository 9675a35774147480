"""The shard grid of an X/Y domain decomposition.

Port of qcdgpu_tpu/parallel/mesh.py (the mesh policy and the lattice-
sharding predicate).  Where the reference builds a ``jax.sharding.Mesh``
and lets ``shard_map`` place the shards, the port keeps an explicit grid:
shard (i, j) of an (mx, my) mesh owns the interior
``[i*lx:(i+1)*lx, j*ly:(j+1)*ly]`` of the lattice (``core.Shard``), lives on
one CUDA device (or the CPU), and its neighbours along X and Y are found by
index arithmetic on the grid.  By default every shard sits on the
Simulation's device, so a mesh runs on one card; ``devices=[...]`` spreads
them, shard k on ``devices[k % len(devices)]``.  That grid is the packed
engine's, which splits X and Y only.

The dense engine (dense.py, dense_sharded.py) splits any of the four axes:
``DenseGrid`` is the reference's make_mesh over (X, Y, Z, T) (mesh.py:
30-58) as an explicit grid of ``DenseShard`` geometries, each an interior
block of the lattice with a one-site halo on each side of every split
axis; an unsplit axis wraps inside the shard.

A beta scan's chains are cut into blocks (the reference's ("c",) and
("c", "x", "y", "z", "t") meshes, mesh.py:75-112): ``ChainGrid`` holds each
block's chains and its ``ShardGrid``, every shard of block b on
``devices[b % len(devices)]`` (by default the scan's device).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda.core import Shard

# mesh axis names, one per lattice site axis (X, Y, Z, T)
AXES = ("x", "y", "z", "t")
NDIM = len(AXES)


def is_lattice_sharded(cfg) -> bool:
    """True when cfg.mesh decomposes the lattice into more than one shard
    (the reference's predicate, mesh.py:61-65)."""
    return int(np.prod(cfg.mesh)) != 1


def default_mesh_shape(
    n_devices: int, dims: Optional[Sequence[int]] = None
) -> Tuple[int, int, int, int]:
    """Factor n_devices over (X, Y, Z, T) — X/Y-major (copied from the
    reference, mesh.py:114-152).

    Powers of two go to X then Y alternately (X first); each axis is capped
    at dims[i] // 2 when dims is given (the checkerboard limit: every shard
    needs an even local extent), else at 8.  Overflow spills to Z then T;
    any non-power-of-two remainder rides on T.
    """
    caps = [d // 2 for d in dims] if dims is not None else [8, 8, 8, 8]
    shape = [1, 1, 1, 1]
    rem = n_devices
    while rem % 2 == 0:
        # prefer the X/Y axis that is currently smaller (X on ties)
        if shape[0] <= shape[1] and shape[0] * 2 <= max(caps[0], 1):
            ax = 0
        elif shape[1] * 2 <= max(caps[1], 1):
            ax = 1
        elif shape[0] * 2 <= max(caps[0], 1):
            ax = 0
        elif shape[2] * 2 <= max(caps[2], 1):
            ax = 2
        elif shape[3] * 2 <= max(caps[3], 1):
            ax = 3
        else:
            break
        shape[ax] *= 2
        rem //= 2
    shape[3] *= rem
    return tuple(shape)


class ShardGrid:
    """The shards of an (mx, my, 1, 1) mesh over ``dims``, in order
    k = i * my + j (X-major), each with its geometry and device."""

    def __init__(self, dims, mesh, devices):
        dims = tuple(int(d) for d in dims)
        mesh = tuple(int(m) for m in mesh)
        if len(mesh) != 4 or mesh[2] != 1 or mesh[3] != 1:
            raise ValueError(f"an X/Y mesh (mx, my, 1, 1), got {mesh}")
        mx, my = mesh[:2]
        if dims[0] % (2 * mx) or dims[1] % (2 * my):
            raise ValueError(f"dims {dims} do not split evenly over {mesh}")
        lx, ly = dims[0] // mx, dims[1] // my
        halo = (int(mx > 1), int(my > 1))
        self.dims, self.mesh = dims, (mx, my)
        self.shards = tuple(Shard(dims, (lx, ly), (i * lx, j * ly), halo)
                            for i in range(mx) for j in range(my))
        devices = [torch.device(d) for d in devices]
        self.devices = tuple(devices[k % len(devices)]
                             for k in range(mx * my))

    def __len__(self):
        return len(self.shards)

    def neighbour(self, k, axis, delta):
        """Index of the shard next to shard k along X (axis 0) or Y (1)."""
        mx, my = self.mesh
        i, j = divmod(k, my)
        if axis == 0:
            return ((i + delta) % mx) * my + j
        return i * my + (j + delta) % my


def shard_grid(cfg, device, devices=None) -> ShardGrid:
    """The grid of cfg.mesh: every shard on ``device`` unless ``devices``
    lists the devices to spread them over."""
    return ShardGrid(cfg.dims, cfg.mesh,
                     [device] if devices is None else list(devices))


class DenseShard(NamedTuple):
    """One shard of the dense field over a 4D mesh: the interior block
    ``[offset[a], offset[a] + local[a])`` of every lattice axis a, padded
    by ``halo[a]`` (1 where the axis is split, else 0) sites on each side.
    A tensor of the shard has the padded extents as its last four axes."""

    dims: tuple    # the global lattice (X, Y, Z, T)
    local: tuple   # interior extents
    offset: tuple  # global coordinates of the first interior site
    halo: tuple    # 1 where the axis is split

    def interior(self, a):
        """The interior view of ``a``, whose last four axes are the padded
        lattice (``a`` itself without halo)."""
        for ax in range(NDIM):
            if self.halo[ax]:
                a = a.narrow(ax - NDIM, self.halo[ax], self.local[ax])
        return a

    def coords(self, axis, padded=False, device="cpu"):
        """Global coordinates (int64) along ``axis`` of the interior sites,
        or with ``padded`` of every padded site (wrapped)."""
        h = self.halo[axis] if padded else 0
        return (torch.arange(self.offset[axis] - h,
                             self.offset[axis] + self.local[axis] + h,
                             dtype=torch.int64, device=device)
                % self.dims[axis])


class DenseGrid:
    """The shards of an (mx, my, mz, mt) mesh over ``dims`` for the dense
    field, in order k = ((i * my + j) * mz + l) * mt + m (X-major), each
    with its DenseShard geometry and device (shard k on ``devices[k %
    len(devices)]``)."""

    def __init__(self, dims, mesh, devices):
        dims = tuple(int(d) for d in dims)
        mesh = tuple(int(m) for m in mesh)
        if len(mesh) != NDIM:
            raise ValueError(f"a mesh over (X, Y, Z, T), got {mesh}")
        if any(d % (2 * m) for d, m in zip(dims, mesh)):
            raise ValueError(f"dims {dims} do not split into even shards "
                             f"over {mesh}")
        local = tuple(d // m for d, m in zip(dims, mesh))
        halo = tuple(int(m > 1) for m in mesh)
        self.dims, self.mesh, self.local, self.halo = dims, mesh, local, halo
        self.index = tuple(itertools.product(*(range(m) for m in mesh)))
        self.shards = tuple(
            DenseShard(dims, local, tuple(c * l for c, l in zip(ix, local)),
                       halo) for ix in self.index)
        devices = [torch.device(d) for d in devices]
        self.devices = tuple(devices[k % len(devices)]
                             for k in range(len(self.shards)))

    def __len__(self):
        return len(self.shards)

    def neighbour(self, k, axis, delta):
        """Index of the shard next to shard k along ``axis``."""
        ix = list(self.index[k])
        ix[axis] = (ix[axis] + delta) % self.mesh[axis]
        return self.index.index(tuple(ix))


def dense_grid(cfg, device, devices=None) -> DenseGrid:
    """The dense grid of cfg.mesh: every shard on ``device`` unless
    ``devices`` lists the devices to spread them over."""
    return DenseGrid(cfg.dims, cfg.mesh,
                     [device] if devices is None else list(devices))


class ChainGrid:
    """A beta scan's C chains in ``n_blocks`` equal blocks of consecutive
    chains (the reference's chain-mesh axis "c"), each block with the
    ShardGrid of cfg.mesh over the lattice (with ``dense`` its DenseGrid),
    all of block b's shards on ``devices[b % len(devices)]``: the
    reference's make_chain_mesh and make_chain_lattice_mesh (mesh.py:
    75-112) as an explicit grid."""

    def __init__(self, cfg, n_chains, n_blocks, devices, dense=False):
        n_chains, n_blocks = int(n_chains), int(n_blocks)
        if n_blocks < 1 or n_chains % n_blocks:
            raise ValueError(f"n_chains={n_chains} must divide evenly over "
                             f"chain_mesh={n_blocks} blocks")
        per = n_chains // n_blocks
        devices = [torch.device(d) for d in devices]
        self.blocks = tuple(range(b * per, (b + 1) * per)
                            for b in range(n_blocks))
        kind = DenseGrid if dense else ShardGrid
        self.grids = tuple(
            kind(cfg.dims, cfg.mesh, [devices[b % len(devices)]])
            for b in range(n_blocks))

    def __len__(self):
        return len(self.blocks)


def block_cards(devices) -> int:
    """The device count that auto chain_mesh divides: the distinct cards in
    ``devices`` (resolved torch.devices), over which the chain blocks
    spread; 1 when ``devices`` is None, since every block then sits on the
    scan's one device and more blocks only add host launches, or when it
    names no card."""
    if devices is None:
        return 1
    return max(len({d for d in map(torch.device, devices)
                    if d.type == "cuda"}), 1)


def resolve_chain_mesh(requested, cfg, n_chains, n_devices) -> int:
    """The chain blocks of a scan (reference BetaScan._resolve_chain_mesh,
    ensemble.py:394-413): ``requested`` when nonzero, else (0, auto) the
    largest divisor of n_chains that fits n_devices // prod(cfg.mesh)
    blocks, at least 1."""
    if requested:
        return int(requested)
    nd = int(n_devices) // int(np.prod(cfg.mesh))
    for d in range(min(nd, int(n_chains)), 1, -1):
        if n_chains % d == 0:
            return d
    return 1
