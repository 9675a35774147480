"""The shard grid of an X/Y domain decomposition.

Port of qcdgpu_tpu/parallel/mesh.py (the mesh policy and the lattice-
sharding predicate).  Where the reference builds a ``jax.sharding.Mesh``
and lets ``shard_map`` place the shards, the port keeps an explicit grid:
shard (i, j) of an (mx, my) mesh owns the interior
``[i*lx:(i+1)*lx, j*ly:(j+1)*ly]`` of the lattice (``core.Shard``), lives on
one CUDA device (or the CPU), and its neighbours along X and Y are found by
index arithmetic on the grid.  By default every shard sits on the
Simulation's device, so a mesh runs on one card; ``devices=[...]`` spreads
them, shard k on ``devices[k % len(devices)]``.  Z/T meshes and the chain
(replica) meshes are not ported (M11, M15).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda.core import Shard

# mesh axis names, one per lattice site axis (X, Y, Z, T)
AXES = ("x", "y", "z", "t")


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
