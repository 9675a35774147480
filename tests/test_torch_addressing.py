"""The kernels' slot-delta addressing (csrc/common.cuh SiteAddr, copied
below as site_steps and div_by) against the direct addressing of the plain
versions (ops/cuda/core.py neighbor_slots: decode, step, re-encode): every
neighbour a stage or the plane sums load, on whole lattices with T/2 even
and odd and on the shards of X, Y and XY meshes, and the neighbours K3's
tile kernel reads from shared memory."""

import itertools

import numpy as np
import pytest
import torch

from qcdgpu_tpu_torch.ops.cuda import core
from qcdgpu_tpu_torch.parallel.mesh import ShardGrid

torch.set_num_threads(1)

CPU = torch.device("cpu")


def fastdiv_magic(d):
    """(mul, shr) of csrc/common.cuh make_fastdiv: for 0 <= n < 2^31,
    n // d == ((n * mul) >> 32) >> shr (d > 1); (0, 0) for d == 1."""
    if d == 1:
        return 0, 0
    log2 = (d - 1).bit_length()  # ceil(log2 d)
    return ((1 << (31 + log2)) + d - 1) // d, log2 - 1


def div_by(n, d):
    """n // d as the kernels divide (common.cuh div_by), on int64 tensors
    or ints 0 <= n < 2^31."""
    mul, shr = fastdiv_magic(d)
    return n if d == 1 else ((n * mul) >> 32) >> shr


def site_steps(parity, dims, device, shard=None):
    """The kernels' per-site addressing (csrc/common.cuh site_addr) over
    one parity's sites in thread order: (own, dense, fwd, bwd), int64
    tensors; own the slot in the (padded) array, dense the global dense
    site index, fwd[a] / bwd[a] the slot change of a step +1 / -1 along
    axis a (a neighbour's slot in the other parity's array is own + fwd[a];
    x + mu - nu is own + fwd[mu] + bwd[nu]).  Built as the kernels build
    it: three divisions by div_by, compare-and-select wraps."""
    g = shard or core.whole(dims)
    x_dim, y_dim, z_dim, t_dim = g.interior
    t2 = t_dim // 2
    hx, hy = g.halo
    n = torch.arange(x_dim * y_dim * z_dim * t2, dtype=torch.int64,
                     device=device)
    r = div_by(n, t2)
    k = n - r * t2
    r2 = div_by(r, z_dim)
    z = r - r2 * z_dim
    x = div_by(r2, y_dim)
    y = r2 - x * y_dim
    t = 2 * k + (parity + g.offset[0] + x + g.offset[1] + y + z) % 2
    own = core.packed_slot(x, y, z, t, g.interior, g.halo)
    dense = ((((x + g.offset[0]) * g.dims[1] + y + g.offset[1]) * z_dim + z)
             * t_dim + t)
    fwd, bwd = [], []
    for c, ext, stride, split in (
            (x, x_dim, (y_dim + 2 * hy) * z_dim * t2, hx),
            (y, y_dim, z_dim * t2, hy), (z, z_dim, t2, 0)):
        wrap = torch.full_like(c, -(ext - 1) * stride)
        step = torch.full_like(c, stride)
        fwd.append(step if split else torch.where(c == ext - 1, wrap, step))
        bwd.append(-step if split else torch.where(c == 0, -wrap, -step))
    odd = t % 2 == 1
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    fwd.append(torch.where(odd, torch.where(t == t_dim - 1, one - t2, one),
                           zero))
    bwd.append(torch.where(odd, zero,
                           torch.where(t == 0, one * (t2 - 1), -one)))
    return own, dense, torch.stack(fwd), torch.stack(bwd)


# (dims, mesh): None is the whole lattice
CASES = [((4, 4, 2, 4), None), ((8, 8, 8, 6), None), ((24, 24, 24, 6), None),
         ((8, 8, 4, 4), (2, 2, 1, 1)), ((8, 8, 2, 6), (1, 4, 1, 1)),
         ((8, 4, 4, 4), (2, 1, 1, 1))]


def _geometries(dims, mesh):
    if mesh is None:
        return [None]
    return list(ShardGrid(dims, mesh, [CPU]).shards)


@pytest.mark.parametrize("dims,mesh", CASES)
def test_site_steps_match_direct_addressing(dims, mesh):
    for shard, parity in itertools.product(_geometries(dims, mesh), (0, 1)):
        own, dense, fwd, bwd = site_steps(parity, dims, CPU, shard)
        direct = core.interior_slots(shard, CPU)
        assert torch.equal(own, torch.arange(own.numel()) if direct is None
                           else direct)
        assert torch.equal(dense, core.site_index_packed(
            parity, dims, CPU, shard).reshape(-1))
        for a in range(4):
            for d, step in ((1, fwd), (-1, bwd)):
                assert torch.equal(own + step[a], core.neighbor_slots(
                    parity, dims, ((a, d),), CPU, shard)), (shard, a, d)
        # the staple's x + mu - nu and any two-axis step compose
        for mu, nu in itertools.permutations(range(4), 2):
            assert torch.equal(own + fwd[mu] + bwd[nu], core.neighbor_slots(
                parity, dims, ((mu, 1), (nu, -1)), CPU, shard))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 12, 16, 24, 72, 512, 1000,
                               16384, 2 ** 20 + 7, 2 ** 31 - 1])
def test_div_by_is_exact(d):
    rs = np.random.default_rng(d)
    n = torch.from_numpy(np.concatenate([
        np.arange(min(4 * d, 4096)), rs.integers(0, 2 ** 31, 4096),
        [2 ** 31 - 1, 2 ** 31 - 2, max(2 ** 31 - d, 0)]]).astype(np.int64))
    assert torch.equal(div_by(n, d), n // d)
    mul, _ = fastdiv_magic(d)
    assert 0 <= mul < 2 ** 32  # the kernels' u32 multiplier


def tile_slots(b, parity, dims):
    """The slots of K3's tile b (csrc/measure.cu plane_tile_fill) in one
    parity's array: its 128 slots, then the line after them (z + 1,
    wrapped)."""
    t2, z_dim = dims[3] // 2, dims[2]
    s0 = b * 128
    r = div_by(s0, t2)
    z0 = r - div_by(r, z_dim) * z_dim
    z = z0 + 128 // t2
    z = 0 if z == z_dim else z
    return torch.cat([torch.arange(s0, s0 + 128),
                      s0 + (z - z0) * t2 + torch.arange(t2)])


@pytest.mark.parametrize("dims", [(2, 2, 16, 16), (2, 2, 8, 32),
                                  (2, 4, 32, 8), (2, 2, 32, 32)])
def test_plane_tile_neighbours(dims):
    """K3's tile kernel reads a site's z + 1 neighbour at tile index i + T/2
    and its t + 1 neighbour at i + fwd[3] of the other parity's tile: the
    slots neighbor_slots gives."""
    t2 = dims[3] // 2
    assert 128 % t2 == 0 and dims[2] * t2 % 128 == 0  # tile_fits
    for parity in (0, 1):
        own, _, fwd, _ = site_steps(parity, dims, CPU)
        z_nb = core.neighbor_slots(parity, dims, ((2, 1),), CPU)
        t_nb = core.neighbor_slots(parity, dims, ((3, 1),), CPU)
        for b in range(own.numel() // 128):
            tile = tile_slots(b, 1 - parity, dims)
            i = torch.arange(128)
            g = b * 128 + i
            assert torch.equal(tile[i + t2], z_nb[g])
            assert torch.equal(tile[i + fwd[3][g]], t_nb[g])
            assert torch.equal(tile_slots(b, parity, dims)[i], own[g])
