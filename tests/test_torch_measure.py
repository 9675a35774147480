"""The port's measurement and reunitarization (plain PyTorch versions of the
K2-K4 CUDA kernels) against the JAX reference's dense-field observables."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops import sun as jsun
from qcdgpu_tpu.ops.measure import mean_plaquette, measure_all, polyakov_from_ut
from qcdgpu_tpu.sim import hot_start
from qcdgpu_tpu_torch.ops import sun as tsun
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import measure as tmeas
from qcdgpu_tpu_torch.ops.cuda import sharded as tsh
from qcdgpu_tpu_torch.ops.cuda.reunit import reunitarize_dir
from qcdgpu_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)


@pytest.fixture(scope="module")
def u0():
    cfg = RefConfig(group=3, dims=DIMS, beta=5.5, seed=1)
    return np.array(hot_start(cfg, jrng.make_base_key(1))
                    .astype(jnp.complex64))


def _numpy_su3(dims, seed):
    """Random SU(3) field [4, 3, 3, *dims] from numpy normals (Ginibre,
    projected by Gram–Schmidt)."""
    rs = np.random.default_rng(seed)
    shape = (4, 3, 3) + tuple(dims)
    g = rs.standard_normal(shape) + 1j * rs.standard_normal(shape)
    g = torch.from_numpy(g.astype(np.complex64))
    return torch.stack([tsun.reunitarize(g[m]) for m in range(4)]).numpy()


def test_plaquette_from_plane_sums(u0):
    us = teng.from_reference(u0, "cpu")
    sums = tmeas.plane_sums(us, DIMS)
    assert sums.dtype == torch.float64 and sums.shape == (6,)
    plq = float(sums.sum()) / (6 * 3 * np.prod(DIMS))
    ref = float(mean_plaquette(jnp.asarray(u0).astype(jnp.complex128))[0])
    assert abs(plq - ref) < 1e-6


def test_measure_all_split(u0):
    us = teng.from_reference(u0, "cpu")
    got = teng.measure_all_split(us, DIMS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(measure_all(jnp.asarray(u0))),
                               atol=2e-5)


def _check_polyakov(dims, seed):
    """The port's Polyakov sums (K4's association: pairs, ladder, chunks)
    against the reference's dense-field loop, 2e-6 per spatial site."""
    u = _numpy_su3(dims, seed=seed)
    us = teng.from_reference(u, "cpu")
    sre, sim_ = tmeas.polyakov_sums(us, dims).tolist()
    ref_re, ref_im = polyakov_from_ut(jnp.asarray(u[3]))
    n_spatial = 3 * dims[0] * dims[1] * dims[2]
    assert abs(sre / n_spatial - float(ref_re)) < 2e-6
    assert abs(sim_ / n_spatial - float(ref_im)) < 2e-6


# T/2 = 1 ... 6: one unit, powers of two, and two chunks (3, 5, 6)
@pytest.mark.parametrize("t_ext", [2, 4, 6, 8, 10, 12])
def test_polyakov_any_t(t_ext):
    _check_polyakov((4, 4, 2, t_ext), seed=t_ext)


def test_polyakov_long_t():
    """T/2 = 36 > 32: each lane walks 2 slot pairs, 18 units, chunks 16 + 2."""
    assert tmeas.poly_lanes(36) == (2, 18, 32)
    _check_polyakov((2, 2, 2, 72), seed=72)


def test_polyakov_shards_and_chains_match_unsharded():
    """The shard twin's columns are the unsharded twin's bit for bit, and
    the chain twin's rows (K4c, K5bc) are the single-chain twin's (K4,
    K5b) bit for bit: the same f32 products and the same f64 order.  The
    shards' sums, added in shard order, are the unsharded sum to f64
    rounding only (another order of the same f64 terms)."""
    dims, mesh = (8, 4, 2, 6), (2, 2, 1, 1)
    chains = [teng.from_reference(_numpy_su3(dims, seed=40 + c), "cpu")
              for c in range(3)]
    stacked = tuple(torch.stack([ch[i] for ch in chains]) for i in range(8))
    rows = tmeas.polyakov_sums_chains(stacked, dims)
    grid = tmesh.ShardGrid(dims, mesh, [torch.device("cpu")])
    x_dim, y_dim, z_dim, _ = dims
    for c, us in enumerate(chains):
        assert torch.equal(rows[c], tmeas.polyakov_sums(us, dims))
        whole = tmeas.polyakov_columns_ref(us, dims).reshape(
            2, x_dim, y_dim, z_dim)
        total = torch.zeros(2, dtype=torch.float64)
        for g, sh in zip(grid.shards, tsh.shard_links(us, grid)):
            (x0, y0), (lx, ly) = g.offset, g.local
            assert torch.equal(
                tmeas.polyakov_columns_ref(sh, dims, g),
                whole[:, x0:x0 + lx, y0:y0 + ly].reshape(2, -1))
            total += tmeas.polyakov_sums_local(sh, g)
        torch.testing.assert_close(total, rows[c], rtol=1e-12, atol=1e-12)
    for g, sh in zip(grid.shards, tsh.shard_links(stacked, grid)):
        got = tmeas.polyakov_sums_chains(sh, dims, g)
        for c in range(3):
            assert torch.equal(got[c], tmeas.polyakov_sums_local(
                tuple(a[c] for a in sh), g))


def test_reunitarize_dir(u0):
    rs = np.random.default_rng(2)
    noisy = (u0 + 1e-3 * (rs.standard_normal(u0.shape)
                          + 1j * rs.standard_normal(u0.shape))
             ).astype(np.complex64)
    us = teng.from_reference(noisy, "cpu")
    for mu in (0, 3):
        pair = (reunitarize_dir(us[2 * mu], DIMS),
                reunitarize_dir(us[2 * mu + 1], DIMS))
        got = teng.join_dir(pair, DIMS, 3).numpy()
        ref = np.asarray(jsun.reunitarize(jnp.asarray(noisy[mu])))
        assert np.abs(got - ref).max() < 2e-5
