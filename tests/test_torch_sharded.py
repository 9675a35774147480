"""The port's X/Y domain-decomposed engine (ops/cuda/sharded.py: the plain
PyTorch twins of K1a, K5a and K5b, the halo refresh and the shard layout)
against the unsharded port and the JAX reference.

Mirrors tests/test_pallas_sharded.py (stage per mesh pattern against the
XLA recipe, chunk runner against the unsharded engine) and adds the
port's own invariants: the sharded chain is the unsharded chain bit for
bit, because both run the same per-site arithmetic keyed by the global site
index.  Kept cheap: tiny lattices, one jitted reference stage, no
interpret-mode Pallas.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops.lattice import parity_mask, site_index
from qcdgpu_tpu.ops.measure import make_measure_fn
from qcdgpu_tpu.ops.samplers import update_links
from qcdgpu_tpu.ops.staples import staple_sum
from qcdgpu_tpu.parallel import mesh as jmesh
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops.cuda import core as tcore
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import measure as tmeas
from qcdgpu_tpu_torch.ops.cuda import sharded as tsh
from qcdgpu_tpu_torch.ops.cuda import update as tupd
from qcdgpu_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
DIMS = (4, 4, 2, 4)
MESHES = [(2, 1, 1, 1), (1, 2, 1, 1), (2, 2, 1, 1)]
BETA = 5.5


def _grid(dims, mesh):
    return tmesh.ShardGrid(dims, mesh, [CPU])


def _random_packed(n, dims, seed):
    rs = np.random.default_rng(seed)
    shape = (2, n, 2, dims[0], dims[1], dims[2] * dims[3] // 2)
    return tuple(torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
                 for _ in range(8))


def _hot(n, dims, seed=1):
    cfg = SimConfig(group=n, dims=dims, seed=seed)
    return teng.packed_hot_start(cfg, trng.make_base_key(seed), CPU)


# (a) ----------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_gather_round_trip(mesh):
    grid = _grid(DIMS, mesh)
    us = _random_packed(3, DIMS, seed=1)
    rst = teng.make_stream_state0(
        SimConfig(dims=DIMS, seed=2, rng_mode="prngcl:ranlux3"), CPU)
    shards, srst = tsh.shard_state((us, rst), grid)
    lx, ly = DIMS[0] // mesh[0], DIMS[1] // mesh[1]
    hx, hy = int(mesh[0] > 1), int(mesh[1] > 1)
    assert len(shards) == len(srst["words_e"]) == mesh[0] * mesh[1]
    assert shards[0][0].shape[3:5] == (lx + 2 * hx, ly + 2 * hy)
    assert srst["words_o"][0].shape[1:3] == (lx, ly)
    assert srst["nb_e"] == rst["nb_e"] and srst["ptr_o"] == rst["ptr_o"]
    back, brst = tsh.gather_state((shards, srst), grid)
    for a, b in zip(back, us):
        assert torch.equal(a, b)
    assert set(brst) == set(rst)
    for k, v in rst.items():
        assert (torch.equal(brst[k], v) if isinstance(v, torch.Tensor)
                else brst[k] == v)


# (b) ----------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_refresh_halos_matches_wrap_pad(mesh):
    grid = _grid(DIMS, mesh)
    us = _random_packed(2, DIMS, seed=3)
    shards = tsh.shard_links(us, grid)
    # spoil every halo, keep the interiors
    for g, sh in zip(grid.shards, shards):
        for a in sh:
            inner = tsh.interior(a, g, 3).clone()
            a.fill_(float("nan"))
            tsh.interior(a, g, 3).copy_(inner)
    tsh.refresh_halos(shards, grid)
    for g, sh in zip(grid.shards, shards):
        for a, b in zip(sh, us):
            pad = np.pad(b.numpy(), [(0, 0)] * 3 + [(1, 1), (1, 1), (0, 0)],
                         mode="wrap")
            xs = slice(g.offset[0] + 1 - g.halo[0],
                       g.offset[0] + 1 + g.local[0] + g.halo[0])
            ys = slice(g.offset[1] + 1 - g.halo[1],
                       g.offset[1] + 1 + g.local[1] + g.halo[1])
            np.testing.assert_array_equal(a.numpy(), pad[:, :, :, xs, ys])


# (c) ----------------------------------------------------------------------

STAGE_DIMS = (8, 8, 2, 4)
# (parity, mu) = (1, X): the backward staple U_Y(x + X - Y) reads the
# corner (x+1, y-1), which reaches an XY shard through two halo hops
STAGE = (1, 0)


@pytest.fixture(scope="module")
def stage_ref():
    """The reference's XLA stage (tests/test_pallas_sharded.py:56-60) on a
    hot field from the port: (packed start, stage key, new U_mu)."""
    us = _hot(3, STAGE_DIMS)
    u = teng.join_links(us, STAGE_DIMS).numpy()
    key = trng.stage_key(trng.make_base_key(1), 0, 7)
    parity, mu = STAGE

    @jax.jit
    def xla_stage(u, key2):
        new = update_links(u[mu], staple_sum(u, mu), "heatbath", BETA, key2,
                           site_index(STAGE_DIMS), k_trials=4)
        return jnp.where(parity_mask(STAGE_DIMS, parity), new, u[mu])

    ref = np.asarray(xla_stage(jnp.asarray(u),
                               jnp.asarray(np.array(key, np.uint32))))
    return us, key, ref


@pytest.mark.parametrize("mesh", [(4, 1, 1, 1), (1, 4, 1, 1), (2, 2, 1, 1)])
def test_sharded_stage_matches_xla(stage_ref, mesh):
    us, key, ref = stage_ref
    parity, mu = STAGE
    grid = _grid(STAGE_DIMS, mesh)
    shards = tsh.shard_links(tuple(a.clone() for a in us), grid)
    for g, sh in zip(grid.shards, shards):
        out = tupd.stage_update(sh, mu, parity, BETA, key, STAGE_DIMS,
                                shard=g)
        assert out is sh[2 * mu + parity]  # in place
    new = tsh.gather_links(shards, grid)
    for k in range(8):  # only the stage's array, and only its interiors
        assert torch.equal(new[k], us[k]) == (k != 2 * mu + parity)
    got = teng.join_dir((new[2 * mu], new[2 * mu + 1]), STAGE_DIMS, 3)
    assert np.abs(got.numpy() - ref).max() < 2e-5


# (d) ----------------------------------------------------------------------

CHAINS = {
    "su3_hb_or_kp": (dict(group=3, n_or=1, track_kp_exhaust=True),
                     (2, 1, 1, 1)),
    "su2_metro_acc": (dict(group=2, beta=2.4, algorithm="metropolis",
                           track_acceptance=True), (2, 2, 1, 1)),
    "su2_ranlux3": (dict(group=2, beta=2.4, rng_mode="prngcl:ranlux3"),
                    (1, 2, 1, 1)),
    "su2_xor128": (dict(group=2, beta=2.4, rng_mode="prngcl:xor128"),
                   (2, 2, 1, 1)),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_sharded_chain_is_the_unsharded_chain(name):
    kw, mesh = CHAINS[name]
    cfg = SimConfig(**{"beta": BETA, **kw}, dims=DIMS, seed=1,
                    reunit_every=2)
    u0 = teng.join_links(_hot(cfg.group, DIMS), DIMS)
    one = Simulation(cfg, init_u=u0, device="cpu")
    many = Simulation(cfg.replace(mesh=mesh), init_u=u0, device="cpu")
    obs1, obsn = one.run(3, 1), many.run(3, 1)
    for a, b in zip(one.us, many.us):
        assert torch.equal(a, b)
    np.testing.assert_allclose(obsn, obs1, rtol=0, atol=1e-7)
    if cfg.track_acceptance or cfg.track_kp_exhaust:
        np.testing.assert_array_equal(obsn[:, -1], obs1[:, -1])
    if cfg.rng_mode != "threefry":
        s1, sn = one.stream_state, many.stream_state
        assert set(s1) == set(sn)
        for k in s1:
            np.testing.assert_array_equal(sn[k], s1[k])


def test_shards_spread_over_the_devices_listed():
    """Simulation(devices=[...]) puts shard k on devices[k % len(devices)]
    and still runs the unsharded chain, tracked column included (two CPU
    entries here; copies between cards need several cards)."""
    cfg = SimConfig(group=2, beta=2.4, dims=DIMS, seed=1, start="hot",
                    reunit_every=1, track_kp_exhaust=True)
    one = Simulation(cfg, device="cpu")
    many = Simulation(cfg.replace(mesh=(2, 2, 1, 1)), device="cpu",
                      devices=["cpu", "cpu"])
    assert many._run.grid.devices == (CPU,) * 4
    obs1, obsn = one.run(1, 1), many.run(1, 1)
    for a, b in zip(one.us, many.us):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(obsn[:, -1], obs1[:, -1])
    np.testing.assert_allclose(obsn, obs1, rtol=0, atol=1e-7)


# (e) ----------------------------------------------------------------------


@pytest.mark.parametrize("n,mesh", [(3, m) for m in MESHES]
                         + [(2, (2, 2, 1, 1))])
def test_local_sums_add_up_to_the_unsharded_sums(n, mesh):
    us = _hot(n, DIMS, seed=4)
    grid = _grid(DIMS, mesh)
    shards = tsh.shard_links(us, grid)
    plq = sum(tmeas.plane_sums_local(sh, g)
              for g, sh in zip(grid.shards, shards))
    pol = sum(tmeas.polyakov_sums_local(sh, g)
              for g, sh in zip(grid.shards, shards))
    vol = n * int(np.prod(DIMS))
    np.testing.assert_allclose(plq.numpy(),
                               tmeas.plane_sums_ref(us, DIMS).numpy(),
                               rtol=1e-12, atol=1e-12 * vol)
    np.testing.assert_allclose(pol.numpy(),
                               tmeas.polyakov_sums_ref(us, DIMS).numpy(),
                               rtol=1e-12, atol=1e-12 * vol)


# (f) ----------------------------------------------------------------------


def test_sharded_measure_matches_reference():
    """measure() on a (2, 2) mesh against the reference's dense
    make_measure_fn on the joined field (tests/test_pallas.py:160-172
    tolerances)."""
    cfg = SimConfig(dims=DIMS, beta=BETA, seed=5, start="hot",
                    mesh=(2, 2, 1, 1))
    sim = Simulation(cfg, device="cpu")
    got = np.array(list(sim.measure().values()), np.float32)
    ref = np.asarray(make_measure_fn(RefConfig(dims=DIMS, beta=BETA))(
        jnp.asarray(sim.u.numpy())))
    np.testing.assert_allclose(got[:4], ref[:4], atol=5e-5)
    np.testing.assert_allclose(got[4:6], ref[4:6], atol=2e-4)


# the shard grid and its limits ---------------------------------------------


@pytest.mark.parametrize("n_dev,dims", [(1, None), (4, (32,) * 4),
                                        (8, (4, 4, 8, 8)), (6, None)])
def test_default_mesh_shape_is_the_reference_policy(n_dev, dims):
    assert (tmesh.default_mesh_shape(n_dev, dims)
            == jmesh.default_mesh_shape(n_dev, dims))


def test_shard_grid_layout_and_neighbours():
    grid = tmesh.ShardGrid((8, 4, 2, 4), (4, 2, 1, 1), ["cpu", "cpu"])
    assert len(grid) == 8
    assert grid.shards[5] == tcore.Shard((8, 4, 2, 4), (2, 2), (4, 2),
                                         (1, 1))
    assert grid.neighbour(0, 0, -1) == 6 and grid.neighbour(7, 1, 1) == 6
    with pytest.raises(ValueError):
        tmesh.ShardGrid((8, 4, 2, 4), (1, 1, 2, 1), ["cpu"])
    with pytest.raises(ValueError):
        tmesh.ShardGrid((8, 4, 2, 4), (1, 4, 1, 1), ["cpu"])


def test_kernels_refuse_arrays_beyond_int32_addressing():
    dims = (128, 128, 128, 256)
    big = torch.empty((2, 3, 2, 128, 128, 128 * 128), dtype=torch.float32,
                      device="meta")
    with pytest.raises(ValueError, match="int32"):
        tcore.check_packed(big, 3, dims)


def test_shard_stage_refuses_a_foreign_shard():
    us = _hot(3, STAGE_DIMS)
    grid = _grid(STAGE_DIMS, (2, 2, 1, 1))
    shards = tsh.shard_links(us, grid)
    with pytest.raises(ValueError):  # the shard of another lattice
        tupd.stage_update(shards[0], 0, 0, BETA, (1, 2), (8, 4, 2, 4),
                          shard=grid.shards[0])
    with pytest.raises(ValueError):  # unpadded arrays for a padded shard
        tupd.stage_update(us, 0, 0, BETA, (1, 2), STAGE_DIMS,
                          shard=grid.shards[0])
